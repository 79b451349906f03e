"""graftlint core: findings, suppressions, baselines, and the runner.

The port's copy of consensus_overlord_tpu/analysis/core.py, the same
but for the package it walks (``Project.PACKAGE``) and the rule modules
it registers.  Stdlib-only (ast + tokenize + hashlib + json), so the
lint runs where no torch is installed.  Rules live in the
rules_*.py siblings and register through `all_rules()`; each rule is a
callable `rule(project) -> Iterable[Finding]` plus a set of default
file globs.  The runner applies inline suppressions
(`# graftlint: disable=RULE -- reason`) and a JSON baseline before
deciding the exit code, so pre-existing accepted findings never block
CI while new ones always do.
"""

from __future__ import annotations

import ast
import fnmatch
import hashlib
import json
import os
import re
import tokenize
from dataclasses import dataclass, field
from io import StringIO
from typing import Callable, Dict, Iterable, List, Optional, Tuple

__all__ = [
    "Finding",
    "LintResult",
    "Project",
    "SourceFile",
    "all_rules",
    "load_baseline",
    "run_rules",
]

#: `# graftlint: disable=CUDA001[,CONC002] -- reason text`
#: The reason (after ` -- `) is MANDATORY: a suppression that doesn't
#: say why is itself a finding (GL001).
_SUPPRESS_RE = re.compile(
    r"#\s*graftlint:\s*disable=([A-Z]{2,6}\d{3}(?:\s*,\s*[A-Z]{2,6}\d{3})*)"
    r"(?:\s+--\s*(\S.*))?")


@dataclass
class Finding:
    rule: str
    path: str          #: repo-relative, forward slashes
    line: int          #: 1-based; 0 = whole-file finding
    message: str
    snippet: str = ""  #: stripped source line — the fingerprint anchor
    #: Stable id for baselining: rule + path + the offending source
    #: line's text (NOT the line number, which drifts under edits).
    #: When several findings share the basis (identical lines in one
    #: file), the runner re-stamps later occurrences with an ordinal so
    #: one baseline entry can never silently accept a NEW copy of the
    #: same violation.
    fingerprint: str = ""

    def __post_init__(self):
        if not self.fingerprint:
            self.fingerprint = self._fp()

    def _fp(self, occurrence: int = 0) -> str:
        basis = f"{self.rule}|{self.path}|{self.snippet or self.message}"
        if occurrence:
            basis += f"#{occurrence}"
        return hashlib.sha256(basis.encode()).hexdigest()[:16]

    def render(self) -> str:
        return f"{self.path}:{self.line}: {self.rule} {self.message}"

    def to_dict(self) -> dict:
        return {"rule": self.rule, "path": self.path, "line": self.line,
                "message": self.message, "fingerprint": self.fingerprint}


@dataclass
class Suppression:
    rules: Tuple[str, ...]
    line: int                    #: the line the comment is on
    applies_to: Tuple[int, ...]  #: code lines it suppresses
    reason: str
    used: bool = False


class SourceFile:
    """One parsed source file: text, lines, AST (lazily), and the
    inline graftlint suppressions found in its comments."""

    def __init__(self, path: str, relpath: str):
        self.path = path
        self.relpath = relpath.replace(os.sep, "/")
        with open(path, encoding="utf-8") as f:
            self.text = f.read()
        self.lines = self.text.splitlines()
        self._tree: Optional[ast.AST] = None
        self._parse_error: Optional[str] = None
        self._suppressions: Optional[List[Suppression]] = None

    @property
    def tree(self) -> Optional[ast.AST]:
        if self._tree is None and self._parse_error is None:
            try:
                self._tree = ast.parse(self.text)
            except SyntaxError as e:
                self._parse_error = f"{type(e).__name__}: {e}"
        return self._tree

    @property
    def parse_error(self) -> Optional[str]:
        self.tree  # noqa: B018 — force the parse attempt
        return self._parse_error

    def line_text(self, lineno: int) -> str:
        if 1 <= lineno <= len(self.lines):
            return self.lines[lineno - 1].strip()
        return ""

    def finding(self, rule: str, lineno: int, message: str) -> Finding:
        return Finding(rule, self.relpath, lineno, message,
                       snippet=self.line_text(lineno))

    # -- suppressions ------------------------------------------------------

    def suppressions(self) -> List[Suppression]:
        """Parse `# graftlint: disable=...` comments.  A trailing
        comment suppresses its own line; a standalone comment line
        suppresses the next non-blank, non-comment line."""
        if self._suppressions is not None:
            return self._suppressions
        out: List[Suppression] = []
        try:
            tokens = list(tokenize.generate_tokens(
                StringIO(self.text).readline))
        except (tokenize.TokenError, IndentationError, SyntaxError):
            tokens = []
        for tok in tokens:
            if tok.type != tokenize.COMMENT:
                continue
            m = _SUPPRESS_RE.search(tok.string)
            if not m:
                continue
            rules = tuple(r.strip() for r in m.group(1).split(","))
            reason = (m.group(2) or "").strip()
            row = tok.start[0]
            standalone = self.lines[row - 1].lstrip().startswith("#")
            applies = [row]
            if standalone:
                nxt = row + 1
                while (nxt <= len(self.lines)
                       and (not self.lines[nxt - 1].strip()
                            or self.lines[nxt - 1].lstrip()
                            .startswith("#"))):
                    nxt += 1
                applies.append(nxt)
                # a suppression above a decorator stack reaches the
                # decorated def itself (where most findings anchor)
                while (nxt <= len(self.lines)
                       and self.lines[nxt - 1].lstrip().startswith("@")):
                    nxt += 1
                    applies.append(nxt)
            out.append(Suppression(rules, row, tuple(applies), reason))
        self._suppressions = out
        return out


class Project:
    """The analysis context: a repo root, the package under it, and
    file access with caching.  `overrides` redirects the structural
    rules' fixed targets (tests point OBS001/SIM001 at fixtures):

      files         explicit list of files for the code rules (replaces
                    every rule's default globs)
      obs_metrics / obs_readme / service_main / sim_chaos
                    structural-rule target paths (repo-relative)
      statusz_files tuple of files whose add_status_source() calls form
                    the /statusz section union (OBS001 axis c; default
                    service/main.py + sim/run.py — service_main narrows
                    to one file when statusz_files is absent)
      search_roots  dirs scanned for metric references (OBS001 axis b)
      device_entries {path: function names}: CUDA001's roots in place of
                    rules_cuda.DEVICE_ENTRIES (fixture runs)
    """

    PACKAGE = "consensus_overlord_tpu_torch"

    def __init__(self, root: str, overrides: Optional[dict] = None):
        self.root = os.path.abspath(root)
        self.overrides = dict(overrides or {})
        self._cache: Dict[str, Optional[SourceFile]] = {}

    def file(self, relpath: str) -> Optional[SourceFile]:
        relpath = relpath.replace("/", os.sep)
        if relpath not in self._cache:
            path = os.path.join(self.root, relpath)
            self._cache[relpath] = (SourceFile(path, relpath)
                                    if os.path.isfile(path) else None)
        return self._cache[relpath]

    def read_text(self, relpath: str) -> Optional[str]:
        path = os.path.join(self.root, relpath.replace("/", os.sep))
        if not os.path.isfile(path):
            return None
        with open(path, encoding="utf-8") as f:
            return f.read()

    def glob_files(self, patterns: Iterable[str]) -> List[SourceFile]:
        """Package files matching any repo-relative glob, sorted."""
        out: List[SourceFile] = []
        seen = set()
        for dirpath, dirnames, filenames in os.walk(
                os.path.join(self.root, self.PACKAGE)):
            dirnames[:] = [d for d in dirnames
                           if d not in ("__pycache__", "_build")]
            for name in filenames:
                if not name.endswith(".py"):
                    continue
                rel = os.path.relpath(os.path.join(dirpath, name),
                                      self.root).replace(os.sep, "/")
                if rel in seen:
                    continue
                if any(fnmatch.fnmatch(rel, pat) for pat in patterns):
                    seen.add(rel)
                    sf = self.file(rel)
                    if sf is not None:
                        out.append(sf)
        return sorted(out, key=lambda s: s.relpath)

    def target_files(self, default_globs: Iterable[str]
                     ) -> List[SourceFile]:
        """The code-rule file set: explicit override files when given
        (fixture runs), the rule's default globs otherwise."""
        explicit = self.overrides.get("files")
        if explicit is not None:
            out = []
            for p in explicit:
                path = p if os.path.isabs(p) else os.path.join(self.root, p)
                rel = os.path.relpath(path, self.root)
                if not os.path.isfile(path):
                    continue
                if rel not in self._cache:
                    self._cache[rel] = SourceFile(path, rel)
                out.append(self._cache[rel])
            return out
        return self.glob_files(default_globs)


Rule = Callable[[Project], Iterable[Finding]]


def all_rules() -> Dict[str, Rule]:
    """The rule registry, assembled from the rule modules.  Import is
    deferred so `core` has no circular dependency on them."""
    from . import rules_conc, rules_cuda, rules_obs, rules_sim

    rules: Dict[str, Rule] = {}
    for mod in (rules_cuda, rules_conc, rules_obs, rules_sim):
        rules.update(mod.RULES)
    return rules


# ---------------------------------------------------------------------------
# baseline
# ---------------------------------------------------------------------------

def load_baseline(path: str) -> Tuple[Dict[str, dict], List[Finding]]:
    """Load a baseline file: {fingerprint: entry}.  Entries must carry a
    non-empty `reason` — ones that don't become GL002 findings (the
    baseline is for *justified* accepted findings, not a mute button)."""
    findings: List[Finding] = []
    try:
        with open(path, encoding="utf-8") as f:
            doc = json.load(f)
    except FileNotFoundError:
        return {}, [Finding("GL002", path, 0,
                            "baseline file not found")]
    except json.JSONDecodeError as e:
        return {}, [Finding("GL002", path, 0,
                            f"baseline is not valid JSON: {e}")]
    entries = doc.get("entries", [])
    by_fp: Dict[str, dict] = {}
    for i, entry in enumerate(entries):
        fp = entry.get("fingerprint", "")
        if not fp:
            findings.append(Finding(
                "GL002", path, 0,
                f"baseline entry #{i} has no fingerprint"))
            continue
        if not str(entry.get("reason", "")).strip():
            findings.append(Finding(
                "GL002", path, 0,
                f"baseline entry #{i} ({entry.get('rule', '?')} in "
                f"{entry.get('path', '?')}) has no reason — every "
                "accepted finding must say why it is accepted"))
            continue
        by_fp[fp] = entry
    return by_fp, findings


def write_baseline(path: str, findings: Iterable[Finding]) -> None:
    """Emit a baseline skeleton for the given findings.  Reasons are
    intentionally left empty: the run stays red (GL002) until a human
    justifies each entry."""
    doc = {
        "version": 1,
        "entries": [
            {"rule": f.rule, "path": f.path, "fingerprint": f.fingerprint,
             "snippet": f.snippet, "reason": ""}
            for f in findings
        ],
    }
    with open(path, "w", encoding="utf-8") as f:
        json.dump(doc, f, indent=2)
        f.write("\n")


# ---------------------------------------------------------------------------
# runner
# ---------------------------------------------------------------------------

@dataclass
class LintResult:
    findings: List[Finding] = field(default_factory=list)    #: actionable
    suppressed: List[Finding] = field(default_factory=list)  #: inline-ack'd
    baselined: List[Finding] = field(default_factory=list)   #: baseline-ack'd

    @property
    def exit_code(self) -> int:
        return 1 if self.findings else 0

    def counts(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for f in self.findings:
            out[f.rule] = out.get(f.rule, 0) + 1
        return out

    def to_dict(self) -> dict:
        return {
            "version": 1,
            "findings": [f.to_dict() for f in self.findings],
            "suppressed": [f.to_dict() for f in self.suppressed],
            "baselined": len(self.baselined),
            "counts": self.counts(),
            "exit_code": self.exit_code,
        }


def _suppression_findings(project: Project,
                          checked_files: Iterable[SourceFile]
                          ) -> List[Finding]:
    """GL001 for every malformed suppression in the scanned files."""
    out: List[Finding] = []
    for sf in checked_files:
        for sup in sf.suppressions():
            if not sup.reason:
                out.append(sf.finding(
                    "GL001", sup.line,
                    "suppression has no reason — use "
                    "`# graftlint: disable=RULE -- why this is ok`"))
    return out


def run_rules(project: Project,
              rules: Optional[Iterable[str]] = None,
              baseline_path: Optional[str] = None) -> LintResult:
    """Run the selected rules (default: all) over the project, apply
    inline suppressions and the baseline, and return the result."""
    registry = all_rules()
    selected = list(rules) if rules else sorted(registry)
    unknown = [r for r in selected if r not in registry]
    if unknown:
        raise ValueError(f"unknown rule(s): {', '.join(unknown)} "
                         f"(known: {', '.join(sorted(registry))})")

    raw: List[Finding] = []
    for code in selected:
        raw.extend(registry[code](project))

    # Every file any rule touched contributes its suppression syntax
    # check; files are cached on the project so this is cheap.
    checked = [sf for sf in project._cache.values() if sf is not None]
    raw.extend(_suppression_findings(project, checked))

    baseline: Dict[str, dict] = {}
    if baseline_path:
        baseline, baseline_findings = load_baseline(baseline_path)
        raw.extend(baseline_findings)

    # Identical-line duplicates get ordinal fingerprints (in line
    # order), so a baseline entry accepts exactly ONE occurrence and a
    # later copy-paste of the same violation still fails the run.
    by_basis: Dict[str, List[Finding]] = {}
    for f in sorted(raw, key=lambda f: (f.path, f.line, f.rule)):
        by_basis.setdefault(f._fp(), []).append(f)
    for group in by_basis.values():
        for i, f in enumerate(group):
            f.fingerprint = f._fp(i)

    result = LintResult()
    sup_by_file: Dict[str, List[Suppression]] = {}
    for sf in checked:
        sup_by_file[sf.relpath] = sf.suppressions()
    for f in sorted(raw, key=lambda f: (f.path, f.line, f.rule)):
        sup = next(
            (s for s in sup_by_file.get(f.path, [])
             if f.rule in s.rules and s.reason
             and (f.line == s.line or f.line in s.applies_to)),
            None)
        if sup is not None:
            sup.used = True
            result.suppressed.append(f)
        elif f.fingerprint in baseline:
            result.baselined.append(f)
        else:
            result.findings.append(f)
    # Stale suppressions (GL003): a disable comment whose rule(s) all
    # ran this pass but which absorbed nothing is dead weight — the
    # violation it excused was fixed, so the comment must go too (the
    # unused-noqa analog).  Suppressions naming unselected rules can't
    # be judged and are left alone.
    selected_set = set(selected)
    for sf in checked:
        for sup in sf.suppressions():
            if (not sup.used and sup.reason
                    and set(sup.rules) <= selected_set):
                result.findings.append(sf.finding(
                    "GL003", sup.line,
                    f"suppression for {'/'.join(sup.rules)} no longer "
                    "matches any finding — remove the stale "
                    "`# graftlint: disable` comment"))
    return result
