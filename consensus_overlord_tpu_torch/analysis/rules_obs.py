"""OBS001 — the metric & statusz documentation contract.

The port's copy of consensus_overlord_tpu/analysis/rules_obs.py, over
the port's obs/metrics.py, obs/README.md, service/main.py and
sim/run.py.

obs/README.md's family table is the operator's contract: dashboards and
alerts are written against it, so a family registered in obs/metrics.py
but absent from the table (or vice versa) is silent drift — exactly
what happened to `consensus_byzantine_rejections_total` before this
rule existed.  Three axes, all bidirectional where both sides exist:

  (a) families registered in obs/metrics.py  ⇔  rows of the
      obs/README.md "Metric families" table
  (b) families registered onto `self.<attr>` must be referenced
      somewhere outside obs/metrics.py (package or tests) — a family
      nobody observes or asserts is dead weight on every scrape
  (c) /statusz sections registered via add_status_source() in
      service/main.py OR sim/run.py (the union — the sim registers
      sim-only sections like "router" on the same exporter surface)
      ⇔  top-level keys of the documented /statusz schema block in
      obs/README.md
"""

from __future__ import annotations

import ast
import os
import re
from typing import Dict, Iterable, List, Optional, Tuple

from .core import Finding, Project

OBS_METRICS = "consensus_overlord_tpu_torch/obs/metrics.py"
OBS_README = "consensus_overlord_tpu_torch/obs/README.md"
SERVICE_MAIN = "consensus_overlord_tpu_torch/service/main.py"
SIM_RUN = "consensus_overlord_tpu_torch/sim/run.py"

_METRIC_CTORS = ("Histogram", "Counter", "Gauge", "Summary", "Info")

#: table rows: | `name` | histogram | ... (possibly `a` / `b` combined)
_TABLE_ROW_RE = re.compile(
    r"^\|\s*((?:`[a-z_0-9]+`\s*/?\s*)+)\|\s*(histogram|counter|gauge)",
    re.M)
_NAME_RE = re.compile(r"`([a-z_0-9]+)`")

#: /statusz schema block keys: two-space-indented `"key":` lines inside
#: the fenced json block after the "## /statusz" heading
_STATUSZ_KEY_RE = re.compile(r'^  "(\w+)":', re.M)

#: statusz keys that exist without an add_status_source registration
_STATUSZ_BUILTIN = {"ts"}


def _registered_families(project: Project, metrics_rel: str
                         ) -> List[Tuple[str, int, Optional[str]]]:
    """(family, lineno, attr-or-None) per metric constructor call whose
    result is assigned (self.attr → attr; local name → None)."""
    sf = project.file(metrics_rel)
    if sf is None or sf.tree is None:
        return []
    out: List[Tuple[str, int, Optional[str]]] = []
    for node in ast.walk(sf.tree):
        if not isinstance(node, ast.Assign):
            continue
        call = node.value
        if not (isinstance(call, ast.Call)
                and isinstance(call.func, ast.Name)
                and call.func.id in _METRIC_CTORS
                and call.args and isinstance(call.args[0], ast.Constant)
                and isinstance(call.args[0].value, str)):
            continue
        family = call.args[0].value
        attr: Optional[str] = None
        target = node.targets[0]
        if (isinstance(target, ast.Attribute)
                and isinstance(target.value, ast.Name)
                and target.value.id == "self"):
            attr = target.attr
        out.append((family, node.lineno, attr))
    return out


def _documented_families(readme_text: str) -> Dict[str, int]:
    """{family: 1-based line} from the README table rows."""
    out: Dict[str, int] = {}
    for m in _TABLE_ROW_RE.finditer(readme_text):
        line = readme_text.count("\n", 0, m.start()) + 1
        for name in _NAME_RE.findall(m.group(1)):
            out.setdefault(name, line)
    return out


def _statusz_documented(readme_text: str) -> Dict[str, int]:
    """Top-level keys of the documented /statusz schema block."""
    out: Dict[str, int] = {}
    at = readme_text.find("## /statusz")
    if at < 0:
        return out
    fence = readme_text.find("```json", at)
    if fence < 0:
        return out
    end = readme_text.find("```", fence + 7)
    block = readme_text[fence:end if end > 0 else len(readme_text)]
    for m in _STATUSZ_KEY_RE.finditer(block):
        line = readme_text.count("\n", 0, fence + m.start()) + 1
        out.setdefault(m.group(1), line)
    return out


def _statusz_registered(project: Project, rels: Iterable[str]
                        ) -> Dict[str, Tuple[str, int]]:
    """{section: (file, lineno)} over every add_status_source() call in
    the given files (first registration wins) — the union of the
    service and sim exporter surfaces."""
    out: Dict[str, Tuple[str, int]] = {}
    for rel in rels:
        sf = project.file(rel)
        if sf is None or sf.tree is None:
            continue
        for node in ast.walk(sf.tree):
            if (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr == "add_status_source"
                    and node.args
                    and isinstance(node.args[0], ast.Constant)
                    and isinstance(node.args[0].value, str)):
                out.setdefault(node.args[0].value, (rel, node.lineno))
    return out


def _reference_corpus(project: Project, roots: Iterable[str],
                      exclude_rel: str) -> str:
    chunks: List[str] = []
    for root in roots:
        absroot = os.path.join(project.root, root.replace("/", os.sep))
        if not os.path.isdir(absroot):
            continue
        for dirpath, dirnames, filenames in os.walk(absroot):
            dirnames[:] = [d for d in dirnames if d != "__pycache__"]
            for name in filenames:
                if not name.endswith((".py", ".md")):
                    continue
                rel = os.path.relpath(os.path.join(dirpath, name),
                                      project.root).replace(os.sep, "/")
                if rel == exclude_rel:
                    continue
                text = project.read_text(rel)
                if text:
                    chunks.append(text)
    return "\n".join(chunks)


def check_obs001(project: Project) -> Iterable[Finding]:
    ov = project.overrides
    metrics_rel = ov.get("obs_metrics", OBS_METRICS)
    readme_rel = ov.get("obs_readme", OBS_README)
    statusz_rels = ov.get("statusz_files")
    if statusz_rels is None:
        # Back-compat: a bare service_main override narrows the scan to
        # that one file (the pre-fleet shape the fixtures use).
        main_rel = ov.get("service_main")
        statusz_rels = ((main_rel,) if main_rel
                        else (SERVICE_MAIN, SIM_RUN))
    roots = ov.get("search_roots",
                   ("consensus_overlord_tpu_torch", "tests"))

    registered = _registered_families(project, metrics_rel)
    readme_text = project.read_text(readme_rel)
    metrics_sf = project.file(metrics_rel)
    if metrics_sf is None:
        yield Finding("OBS001", metrics_rel, 0,
                      "metrics module not found — cannot check the "
                      "metric contract")
        return
    if readme_text is None:
        yield metrics_sf.finding(
            "OBS001", 0, f"{readme_rel} not found — the metric table "
            "contract has no documentation side")
        return

    documented = _documented_families(readme_text)
    reg_names = {fam for fam, _ln, _attr in registered}

    # (a) bidirectional registry ⇔ table diff
    for fam, lineno, _attr in registered:
        if fam not in documented:
            yield metrics_sf.finding(
                "OBS001", lineno,
                f"metric family `{fam}` is registered here but missing "
                f"from the {readme_rel} family table — operators can't "
                "alert on what isn't documented")
    for fam, line in sorted(documented.items()):
        if fam not in reg_names:
            yield Finding(
                "OBS001", readme_rel, line,
                f"metric family `{fam}` is documented in the family "
                f"table but not registered in {metrics_rel} — stale "
                "documentation (suppress via baseline if intentional)",
                snippet=f"`{fam}`")

    # (b) dead families: registered onto self.<attr>, referenced nowhere
    corpus = _reference_corpus(project, roots, metrics_rel)
    for fam, lineno, attr in registered:
        if attr is None:
            continue  # scrape-time gauges bound to local names
        if f".{attr}" not in corpus and fam not in corpus:
            yield metrics_sf.finding(
                "OBS001", lineno,
                f"metric family `{fam}` (attr `.{attr}`) is registered "
                "but never referenced outside the registry (package or "
                "tests) — dead weight on every scrape")

    # (c) statusz sections ⇔ documented schema keys
    reg_sections = _statusz_registered(project, statusz_rels)
    doc_sections = _statusz_documented(readme_text)
    if reg_sections and doc_sections:
        for name, (rel, lineno) in sorted(reg_sections.items()):
            if name not in doc_sections:
                yield Finding(
                    "OBS001", rel, lineno,
                    f"/statusz section \"{name}\" is registered here "
                    f"but missing from the {readme_rel} schema block")
        for name, line in sorted(doc_sections.items()):
            if name not in reg_sections and name not in _STATUSZ_BUILTIN:
                yield Finding(
                    "OBS001", readme_rel, line,
                    f"/statusz schema documents \"{name}\" but no "
                    f"exporter surface ({', '.join(statusz_rels)}) "
                    "registers that section",
                    snippet=f'"{name}"')


RULES = {"OBS001": check_obs001}
