"""The port's graftlint (consensus_overlord_tpu_torch/analysis): a true
positive, a clean twin and a suppressed case per rule on small fixture
sources; the suppression syntax and the baseline; the shared machinery
and rules held against the JAX package's (consensus_overlord_tpu/
analysis) on the same sources; the port's tree linting clean; and the
CLI's exit codes.  Both analyzers are stdlib only: nothing here imports
torch or jax."""

import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from consensus_overlord_tpu.analysis import Project as JaxProject  # noqa: E402
from consensus_overlord_tpu.analysis import run_rules as jax_run_rules  # noqa: E402
from consensus_overlord_tpu.analysis.core import (  # noqa: E402
    write_baseline as jax_write_baseline)
from consensus_overlord_tpu.analysis.rules_sim import (  # noqa: E402
    LEGACY_DRAWS as JAX_LEGACY_DRAWS)
from consensus_overlord_tpu_torch.analysis import Project, run_rules  # noqa: E402
from consensus_overlord_tpu_torch.analysis.core import (  # noqa: E402
    load_baseline, write_baseline)
from consensus_overlord_tpu_torch.analysis.rules_sim import (  # noqa: E402
    LEGACY_DRAWS, SENTINEL)

CLI = [sys.executable, "-m", "consensus_overlord_tpu_torch.analysis"]
#: CUDA001's roots in the fixtures.
FIXTURE_ENTRIES = {"fixture.py": frozenset({"launch"})}


def lint(tmp_path, source, rules, filename="fixture.py", project=Project,
         runner=run_rules, **overrides):
    path = tmp_path / filename
    path.write_text(source)
    proj = project(str(tmp_path), overrides={
        "files": [str(path)], "device_entries": FIXTURE_ENTRIES,
        **overrides})
    return runner(proj, rules=rules)


def codes(result):
    return [f.rule for f in result.findings]


# -- fixtures, per rule: (source, actionable findings, suppressed) -------------

CUDA001_BAD = """\
import numpy as np
import torch

def launch(x: torch.Tensor) -> torch.Tensor:
    y = helper(x)
    if bool(y.any()):
        print("hit")
    return y

def helper(x):
    return torch.as_tensor(np.asarray(x.cpu())) + 1
"""

CUDA001_CLEAN = """\
import torch

def launch(x: torch.Tensor) -> torch.Tensor:
    n = int(x.shape[0])
    k = int("12")
    return x[:n] * k

def _readback(out):
    return out.cpu().numpy()

def host_decode(out):
    # not reachable from the device body: a host sync is fine here
    return bool(_readback(out).all())
"""

CUDA001_SUPPRESSED = """\
import torch

def launch(x: torch.Tensor) -> torch.Tensor:
    print(x.shape)  # graftlint: disable=CUDA001 -- a debug line
    return x
"""

CUDA002_BAD = """\
import torch

def widen(x):
    y = x.to(torch.int64)
    z = torch.matmul(y, y)
    return z * 3000000000
"""

CUDA002_CLEAN = """\
import torch

_I32_MAX = 2**31 - 1  # pure-literal math is exact on the host

def _reduce(x, fold):
    return torch.matmul(x, fold)

def _to_words(x):
    return (x.to(torch.int64) << 40) + (1 << 40)

def narrow(x):
    return _reduce(x.to(torch.int32), x) * 3
"""

CUDA002_SUPPRESSED = """\
import torch

def widen(x):
    # graftlint: disable=CUDA002 -- a host staging copy
    return x.long()
"""

CONC001_BAD = """\
import threading

class Counter:
    def __init__(self):
        self._lock = threading.Lock()
        self.total = 0

    def bump(self):
        with self._lock:
            self.total += 1

    def reset(self):
        self.total = 0  # race: written elsewhere under the lock
"""

CONC001_CLEAN = """\
import threading

class Counter:
    def __init__(self):
        self._lock = threading.Lock()
        self.total = 0

    def bump(self):
        with self._lock:
            self.total += 1

    def reset(self):
        with self._lock:
            self._reset_locked()

    def _reset_locked(self):
        # "caller holds the lock" helper: every call site is locked
        self.total = 0
"""

CONC001_SUPPRESSED = CONC001_BAD.replace(
    "# race: written elsewhere under the lock",
    "# graftlint: disable=CONC001 -- single-threaded teardown")

CONC002_BAD = """\
import logging

logger = logging.getLogger(__name__)

def _readback(out):
    return out.cpu().numpy()

class Provider:
    def verify(self, x):
        try:
            out = self._kernels.verify_round(x)
            return self._watched(_readback, out)
        except Exception as e:
            logger.warning("device failed: %s; host fallback", e)
            return self._host_verify(x)

    def peek(self, out):
        return out.cpu()
"""

CONC002_CLEAN = """\
def _readback(out):
    return out.cpu().numpy()

class Provider:
    def verify(self, x):
        try:
            out = self._kernels.verify_round(x)
            flat = self._watched(_readback, out)
        except Exception as e:
            self._device_failed("verify", e)
            return self._host_verify(x)
        return flat

    def probe(self, x):
        try:
            self._watched(_readback, self._kernels.g2_validate(x))
        except DeviceLossError as e:
            self.breaker.record_failure(str(e))
            return None
"""

CONC002_SUPPRESSED = """\
class Provider:
    def probe(self, x):
        try:
            self._watched(_readback, self._kernels.g2_validate(x))
        # graftlint: disable=CONC002 -- best-effort probe, result unused
        except Exception:
            pass
"""

RULE_CASES = [
    ("CUDA001", CUDA001_BAD, 4, 0),
    ("CUDA001", CUDA001_CLEAN, 0, 0),
    ("CUDA001", CUDA001_SUPPRESSED, 0, 1),
    ("CUDA002", CUDA002_BAD, 3, 0),
    ("CUDA002", CUDA002_CLEAN, 0, 0),
    ("CUDA002", CUDA002_SUPPRESSED, 0, 1),
    ("CONC001", CONC001_BAD, 1, 0),
    ("CONC001", CONC001_CLEAN, 0, 0),
    ("CONC001", CONC001_SUPPRESSED, 0, 1),
    ("CONC002", CONC002_BAD, 2, 0),
    ("CONC002", CONC002_CLEAN, 0, 0),
    ("CONC002", CONC002_SUPPRESSED, 0, 1),
]


@pytest.mark.parametrize(
    "rule,source,found,suppressed", RULE_CASES,
    ids=[f"{r}-{k}" for r, _, _, _ in RULE_CASES[::3]
         for k in ("positive", "clean", "suppressed")])
def test_rule_fixture(tmp_path, rule, source, found, suppressed):
    result = lint(tmp_path, source, [rule])
    assert codes(result) == [rule] * found, [
        f.render() for f in result.findings]
    assert len(result.suppressed) == suppressed


def _handler_src(handler: str) -> str:
    return ("class Provider:\n"
            "    def verify(self, x):\n"
            "        try:\n"
            "            out = self._watched(_readback,\n"
            "                                self._kernels.verify_round(x))\n"
            f"{handler}"
            "        return out\n")


CONC002_HANDLERS = {
    # a broad handler that logs and re-verifies on the host: a real
    # device error would never reach the caller
    "broad_host_fallback": (
        "        except Exception as e:\n"
        "            logger.error('device failed: %s', e)\n"
        "            out = self._host_verify(x)\n", 1),
    "bare_swallow": ("        except:\n            out = None\n", 1),
    # only the faults raised in Python, fed to the breaker
    "injected_feeds_breaker": (
        "        except (InjectedDeviceFault, DeviceLossError) as e:\n"
        "            self.breaker.record_failure(str(e))\n"
        "            out = self._host_verify(x)\n", 0),
    "injected_silent": (
        "        except DispatchTimeout:\n            out = None\n", 1),
    "broad_reraise": (
        "        except Exception as e:\n"
        "            if not _injected(e):\n                raise\n"
        "            out = self._host_verify(x)\n", 0),
    "broad_through_gate": (
        "        except BaseException as e:\n"
        "            self._pairing_failed(e)\n"
        "            out = self._host_verify(x)\n", 0),
}


@pytest.mark.parametrize("case", sorted(CONC002_HANDLERS))
def test_conc002_handler_contract(tmp_path, case):
    handler, found = CONC002_HANDLERS[case]
    result = lint(tmp_path, _handler_src(handler), ["CONC002"])
    assert codes(result) == ["CONC002"] * found


@pytest.mark.parametrize("body,found", [
    ("return self._watched(lambda: out.cpu())", 0),
    ("return _readback(out)", 1),
    ("return out.item()", 1),
])
def test_conc002_readback_outside_the_watchdog(tmp_path, body, found):
    src = f"class Provider:\n    def read(self, out):\n        {body}\n"
    result = lint(tmp_path, src, ["CONC002"])
    assert codes(result) == ["CONC002"] * found
    if found:
        assert "outside the dispatch watchdog" in result.findings[0].message


def test_cuda001_reaches_only_the_named_entries(tmp_path):
    """A host sync in a function no device body calls is not a finding;
    calling it from the device body makes it one."""
    src = ("import torch\n\n"
           "def launch(x: torch.Tensor) -> torch.Tensor:\n"
           "    return x + 1\n\n"
           "def decode(t: torch.Tensor):\n"
           "    return t.tolist()\n")
    assert codes(lint(tmp_path, src, ["CUDA001"])) == []
    called = src.replace("return x + 1", "decode(x)\n    return x + 1")
    result = lint(tmp_path, called, ["CUDA001"], filename="called.py",
                  device_entries={"called.py": frozenset({"launch"})})
    assert codes(result) == ["CUDA001"]
    assert ".tolist()" in result.findings[0].message


@pytest.mark.parametrize("entries, expected", [
    ({"m.py": frozenset({"launch"})}, []),
    ({"m.py": frozenset({"launch", "renamed"})},
     [("m.py", "device root `renamed`")]),
    ({"gone.py": frozenset({"launch"})},
     [("gone.py", "DEVICE_ENTRIES is missing")]),
])
def test_cuda001_reports_a_root_it_cannot_find(tmp_path, entries, expected):
    """On the tree (no explicit files), a root name the module does not
    define, or a file that is gone, is a finding: a rename cannot switch
    the rule off in silence."""
    (tmp_path / "m.py").write_text("def launch(x):\n    return x + 1\n")
    proj = Project(str(tmp_path), overrides={"device_entries": entries})
    found = run_rules(proj, rules=["CUDA001"]).findings
    assert [(f.path, f.line) for f in found] == [(p, 0) for p, _ in expected]
    for f, (_, text) in zip(found, expected):
        assert text in f.message


# -- OBS001 -------------------------------------------------------------------

OBS_METRICS_SRC = """\
class Metrics:
    def __init__(self):
        self.verifies = Counter(
            "crypto_verifies_total", "verifies", registry=None)
        self.wait = Histogram(
            "queue_wait_ms", "wait", registry=None)
"""

OBS_README_SRC = """\
# obs

## Metric families

| family | type | labels | meaning |
|---|---|---|---|
| `crypto_verifies_total` | counter | — | verifies |
| `queue_wait_ms` | histogram | — | wait |

## /statusz

```json
{
  "ts": 0.0,
  "consensus": {},
  "frontier": {}
}
```
"""

OBS_MAIN_SRC = """\
class Service:
    def wire(self, metrics, engine, frontier):
        metrics.add_status_source("consensus", engine.status)
        metrics.add_status_source("frontier", frontier.status)
"""

OBS_USER_SRC = """\
def observe(metrics):
    metrics.verifies.inc()
    metrics.wait.observe(1.0)
"""


def obs_project(tmp_path, metrics=OBS_METRICS_SRC, readme=OBS_README_SRC,
                main=OBS_MAIN_SRC, user=OBS_USER_SRC, project=Project):
    (tmp_path / "metrics.py").write_text(metrics)
    (tmp_path / "README.md").write_text(readme)
    (tmp_path / "main.py").write_text(main)
    (tmp_path / "pkg").mkdir(exist_ok=True)
    (tmp_path / "pkg" / "user.py").write_text(user)
    return project(str(tmp_path), overrides={
        "obs_metrics": "metrics.py", "obs_readme": "README.md",
        "service_main": "main.py", "search_roots": ("pkg",)})


_UNDOC = OBS_README_SRC.replace("| `queue_wait_ms` | histogram | — | wait |\n",
                                "")
OBS_CASES = {
    "in_sync": ({}, [], 0),
    "registered_but_undocumented": ({"readme": _UNDOC}, ["metrics.py"], 0),
    "documented_but_unregistered": (
        {"metrics": OBS_METRICS_SRC.replace("queue_wait_ms",
                                            "queue_delay_ms")},
        ["README.md", "metrics.py"], 0),
    "dead_family": ({"user": "def observe(m):\n    m.verifies.inc()\n"},
                    ["metrics.py"], 0),
    "statusz_desync": ({"main": OBS_MAIN_SRC + (
        '        metrics.add_status_source("trend", lambda: {})\n')},
        ["main.py"], 0),
    "suppressed": ({"readme": _UNDOC, "metrics": OBS_METRICS_SRC.replace(
        "        self.wait = Histogram(",
        "        # graftlint: disable=OBS001 -- internal-only family\n"
        "        self.wait = Histogram(")}, [], 1),
}


@pytest.mark.parametrize("case", sorted(OBS_CASES))
def test_obs001(tmp_path, case):
    kw, files, suppressed = OBS_CASES[case]
    result = run_rules(obs_project(tmp_path, **kw), rules=["OBS001"])
    assert sorted(f.path.split("/")[-1] for f in result.findings) == files
    assert set(codes(result)) <= {"OBS001"}
    assert len(result.suppressed) == suppressed


# -- SIM001 -------------------------------------------------------------------

def sim_chaos_src(extra_legacy_draw=False, sentinel=True, suppress=False):
    lines = [
        "import random",
        "",
        "class ChaosSchedule:",
        "    @classmethod",
        "    def generate(cls, seed, heights, n_validators, adaptive=0):",
        "        rng = random.Random(seed)",
        "        slots = rng.sample(range(heights), 3)",
        "        kinds = rng.choice(['crash'])",
        "        rng.shuffle(slots)",
        "        targets = rng.sample(range(n_validators), 2)",
        "        node = rng.randrange(n_validators)",
    ]
    if extra_legacy_draw:
        line = "        jitter = rng.random()"
        if suppress:
            line += "  # graftlint: disable=SIM001 -- fixture: accepted draw"
        lines.append(line)
    if sentinel:
        lines.append(f"        # {SENTINEL}")
    lines.append("        extras = [rng.choice(slots) for _ in range(adaptive)]")
    lines.append("        return (slots, kinds, targets, node, extras)")
    return "\n".join(lines) + "\n"


SIM_CASES = {
    "clean": ({}, [], 0),
    "inserted_draw_above_sentinel": ({"extra_legacy_draw": True},
                                     ["SIM001"], 0),
    "missing_sentinel": ({"sentinel": False}, ["SIM001"], 0),
    "suppressed": ({"extra_legacy_draw": True, "suppress": True}, [], 1),
}


def sim_run(tmp_path, src, project=Project, runner=run_rules):
    (tmp_path / "chaos.py").write_text(src)
    return runner(project(str(tmp_path), overrides={"sim_chaos": "chaos.py"}),
                  rules=["SIM001"])


@pytest.mark.parametrize("case", sorted(SIM_CASES))
def test_sim001(tmp_path, case):
    kw, found, suppressed = SIM_CASES[case]
    result = sim_run(tmp_path, sim_chaos_src(**kw))
    assert codes(result) == found
    assert len(result.suppressed) == suppressed


def test_legacy_draws_are_the_jax_tuple():
    assert LEGACY_DRAWS == JAX_LEGACY_DRAWS


def test_pinned_sequence_matches_the_ports_generator():
    """The port's ChaosSchedule.generate draws the pinned legacy
    sequence above its sentinel."""
    result = run_rules(Project(REPO), rules=["SIM001"])
    assert codes(result) == []


# -- suppression syntax and the baseline ---------------------------------------

SUPPRESSION_CASES = {
    # a reasonless suppression is GL001 and suppresses nothing
    "reasonless_is_gl001": (
        "    print(x)  # graftlint: disable=CUDA001\n", ["CUDA001"],
        ["CUDA001", "GL001"]),
    "wrong_rule_does_not_suppress": (
        "    print(x)  # graftlint: disable=CUDA002 -- wrong code\n",
        ["CUDA001"], ["CUDA001"]),
    "stale_is_gl003": (
        "    y = x  # graftlint: disable=CUDA001 -- stale\n", ["CUDA001"],
        ["GL003"]),
    "unselected_rule_not_stale": (
        "    y = x  # graftlint: disable=CONC002 -- other\n", ["CUDA001"], []),
}


@pytest.mark.parametrize("case", sorted(SUPPRESSION_CASES))
def test_suppression_syntax(tmp_path, case):
    line, rules, want = SUPPRESSION_CASES[case]
    src = ("import torch\n\ndef launch(x: torch.Tensor) -> torch.Tensor:\n"
           + line + "    return x\n")
    assert sorted(codes(lint(tmp_path, src, rules))) == want


def _accept_all(path):
    doc = json.loads(path.read_text())
    for entry in doc["entries"]:
        entry["reason"] = "accepted: fixture"
    path.write_text(json.dumps(doc))


def test_baseline_round_trip(tmp_path):
    result = lint(tmp_path, CUDA002_SUPPRESSED.replace(
        "    # graftlint: disable=CUDA002 -- a host staging copy\n", ""),
        ["CUDA002"])
    assert codes(result) == ["CUDA002"]
    baseline = tmp_path / "baseline.json"
    write_baseline(str(baseline), result.findings)
    proj = Project(str(tmp_path), overrides={
        "files": [str(tmp_path / "fixture.py")]})
    # the skeleton's reasons are empty: still red, now as GL002
    assert "GL002" in codes(run_rules(proj, rules=["CUDA002"],
                                      baseline_path=str(baseline)))
    _accept_all(baseline)
    proj = Project(str(tmp_path), overrides={
        "files": [str(tmp_path / "fixture.py")]})
    again = run_rules(proj, rules=["CUDA002"], baseline_path=str(baseline))
    assert codes(again) == [] and len(again.baselined) == 1
    assert again.exit_code == 0


def test_fingerprint_survives_line_drift(tmp_path):
    result = lint(tmp_path, CONC001_BAD, ["CONC001"])
    baseline = tmp_path / "baseline.json"
    write_baseline(str(baseline), result.findings)
    _accept_all(baseline)
    (tmp_path / "fixture.py").write_text("# pad\n# pad\n# pad\n" + CONC001_BAD)
    proj = Project(str(tmp_path), overrides={
        "files": [str(tmp_path / "fixture.py")]})
    drifted = run_rules(proj, rules=["CONC001"], baseline_path=str(baseline))
    assert codes(drifted) == [] and len(drifted.baselined) == 1


def test_duplicate_line_gets_distinct_fingerprint(tmp_path):
    """A baseline entry accepts exactly one occurrence: a new copy of
    the same violating line still fails."""
    two = ("import torch\n\ndef launch(x: torch.Tensor) -> torch.Tensor:\n"
           "    print(x)\n    print(x)\n    return x\n")
    result = lint(tmp_path, two, ["CUDA001"])
    assert len(result.findings) == 2
    assert result.findings[0].fingerprint != result.findings[1].fingerprint
    baseline = tmp_path / "baseline.json"
    write_baseline(str(baseline), result.findings)
    _accept_all(baseline)
    three = two.replace("    return x\n", "    print(x)\n    return x\n")
    (tmp_path / "fixture.py").write_text(three)
    proj = Project(str(tmp_path), overrides={
        "files": [str(tmp_path / "fixture.py")],
        "device_entries": FIXTURE_ENTRIES})
    third = run_rules(proj, rules=["CUDA001"], baseline_path=str(baseline))
    assert codes(third) == ["CUDA001"] and len(third.baselined) == 2


def test_missing_baseline_file(tmp_path):
    fps, findings = load_baseline(str(tmp_path / "nope.json"))
    assert fps == {} and [f.rule for f in findings] == ["GL002"]


# -- held against the JAX package's analyzer ------------------------------------

def _rendered(result):
    return {kind: [(f.render(), f.fingerprint) for f in getattr(result, kind)]
            for kind in ("findings", "suppressed", "baselined")}


PARITY_CASES = {
    "conc001_bad": (CONC001_BAD, ["CONC001"]),
    "conc001_clean": (CONC001_CLEAN, ["CONC001"]),
    "conc001_suppressed": (CONC001_SUPPRESSED, ["CONC001"]),
    "gl001": (CONC001_BAD.replace(
        "# race: written elsewhere under the lock",
        "# graftlint: disable=CONC001"), ["CONC001"]),
    "gl003": (CONC001_CLEAN.replace(
        "            self.total += 1",
        "            self.total += 1  # graftlint: disable=CONC001 -- x"),
        ["CONC001"]),
    "duplicates": (CONC001_BAD.replace(
        "        self.total = 0  # race: written elsewhere under the lock\n",
        "        self.total = 0\n        self.total = 0\n"), ["CONC001"]),
}


@pytest.mark.parametrize("case", sorted(PARITY_CASES))
def test_shared_rules_match_the_jax_analyzer(tmp_path, case):
    """The same source through both packages' cores and CONC001 gives
    the same rendered findings and fingerprints (GL001–GL003 too)."""
    src, rules = PARITY_CASES[case]
    port = lint(tmp_path, src, rules)
    jax = lint(tmp_path, src, rules, project=JaxProject,
               runner=jax_run_rules)
    assert _rendered(port) == _rendered(jax)


@pytest.mark.parametrize("case", sorted(SIM_CASES))
def test_sim001_matches_the_jax_analyzer(tmp_path, case):
    src = sim_chaos_src(**SIM_CASES[case][0])
    port = sim_run(tmp_path, src)
    jax = sim_run(tmp_path, src, project=JaxProject, runner=jax_run_rules)
    assert _rendered(port) == _rendered(jax)


def test_baselines_match_the_jax_analyzer(tmp_path):
    """write_baseline of the same findings writes the same document, and
    each core accepts the other's (GL002 included)."""
    port = lint(tmp_path, CONC001_BAD, ["CONC001"])
    jax = lint(tmp_path, CONC001_BAD, ["CONC001"], project=JaxProject,
               runner=jax_run_rules)
    a, b = tmp_path / "port.json", tmp_path / "jax.json"
    write_baseline(str(a), port.findings)
    jax_write_baseline(str(b), jax.findings)
    assert a.read_text() == b.read_text()
    for proj, runner in ((Project, run_rules), (JaxProject, jax_run_rules)):
        p = proj(str(tmp_path), overrides={
            "files": [str(tmp_path / "fixture.py")]})
        red = runner(p, rules=["CONC001"], baseline_path=str(b))
        assert sorted(codes(red)) == ["CONC001", "GL002"]


# -- the tree and the CLI --------------------------------------------------------

def test_port_tree_lints_clean():
    """The port carries zero actionable findings, and every suppression
    in it has a reason."""
    result = run_rules(Project(REPO))
    assert [f.render() for f in result.findings] == []
    assert all(f.rule.startswith(("CUDA", "CONC", "OBS", "SIM"))
               for f in result.suppressed)


def _cli(*args, cwd=REPO):
    env = dict(os.environ, PYTHONPATH=REPO)
    return subprocess.run(CLI + list(args), capture_output=True, text=True,
                          cwd=cwd, env=env, timeout=60)


def test_cli_exit_codes(tmp_path):
    """0 on the port's tree, 1 with a planted finding, 2 for a usage
    error."""
    clean = _cli("--json")
    assert clean.returncode == 0, clean.stdout + clean.stderr
    doc = json.loads(clean.stdout)
    assert doc["findings"] == [] and doc["exit_code"] == 0
    bad = tmp_path / "bad.py"
    bad.write_text(CUDA002_BAD)
    planted = _cli("--rules", "CUDA002", "--json", str(bad))
    assert planted.returncode == 1
    assert [f["rule"] for f in json.loads(planted.stdout)["findings"]] == [
        "CUDA002"] * 3
    assert _cli("--rules", "TPU001").returncode == 2
    assert _cli("--no-such-flag").returncode == 2


def test_cli_lists_the_catalog():
    out = _cli("--list-rules")
    assert out.returncode == 0
    assert out.stdout.split() == ["CONC001", "CONC002", "CUDA001", "CUDA002",
                                  "OBS001", "SIM001"]


def test_analysis_imports_neither_torch_nor_jax():
    code = ("import sys\n"
            "import consensus_overlord_tpu_torch.analysis as a\n"
            "import consensus_overlord_tpu_torch.analysis.__main__\n"
            "a.all_rules()\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('torch', 'jax', 'jaxlib', 'numpy', 'consensus_overlord_tpu'))\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=60)
    assert out.returncode == 0, out.stdout + out.stderr
