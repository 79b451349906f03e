"""Perf ledger: the canonical, versioned BenchRecord every bench/profile
entry point emits, plus the diff/trend/check math scripts/ledger.py
serves.

The bench trajectory plateaued r04->r05 (20,832 -> 20,808 verifies/s)
and nobody noticed until a human read two JSON files side by side: the
BENCH_rNN.json tails were ad-hoc — a throughput number, a free-form
"context" stderr line, no environment stamp, no stage data — so the
only cross-PR comparison possible was eyeballing.  This module gives
every perf artifact ONE self-describing shape:

  {"ledger_version": 1,
   "metric": "...", "value": 20808.15, "unit": "verifies/s",
   "ts": 1770000000.0,
   "env": {"git_sha", "torch", "cuda", "python", "platform",
           "device_kind", "device_count", "hostname"},
   "context": {...},                    # emitter-specific knobs/rates
   "profile": {"crypto_device_stage_seconds":
                   {"verify_batch/dispatch": {"count", "total_s"}, ...},
               "occupancy": 0.875, ...},  # obs/prof.py summary shape
   ...emitter extras...}

and the comparison layer a single source of truth:

  load_record()  — reads a native record, a bare {"metric", "value"}
                   line, or the legacy BENCH_rNN.json wrapper
                   ({"n", "cmd", "rc", "tail", "parsed"}), recovering
                   the "context" line out of a legacy tail so the
                   r01-r05 history stays comparable;
  diff()         — per-dimension deltas (throughput, occupancy, stage
                   means) classified against per-dimension NOISE BANDS:
                   a delta inside the band is "noise", outside it is
                   "improved"/"regressed" by the dimension's direction
                   (throughput up = good, stage latency up = bad);
  trend()        — the whole r01->rNN trajectory as rows, with maximal
                   plateau runs (>= K consecutive records whose
                   successive deltas all sit inside the plateau band)
                   attached — the "is the curve still climbing" view;
  check()        — the CI gate: nonzero findings when the newest record
                   regressed throughput past the threshold or blew up a
                   stage mean, and a non-fatal flag when the trajectory
                   tail is a plateau (a plateau is a to-do, not a
                   breakage — BENCH_r05 vs r04 must pass).

The CLI, scripts/ledger.py's twin with its subcommands, flags and exit
codes (`main`):

    python -m consensus_overlord_tpu_torch.obs.ledger show  BENCH_r05.json
    python -m consensus_overlord_tpu_torch.obs.ledger diff  A.json B.json
    python -m consensus_overlord_tpu_torch.obs.ledger trend BENCH_r*.json
    python -m consensus_overlord_tpu_torch.obs.ledger check BENCH_r*.json

`check` exits 1 when the newest record regressed the headline metric
past --max-regression or a stage mean past --max-stage-blowup, else 0;
a trailing plateau fails only under --fail-on-plateau.  Thresholds are
percent on the command line (5 = 5%).

Everything here is stdlib-only and torch-free at import time (the CLI
runs `check` in CI lanes that never touch a device); env_fingerprint
reads device facts only from an ALREADY-imported torch whose CUDA is
already initialized, never initializes CUDA itself.

The port's own copy of consensus_overlord_tpu/obs/ledger.py: the same
record shape and the same diff/trend/check arithmetic, so a record of
either package loads and compares in the other.  Only the environment
stamp differs: it names torch, its CUDA version and the card ("torch",
"cuda", "device_kind", "device_count", "device_platform") where the JAX
package's names jax and its devices, and trend() surfaces a torch
version change as environment drift beside a jax one.
"""

from __future__ import annotations

import argparse
import json
import os
import platform
import socket
import subprocess
import sys
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple, Union

__all__ = [
    "LEDGER_VERSION",
    "BenchRecord",
    "Delta",
    "Finding",
    "annotate",
    "build_record",
    "check",
    "diff",
    "env_fingerprint",
    "load_record",
    "plateaus",
    "trend",
]

LEDGER_VERSION = 1

#: Default noise bands (fractions).  Throughput on the pipelined device
#: path repeats within ~2-3% run to run (BENCH_r04 vs r05 measured the
#: same config twice: -0.12%); 5% separates signal from jitter without
#: masking a real regression.  Stage means are far noisier (single-digit
#: sample counts per run), so their band is wide and they gate only on
#: blowups, not wobble.
THROUGHPUT_BAND = 0.05
OCCUPANCY_BAND = 0.05
STAGE_BAND = 0.25
#: check() defaults: fail a >5% throughput drop or a >50% stage-mean
#: growth; flag >= 2 consecutive runs whose deltas all sit within +/-1%.
MAX_REGRESSION = 0.05
MAX_STAGE_BLOWUP = 0.50
PLATEAU_RUNS = 2
PLATEAU_BAND = 0.01

#: Soak survival dimensions (the "soak" block soak-chaos records carry)
#: with their improvement direction — WAL-growth / RSS-slope / drop-rate
#: regressions gate like perf regressions, but against a wide band:
#: drift rates are few-sample and wall-clock noisy across CI hosts.
SOAK_DIMENSIONS: Dict[str, bool] = {  # name -> higher_is_better
    "rss_slope_bytes_per_s": False,
    "wal_growth_bytes_per_s": False,
    "flightrec_drop_per_s": False,
    "commit_rate_heights_per_s": True,
    "compile_cache_hit_ratio": True,
    # Causal-tracer latency dim (obs/causal.py): the soak's rolling p50
    # commit latency — the SLO the critical-path decomposition explains.
    "commit_latency_p50_ms": False,
    # Fleet-shape dims (sim/run.py writes them since the sharded
    # fabric): gating them means a lane can't quietly shrink its fleet
    # — a 1000-validator soak record that suddenly reports 250
    # validators is a regression of the LANE, not a perf datum.
    "validators": True,
    "shards": True,
}
SOAK_BAND = 0.50


# ---------------------------------------------------------------------------
# environment fingerprint
# ---------------------------------------------------------------------------

def _git_sha() -> Optional[str]:
    """Short HEAD sha of the repo this module lives in, or None (not a
    checkout / git absent) — never raises, never blocks."""
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    try:
        out = subprocess.run(
            ["git", "rev-parse", "--short", "HEAD"], cwd=root,
            capture_output=True, text=True, timeout=5)
        sha = out.stdout.strip()
        return sha if out.returncode == 0 and sha else None
    except Exception:  # noqa: BLE001 — fingerprints are best-effort
        return None


def env_fingerprint() -> dict:
    """Where/what produced a record: git sha, torch + CUDA + python
    versions, host platform, and the device set — the dimensions a diff
    must hold constant (or at least name) before a delta means anything.

    Device facts come from torch ONLY if the emitting process already
    imported it AND already initialized CUDA: initializing CUDA just to
    stamp metadata costs seconds (and a card), and the CLI's
    check/trend lanes must stay device-free."""
    fp: dict = {
        "git_sha": _git_sha(),
        "python": platform.python_version(),
        "platform": platform.platform(),
        "hostname": socket.gethostname(),
    }
    torch = sys.modules.get("torch")
    if torch is not None:
        try:
            fp["torch"] = getattr(torch, "__version__", None)
            fp["cuda"] = getattr(getattr(torch, "version", None), "cuda",
                                 None)
            if torch.cuda.is_initialized():
                fp["device_count"] = torch.cuda.device_count()
                fp["device_kind"] = torch.cuda.get_device_name(0)
                fp["device_platform"] = "gpu"
        except Exception:  # noqa: BLE001 — CUDA may be half-initialized
            pass
    return fp


# ---------------------------------------------------------------------------
# record construction
# ---------------------------------------------------------------------------

def build_record(metric: str, value: Optional[float], unit: str,
                 profiler=None, context: Optional[dict] = None,
                 **extras) -> dict:
    """One canonical BenchRecord dict, ready for json.dumps.  `profiler`
    (an obs.prof.DeviceProfiler) contributes the embedded stage-profile
    block; `extras` land at the top level (vs_baseline, sharded, ...)."""
    record: dict = {
        "ledger_version": LEDGER_VERSION,
        "metric": metric,
        "value": value,
        "unit": unit,
        "ts": time.time(),
        "env": env_fingerprint(),
    }
    if context:
        record["context"] = dict(context)
    if profiler is not None:
        try:
            record["profile"] = profiler.summary()
        except Exception:  # noqa: BLE001 — a record without a profile
            pass           # block still beats no record
    record.update(extras)
    return record


def annotate(record: dict, profiler=None) -> dict:
    """Stamp an existing emitter dict (bench_round / sim.run / ...) with
    the ledger envelope in place: version, ts, env, and — when a
    profiler is given and the emitter didn't embed one — the profile
    block.  Returns the same dict for print(json.dumps(annotate(...)))."""
    record.setdefault("ledger_version", LEDGER_VERSION)
    record.setdefault("ts", time.time())
    record.setdefault("env", env_fingerprint())
    if profiler is not None and "profile" not in record:
        try:
            record["profile"] = profiler.summary()
        except Exception:  # noqa: BLE001
            pass
    return record


# ---------------------------------------------------------------------------
# loading (native records + the legacy BENCH_rNN.json wrapper)
# ---------------------------------------------------------------------------

@dataclass
class BenchRecord:
    """A loaded ledger entry, normalized across record generations."""

    run: str                      #: label ("r05" from BENCH_r05.json)
    metric: str = "?"
    value: Optional[float] = None
    unit: str = ""
    ts: Optional[float] = None
    vs_baseline: Optional[float] = None
    env: dict = field(default_factory=dict)
    context: dict = field(default_factory=dict)
    #: "op/stage" -> {"count": int, "total_s": float} (prof.stage_totals)
    stages: Dict[str, dict] = field(default_factory=dict)
    occupancy: Optional[float] = None
    #: Soak survival dimensions (numeric entries of the record's "soak"
    #: block — SOAK_DIMENSIONS names the gated ones).
    soak: Dict[str, float] = field(default_factory=dict)
    raw: dict = field(default_factory=dict)

    def stage_means(self) -> Dict[str, float]:
        """Mean seconds per op/stage (count > 0 only)."""
        return {k: v["total_s"] / v["count"]
                for k, v in self.stages.items()
                if v.get("count") and v.get("total_s") is not None}

    def to_dict(self) -> dict:
        """Back to the canonical wire shape (round-trip with
        from_dict; `raw` is carried, not re-derived)."""
        doc: dict = {
            "ledger_version": LEDGER_VERSION,
            "metric": self.metric, "value": self.value, "unit": self.unit,
            "ts": self.ts, "env": self.env, "context": self.context,
        }
        if self.vs_baseline is not None:
            doc["vs_baseline"] = self.vs_baseline
        profile: dict = {}
        if self.stages:
            profile["crypto_device_stage_seconds"] = self.stages
        if self.occupancy is not None:
            profile["occupancy"] = self.occupancy
        if profile:
            doc["profile"] = profile
        if self.soak:
            doc["soak"] = dict(self.soak)
        return doc

    @classmethod
    def from_dict(cls, doc: dict, run: str = "?") -> "BenchRecord":
        profile = doc.get("profile") or {}
        value = doc.get("value")
        return cls(
            run=run,
            metric=str(doc.get("metric", "?")),
            value=float(value) if isinstance(value, (int, float)) else None,
            unit=str(doc.get("unit", "")),
            ts=doc.get("ts"),
            vs_baseline=doc.get("vs_baseline"),
            env=dict(doc.get("env") or {}),
            context=dict(doc.get("context") or {}),
            stages=dict(profile.get("crypto_device_stage_seconds") or {}),
            occupancy=profile.get("occupancy"),
            soak={k: float(v)
                  for k, v in (doc.get("soak") or {}).items()
                  if isinstance(v, (int, float))
                  and not isinstance(v, bool)},
            raw=doc,
        )


def _run_label(path: str) -> str:
    """BENCH_r05.json -> r05; anything else -> the filename stem."""
    stem = os.path.splitext(os.path.basename(path))[0]
    for prefix in ("BENCH_", "MULTICHIP_"):
        if stem.startswith(prefix):
            return stem[len(prefix):]
    return stem


def _tail_json_lines(tail: str) -> List[dict]:
    """Every parseable JSON object line in a legacy captured tail (the
    run recorded stdout+stderr interleaved; JAX warnings and human
    lines just fail the parse and drop out)."""
    docs = []
    for line in tail.splitlines():
        line = line.strip()
        if not line.startswith("{"):
            continue
        try:
            doc = json.loads(line)
        except ValueError:
            continue
        if isinstance(doc, dict):
            docs.append(doc)
    return docs


def load_record(source: Union[str, dict], run: Optional[str] = None
                ) -> BenchRecord:
    """Load one ledger entry from a path or an already-parsed dict.

    Accepts three generations of artifact:
      * a native BenchRecord ({"ledger_version": ...});
      * a bare emitter line ({"metric", "value", ...} — pre-ledger
        bench.py output, or any {"metric"} JSON tail);
      * the legacy BENCH_rNN.json wrapper ({"n", "cmd", "rc", "tail",
        "parsed"}): `parsed` is the record (itself possibly any of the
        above), and the tail's JSON lines are mined for the legacy
        {"context": {...}} stderr line so r01-r05 stay comparable.
    """
    if isinstance(source, str):
        label = run or _run_label(source)
        with open(source) as f:
            doc = json.load(f)
    else:
        label, doc = run or "?", source
    if not isinstance(doc, dict):
        raise ValueError(f"{label}: ledger entry is not a JSON object")

    if "parsed" in doc and "metric" not in doc:  # legacy wrapper
        record = BenchRecord.from_dict(doc.get("parsed") or {}, run=label)
        for line in _tail_json_lines(doc.get("tail", "")):
            if "context" in line and not record.context:
                record.context = dict(line["context"] or {})
        record.raw = doc
        return record
    return BenchRecord.from_dict(doc, run=label)


def load_records(paths: Sequence[str]) -> List[BenchRecord]:
    """Load a trajectory in the given order (BENCH_r*.json glob order is
    already the run order)."""
    return [load_record(p) for p in paths]


# ---------------------------------------------------------------------------
# diff: per-dimension noise-banded deltas
# ---------------------------------------------------------------------------

@dataclass
class Delta:
    """One dimension's a->b movement, classified against its band."""

    dimension: str
    a: float
    b: float
    pct: float            #: (b - a) / a, signed
    band: float           #: the noise band the delta was judged against
    higher_is_better: bool
    verdict: str          #: "noise" | "improved" | "regressed"

    def describe(self) -> str:
        arrow = {"improved": "+", "regressed": "!", "noise": "~"}
        return (f"[{arrow[self.verdict]}] {self.dimension}: "
                f"{self.a:.6g} -> {self.b:.6g}  ({self.pct * 100:+.2f}%, "
                f"band +/-{self.band * 100:.0f}%) {self.verdict}")


def _lower_is_better(metric: str, unit: str) -> bool:
    """Is the headline metric a latency/duration (down = improvement)?
    Throughput units ("verifies/s") are rates, not durations."""
    unit, metric = unit.lower(), metric.lower()
    if "/s" in unit or metric.endswith("_per_s"):  # a rate, not a time
        return False
    return (unit in ("ms", "s", "seconds", "wall_s") or "ms" in unit
            or metric.endswith(("_ms", "_s")) or "latency" in metric)


def _classify(dimension: str, a: float, b: float, band: float,
              higher_is_better: bool) -> Optional[Delta]:
    if not a:  # zero/None base: no meaningful relative delta
        return None
    pct = (b - a) / abs(a)
    if abs(pct) <= band:
        verdict = "noise"
    elif (pct > 0) == higher_is_better:
        verdict = "improved"
    else:
        verdict = "regressed"
    return Delta(dimension, a, b, pct, band, higher_is_better, verdict)


def comparable(a: BenchRecord, b: BenchRecord) -> bool:
    """Do two records measure the same thing?  Comparing a wall_s
    record against a verifies/s record yields a six-digit-percent
    'regression' that is pure nonsense — mixed-family inputs (a glob
    that caught both MULTICHIP and BENCH artifacts, a renamed metric)
    must be skipped, not judged."""
    return a.metric == b.metric and a.unit == b.unit


def diff(a: BenchRecord, b: BenchRecord,
         throughput_band: float = THROUGHPUT_BAND,
         stage_band: float = STAGE_BAND,
         occupancy_band: float = OCCUPANCY_BAND) -> List[Delta]:
    """Every dimension both records carry, classified: the headline
    value (direction from the unit: latency metrics are
    lower-is-better), batch occupancy, and each shared op/stage mean.
    Records measuring different metrics compare nothing headline-wise
    (see `comparable`)."""
    deltas: List[Delta] = []
    if a.value is not None and b.value is not None and comparable(a, b):
        lower_better = _lower_is_better(a.metric, a.unit)
        d = _classify(f"{a.metric} ({a.unit})".strip(), a.value, b.value,
                      throughput_band, higher_is_better=not lower_better)
        if d:
            deltas.append(d)
    if a.occupancy is not None and b.occupancy is not None:
        d = _classify("occupancy", a.occupancy, b.occupancy,
                      occupancy_band, higher_is_better=True)
        if d:
            deltas.append(d)
    means_a, means_b = a.stage_means(), b.stage_means()
    for key in sorted(means_a.keys() & means_b.keys()):
        d = _classify(f"stage {key} mean_s", means_a[key], means_b[key],
                      stage_band, higher_is_better=False)
        if d:
            deltas.append(d)
    for key, higher_better in SOAK_DIMENSIONS.items():
        if key in a.soak and key in b.soak:
            d = _classify(f"soak {key}", a.soak[key], b.soak[key],
                          SOAK_BAND, higher_is_better=higher_better)
            if d:
                deltas.append(d)
    return deltas


# ---------------------------------------------------------------------------
# trend: trajectory rows + plateau runs
# ---------------------------------------------------------------------------

def plateaus(records: Sequence[BenchRecord],
             plateau_runs: int = PLATEAU_RUNS,
             plateau_band: float = PLATEAU_BAND
             ) -> List[Tuple[int, int]]:
    """Maximal [i, j] index runs (j inclusive, j - i + 1 >= plateau_runs)
    where every successive headline delta inside the run sits within
    +/-plateau_band.  Records without a value break any run."""
    flat: List[bool] = []
    for prev, cur in zip(records, records[1:]):
        ok = (prev.value and cur.value is not None
              and comparable(prev, cur)  # a metric change breaks a run
              and abs((cur.value - prev.value) / abs(prev.value))
              <= plateau_band)
        flat.append(bool(ok))
    out: List[Tuple[int, int]] = []
    i = 0
    while i < len(flat):
        if flat[i]:
            j = i
            while j < len(flat) and flat[j]:
                j += 1
            if (j - i + 1) >= plateau_runs:  # records spanned = deltas + 1
                out.append((i, j))
            i = j
        else:
            i += 1
    return out


def trend(records: Sequence[BenchRecord],
          plateau_runs: int = PLATEAU_RUNS,
          plateau_band: float = PLATEAU_BAND) -> dict:
    """The trajectory table: one row per record (value, delta vs the
    previous run, occupancy, environment drift marks) plus the plateau
    runs.  Returns a JSON-encodable report; rendering is the CLI's job."""
    rows: List[dict] = []
    prev: Optional[BenchRecord] = None
    for rec in records:
        row: dict = {
            "run": rec.run, "metric": rec.metric, "value": rec.value,
            "unit": rec.unit, "vs_baseline": rec.vs_baseline,
            "occupancy": rec.occupancy,
            "stages": len(rec.stages),
        }
        if (prev is not None and prev.value and rec.value is not None
                and comparable(prev, rec)):
            # A metric change between neighbors (a glob that swept the
            # whole bench-ladder family) yields nonsense deltas — show
            # the rung, skip the comparison (same rule as plateaus).
            row["delta_pct"] = round(
                (rec.value - prev.value) / abs(prev.value) * 100, 2)
        # Environment drift is the first question a surprising delta
        # raises — surface it on the row instead of making the reader
        # open two files.
        if prev is not None:
            drift = {k: (prev.env.get(k), rec.env.get(k))
                     for k in ("device_kind", "jax", "torch", "git_sha")
                     if prev.env.get(k) != rec.env.get(k)
                     and (prev.env.get(k) or rec.env.get(k))}
            if drift and any(v[0] for v in drift.values()):
                row["env_drift"] = {k: f"{a} -> {b}"
                                    for k, (a, b) in drift.items()}
        rows.append(row)
        prev = rec
    plat = [{"from": records[i].run, "to": records[j].run,
             "runs": j - i + 1}
            for i, j in plateaus(records, plateau_runs, plateau_band)]
    for p in plat:
        for row in rows:
            if row["run"] == p["to"]:
                row["plateau"] = True
    return {"rows": rows, "plateaus": plat,
            "plateau_band_pct": plateau_band * 100,
            "plateau_runs": plateau_runs}


# ---------------------------------------------------------------------------
# check: the CI gate
# ---------------------------------------------------------------------------

@dataclass
class Finding:
    """One gate outcome.  `fatal` findings drive a nonzero exit; plateau
    flags are advisory (a flat curve is a roadmap item, not a broken
    build — BENCH_r05 vs r04 must keep passing)."""

    kind: str  #: "regression" | "stage_blowup" | "plateau" | "incomparable"
    detail: str
    fatal: bool


def check(records: Sequence[BenchRecord],
          max_regression: float = MAX_REGRESSION,
          max_stage_blowup: float = MAX_STAGE_BLOWUP,
          plateau_runs: int = PLATEAU_RUNS,
          plateau_band: float = PLATEAU_BAND,
          fail_on_plateau: bool = False) -> List[Finding]:
    """Gate the NEWEST record against its predecessor (and the trailing
    trajectory for plateaus).  Pass >= 2 records; extra leading records
    only feed plateau detection."""
    if len(records) < 2:
        raise ValueError("check needs at least two records "
                         "(previous + candidate)")
    prev, cur = records[-2], records[-1]
    findings: List[Finding] = []

    if not comparable(prev, cur):
        # Mixed-family inputs (a glob that swept BENCH and MULTICHIP
        # together, a renamed metric): judging them would fail CI on
        # records that were never comparable — flag loudly, gate
        # nothing.
        findings.append(Finding(
            "incomparable",
            f"{prev.run} measures {prev.metric!r} ({prev.unit}) but "
            f"{cur.run} measures {cur.metric!r} ({cur.unit}) — headline "
            "and stage gates skipped", fatal=False))
        for i, j in plateaus(records, plateau_runs, plateau_band):
            if j == len(records) - 1:
                findings.append(Finding(
                    "plateau",
                    f"{records[i].run} -> {records[j].run}: flat tail",
                    fatal=fail_on_plateau))
        return findings

    if prev.value and cur.value is not None:
        pct = (cur.value - prev.value) / abs(prev.value)
        lower_better = _lower_is_better(prev.metric, prev.unit)
        regressed = (pct > max_regression if lower_better
                     else pct < -max_regression)
        if regressed:
            findings.append(Finding(
                "regression",
                f"{cur.run}: {prev.metric} {prev.value:.6g} -> "
                f"{cur.value:.6g} ({pct * 100:+.2f}%, limit "
                f"{max_regression * 100:.0f}%)", fatal=True))

    means_prev, means_cur = prev.stage_means(), cur.stage_means()
    for key in sorted(means_prev.keys() & means_cur.keys()):
        if not means_prev[key]:
            continue
        pct = (means_cur[key] - means_prev[key]) / means_prev[key]
        if pct > max_stage_blowup:
            findings.append(Finding(
                "stage_blowup",
                f"{cur.run}: stage {key} mean "
                f"{means_prev[key] * 1e3:.3f} -> "
                f"{means_cur[key] * 1e3:.3f} ms ({pct * 100:+.1f}%, "
                f"limit +{max_stage_blowup * 100:.0f}%)", fatal=True))

    # Soak survival dims gate like perf dims: a WAL-growth or RSS-slope
    # rate that moved the wrong way past the (wide) SOAK_BAND is a
    # leak regression, not noise.  Zero/absent baselines gate nothing
    # (a healthy soak's WAL growth can legitimately be ~0).
    for key, higher_better in SOAK_DIMENSIONS.items():
        if key not in prev.soak or key not in cur.soak:
            continue
        d = _classify(f"soak {key}", prev.soak[key], cur.soak[key],
                      SOAK_BAND, higher_is_better=higher_better)
        if d is not None and d.verdict == "regressed":
            findings.append(Finding(
                "soak_drift",
                f"{cur.run}: {key} {d.a:.6g} -> {d.b:.6g} "
                f"({d.pct * 100:+.1f}%, band +/-{SOAK_BAND * 100:.0f}%)",
                fatal=True))

    for i, j in plateaus(records, plateau_runs, plateau_band):
        if j == len(records) - 1:  # only a TRAILING plateau is news
            findings.append(Finding(
                "plateau",
                f"{records[i].run} -> {records[j].run}: {j - i + 1} runs "
                f"within +/-{plateau_band * 100:.1f}% — the curve has "
                f"stopped climbing", fatal=fail_on_plateau))
    return findings


# ---------------------------------------------------------------------------
# the CLI (scripts/ledger.py's twin)
# ---------------------------------------------------------------------------

def _fmt(v, nd=2):
    return "-" if v is None else f"{v:,.{nd}f}"


def cmd_show(args) -> int:
    rec = load_record(args.file)
    print(json.dumps(rec.to_dict(), indent=2))
    return 0


def cmd_diff(args) -> int:
    a = load_record(args.a)
    b = load_record(args.b)
    deltas = diff(a, b, throughput_band=args.band / 100.0,
                  stage_band=args.stage_band / 100.0)
    if not deltas:
        print(f"{a.run} vs {b.run}: no comparable dimensions "
              "(records carry no shared numeric fields)")
        return 0
    print(f"{a.run} -> {b.run}")
    for d in deltas:
        print("  " + d.describe())
    worst = [d for d in deltas if d.verdict == "regressed"]
    print(f"{len(deltas)} dimension(s): "
          f"{sum(d.verdict == 'improved' for d in deltas)} improved, "
          f"{sum(d.verdict == 'noise' for d in deltas)} within noise, "
          f"{len(worst)} regressed")
    return 0


def cmd_trend(args) -> int:
    records = load_records(args.files)
    report = trend(records, plateau_runs=args.plateau_runs,
                   plateau_band=args.plateau_band / 100.0)
    unit = next((r.unit for r in records if r.unit), "")
    # A glob can sweep a whole family of distinct metrics: name each
    # row's metric and drop the single trailing unit line.
    mixed = len({(r.metric, r.unit) for r in records}) > 1
    print(f"{'run':<10} {'value':>14} {'delta%':>9} {'vs_base':>8} "
          f"{'occ':>6}  note")
    for row in report["rows"]:
        note = []
        if mixed:
            note.append(f"{row['metric']} [{row['unit'] or '-'}]")
        if row.get("plateau"):
            note.append("<- plateau")
        for k, v in (row.get("env_drift") or {}).items():
            note.append(f"env {k}: {v}")
        delta = row.get("delta_pct")
        print(f"{row['run']:<10} {_fmt(row['value']):>14} "
              f"{('%+.2f' % delta) if delta is not None else '-':>9} "
              f"{_fmt(row['vs_baseline']):>8} "
              f"{_fmt(row['occupancy']):>6}  {' | '.join(note)}")
    if unit and not mixed:
        print(f"(value unit: {unit})")
    for p in report["plateaus"]:
        print(f"PLATEAU: {p['from']} -> {p['to']} flat across {p['runs']} "
              f"runs (every delta within "
              f"+/-{report['plateau_band_pct']:.1f}%)")
    if not report["plateaus"]:
        print("no plateau in the trajectory "
              f"(band +/-{report['plateau_band_pct']:.1f}%, "
              f"min {report['plateau_runs']} runs)")
    return 0


def cmd_check(args) -> int:
    records = load_records(args.files)
    if len(records) == 1:
        # A lone record has no predecessor: the gate is the schema check
        # load_record already made, and the record passes as a baseline.
        cur = records[0]
        print(f"ok (baseline): {cur.run} is the first record "
              f"({cur.metric} = {_fmt(cur.value)} {cur.unit}) — "
              "nothing to compare against yet")
        return 0
    findings = check(records,
                     max_regression=args.max_regression / 100.0,
                     max_stage_blowup=args.max_stage_blowup / 100.0,
                     plateau_runs=args.plateau_runs,
                     plateau_band=args.plateau_band / 100.0,
                     fail_on_plateau=args.fail_on_plateau)
    fatal = [f for f in findings if f.fatal]
    for f in findings:
        tag = "FAIL" if f.fatal else "FLAG"
        print(f"{tag} [{f.kind}] {f.detail}")
    cur = records[-1]
    if not findings:
        print(f"ok: {cur.run} holds the line "
              f"({cur.metric} = {_fmt(cur.value)} {cur.unit})")
    elif not fatal:
        print(f"ok (flagged): {cur.run} passes the gate")
    return 1 if fatal else 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="ledger",
        description="perf-ledger diff/trend/check over BenchRecord JSON")
    sub = ap.add_subparsers(dest="command", required=True)

    p = sub.add_parser("show", help="normalize one artifact to the "
                       "canonical BenchRecord shape")
    p.add_argument("file")
    p.set_defaults(fn=cmd_show)

    p = sub.add_parser("diff", help="noise-banded per-dimension deltas "
                       "between two records")
    p.add_argument("a")
    p.add_argument("b")
    p.add_argument("--band", type=float, default=THROUGHPUT_BAND * 100,
                   help="headline-metric noise band, percent (default "
                   "%(default)s)")
    p.add_argument("--stage-band", type=float,
                   default=STAGE_BAND * 100,
                   help="stage-mean noise band, percent (default "
                   "%(default)s — stage means are few-sample and noisy)")
    p.set_defaults(fn=cmd_diff)

    for name, help_ in (("trend", "trajectory table + plateau runs"),
                        ("check", "CI gate: nonzero exit on regression "
                         "or stage blowup in the newest record")):
        p = sub.add_parser(name, help=help_)
        p.add_argument("files", nargs="+",
                       help="records in run order (BENCH_r*.json glob "
                       "order is already correct)")
        p.add_argument("--plateau-runs", type=int,
                       default=PLATEAU_RUNS,
                       help="min consecutive flat runs to flag "
                       "(default %(default)s)")
        p.add_argument("--plateau-band", type=float,
                       default=PLATEAU_BAND * 100,
                       help="flatness band, percent (default %(default)s)")
        if name == "check":
            p.add_argument("--max-regression", type=float,
                           default=MAX_REGRESSION * 100,
                           help="headline regression limit, percent "
                           "(default %(default)s)")
            p.add_argument("--max-stage-blowup", type=float,
                           default=MAX_STAGE_BLOWUP * 100,
                           help="stage-mean growth limit, percent "
                           "(default %(default)s)")
            p.add_argument("--fail-on-plateau", action="store_true",
                           help="treat a trailing plateau as fatal "
                           "(soak/owner lanes that demand progress)")
            p.set_defaults(fn=cmd_check)
        else:
            p.set_defaults(fn=cmd_trend)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
