"""The port's obs/ledger.py against the JAX package's: on the same
records, built here, record construction (the environment stamp aside),
loading (native records, the bare {"metric", "value"} line and the
legacy {"n", "cmd", "rc", "tail", "parsed"} wrapper), diff, trend with
its plateaus, check and the soak dimensions agree, and a record of
either package loads in the other.  Tolerance: none."""

import dataclasses
import json
import subprocess
import sys

import pytest
import torch  # noqa: F401 — the environment stamp reads an imported torch

from consensus_overlord_tpu.obs import ledger as jax_ledger
from consensus_overlord_tpu_torch.obs import ledger


def _record(value, metric="h100_bls12381_sig_verifies_per_sec",
            unit="verifies/s", stage_s=0.010, occupancy=0.875, soak=None,
            env=None):
    doc = {"ledger_version": 1, "metric": metric, "value": value,
           "unit": unit, "ts": 1770000000.0,
           "env": env or {"git_sha": "abc1234", "device_kind": "H100"},
           "context": {"lanes": 8192},
           "profile": {"crypto_device_stage_seconds": {
               "verify_batch/dispatch": {"count": 4, "total_s": 4 * stage_s},
               "verify_batch/readback": {"count": 4, "total_s": 0.02}},
               "occupancy": occupancy}}
    if soak is not None:
        doc["soak"] = soak
    return doc


def _soak(rate, wal=100.0, rss=1000.0, validators=100):
    return {"commit_rate_heights_per_s": rate,
            "wal_growth_bytes_per_s": wal, "rss_slope_bytes_per_s": rss,
            "flightrec_drop_per_s": 3.0, "commit_latency_p50_ms": 900.0,
            "validators": validators, "shards": 1, "chaos_cycles": 2,
            "safety_violations": 0, "breaker_cycles": 1.0}


#: Trajectories: a climb, a flat tail (a plateau), a regression, a stage
#: blowup, a latency metric, a soak series with a WAL-growth leak and a
#: fleet that shrank, and a metric change mid-run.
TRAJECTORIES = {
    "climb": [_record(1000.0), _record(1200.0), _record(1500.0)],
    "plateau": [_record(1000.0), _record(1004.0), _record(1006.0),
                _record(1005.0)],
    "regression": [_record(1000.0), _record(1010.0), _record(900.0)],
    "stage_blowup": [_record(1000.0), _record(1001.0, stage_s=0.020)],
    "latency": [_record(10.0, metric="qc_verify_ms", unit="ms"),
                _record(12.0, metric="qc_verify_ms", unit="ms")],
    "soak": [_record(0.08, metric="soak-chaos-survival", unit="heights/s",
                     soak=_soak(0.08)),
             _record(0.081, metric="soak-chaos-survival", unit="heights/s",
                     soak=_soak(0.081, wal=400.0, validators=40))],
    "incomparable": [_record(1000.0),
                     _record(3.2, metric="wall", unit="s")],
    "env_drift": [_record(1000.0, env={"git_sha": "a", "jax": "0.4.30",
                                       "device_kind": "TPU v5 lite"}),
                  _record(1001.0, env={"git_sha": "b", "jax": "0.4.31",
                                       "device_kind": "TPU v5 lite"})],
}


def _fields(rec) -> dict:
    """A BenchRecord as a dict, the raw document aside."""
    doc = dataclasses.asdict(rec)
    doc.pop("raw")
    return doc


def _both(docs, run_prefix="r"):
    return ([ledger.load_record(d, run=f"{run_prefix}{i}")
             for i, d in enumerate(docs)],
            [jax_ledger.load_record(d, run=f"{run_prefix}{i}")
             for i, d in enumerate(docs)])


def test_constants_and_soak_dimensions_agree():
    for name in ("LEDGER_VERSION", "THROUGHPUT_BAND", "OCCUPANCY_BAND",
                 "STAGE_BAND", "MAX_REGRESSION", "MAX_STAGE_BLOWUP",
                 "PLATEAU_RUNS", "PLATEAU_BAND", "SOAK_BAND",
                 "SOAK_DIMENSIONS"):
        assert getattr(ledger, name) == getattr(jax_ledger, name), name
    assert sorted(ledger.__all__) == sorted(jax_ledger.__all__)


class _Profiler:
    def summary(self):
        return {"crypto_device_stage_seconds": {
            "aggregate/dispatch": {"count": 2, "total_s": 0.5}},
            "occupancy": 0.5}


def test_build_record_and_annotate_shape_agree():
    """build_record and annotate give the JAX package's shape, key for
    key and value for value, with the timestamp and the environment
    stamp aside; the stamp names torch, not jax."""
    kw = dict(context={"lanes": 64}, vs_baseline=1.5)
    port = ledger.build_record("m", 12.5, "verifies/s",
                               profiler=_Profiler(), **kw)
    ref = jax_ledger.build_record("m", 12.5, "verifies/s",
                                  profiler=_Profiler(), **kw)
    assert sorted(port) == sorted(ref)
    for key in set(port) - {"ts", "env"}:
        assert port[key] == ref[key], key
    emitted = {"metric": "consensus-rounds", "value": 3.0, "unit": "s"}
    a = ledger.annotate(dict(emitted), profiler=_Profiler())
    b = jax_ledger.annotate(dict(emitted), profiler=_Profiler())
    assert sorted(a) == sorted(b)
    assert {k: a[k] for k in a if k not in ("ts", "env")} == {
        k: b[k] for k in b if k not in ("ts", "env")}
    env = ledger.env_fingerprint()
    assert "jax" not in env and env["torch"]
    assert set(env) >= {"git_sha", "python", "platform", "hostname",
                        "torch", "cuda"}


def test_env_stamp_never_initializes_cuda():
    """The stamp reads an already imported torch and reports the card
    only where CUDA is already initialized."""
    code = ("import sys, torch\n"
            "from consensus_overlord_tpu_torch.obs import ledger\n"
            "env = ledger.env_fingerprint()\n"
            "print(torch.cuda.is_initialized(), 'device_kind' in env,\n"
            "      'torch' in env)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["False", "False", "True"]


@pytest.mark.parametrize("name", sorted(TRAJECTORIES))
def test_load_diff_trend_and_check_agree(name):
    """Both packages load, diff, trend and check the same trajectory to
    the same result."""
    port, ref = _both(TRAJECTORIES[name])
    assert [_fields(r) for r in port] == [_fields(r) for r in ref]
    for (a, b), (c, d) in zip(zip(port, port[1:]), zip(ref, ref[1:])):
        assert [dataclasses.asdict(x) for x in ledger.diff(a, b)] == [
            dataclasses.asdict(x) for x in jax_ledger.diff(c, d)]
    assert ledger.trend(port) == jax_ledger.trend(ref)
    assert ledger.plateaus(port) == jax_ledger.plateaus(ref)
    assert [dataclasses.asdict(f) for f in ledger.check(port)] == [
        dataclasses.asdict(f) for f in jax_ledger.check(ref)]


def test_check_gates_what_it_should():
    """The gate itself, on the port: a regression and a stage blowup are
    fatal, a flat tail is advisory, a soak WAL leak or a shrunk fleet is
    fatal, a metric change gates nothing."""
    def kinds(name):
        recs, _ = _both(TRAJECTORIES[name])
        return sorted((f.kind, f.fatal) for f in ledger.check(recs))

    assert kinds("climb") == []
    assert kinds("plateau") == [("plateau", False)]
    assert kinds("regression") == [("regression", True)]
    assert kinds("stage_blowup") == [("plateau", False),
                                     ("stage_blowup", True)]
    assert kinds("latency") == [("regression", True)]
    assert kinds("soak") == [("soak_drift", True), ("soak_drift", True)]
    assert kinds("incomparable") == [("incomparable", False)]
    recs, _ = _both(TRAJECTORIES["env_drift"])
    assert ledger.trend(recs)["rows"][1]["env_drift"] == {
        "jax": "0.4.30 -> 0.4.31", "git_sha": "a -> b"}
    # The port's stamp names torch: a torch change is drift too.
    recs, _ = _both([_record(1000.0, env={"torch": "2.5.0", "git_sha": "a"}),
                     _record(1001.0, env={"torch": "2.6.0", "git_sha": "a"})])
    assert ledger.trend(recs)["rows"][1]["env_drift"] == {
        "torch": "2.5.0 -> 2.6.0"}


@pytest.mark.parametrize("shape", ["wrapper", "bare"])
def test_legacy_shapes_load_alike(shape):
    """The legacy BENCH_rNN.json wrapper (its tail's {"context"} line
    recovered) and a bare {"metric", "value"} line."""
    if shape == "wrapper":
        doc = {"n": 5, "cmd": "python bench.py", "rc": 0,
               "tail": "WARNING jax noise\n"
                       '{"context": {"lanes": 8192, "rate": 1.5}}\n'
                       '{"metric": "tpu_bls12381_sig_verifies_per_sec", '
                       '"value": 20808.15}\nnot json {\n',
               "parsed": {"metric": "tpu_bls12381_sig_verifies_per_sec",
                          "value": 20808.15, "unit": "verifies/s",
                          "vs_baseline": 14.86}}
    else:
        doc = {"metric": "tpu_bls12381_sig_verifies_per_sec",
               "value": 20832, "unit": "verifies/s"}
    port = ledger.load_record(doc, run="r05")
    ref = jax_ledger.load_record(doc, run="r05")
    assert _fields(port) == _fields(ref)
    assert port.raw == ref.raw == doc
    if shape == "wrapper":
        assert port.context == {"lanes": 8192, "rate": 1.5}
        assert port.vs_baseline == 14.86


def test_records_cross_load(tmp_path):
    """A record of each package loads in the other, from a file and
    through to_dict, to the same fields."""
    soak = _soak(0.09)
    port_doc = ledger.build_record("soak-chaos-survival", 0.09, "heights/s",
                                   profiler=_Profiler(), soak=soak,
                                   context={"validators": 100})
    ref_doc = jax_ledger.build_record("soak-chaos-survival", 0.09,
                                      "heights/s", profiler=_Profiler(),
                                      soak=soak, context={"validators": 100})
    for doc in (port_doc, ref_doc):
        path = tmp_path / "BENCH_r13.json"
        path.write_text(json.dumps(doc))
        a = ledger.load_record(str(path))
        b = jax_ledger.load_record(str(path))
        assert a.run == b.run == "r13"
        assert _fields(a) == _fields(b)
        assert a.soak["validators"] == 100.0
        assert ledger.BenchRecord.from_dict(b.to_dict(), run="x").soak == \
            jax_ledger.BenchRecord.from_dict(a.to_dict(), run="x").soak
    assert [f.kind for f in ledger.check(
        [ledger.load_record(ref_doc, run="a"),
         ledger.load_record(port_doc, run="b")])] == ["plateau"]
