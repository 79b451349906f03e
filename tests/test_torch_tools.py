"""The port's operator tools (consensus_overlord_tpu_torch/tools/ and the
ledger CLI of obs/ledger.py) against the JAX package's scripts they
twin: scripts/profile_verify.py, pairing_smoke.py, warm_cache.py and
ledger.py.  On the CPU, at N = 2 and one measured iteration: the
profile record's keys, stages and fixture; the ring through
scripts/waterfall.py; the same flags as each script; the pairing verdicts
against the oracle; the ledger CLI's output and exit code equal to the
script's; no card, no run.  Tolerance: none."""

import ast
import json
import os
import re
import subprocess
import sys

import pytest
import torch

from consensus_overlord_tpu.core.sm3 import sm3_hash as jax_sm3
from consensus_overlord_tpu.crypto import bls12381 as jax_oracle
from consensus_overlord_tpu_torch.obs import ledger
from consensus_overlord_tpu_torch.tools import fixtures, pairing_smoke
from consensus_overlord_tpu_torch.tools import profile_verify

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = os.path.join(REPO, "scripts")
PORT = os.path.join(REPO, "consensus_overlord_tpu_torch")
BENCH = [os.path.join(REPO, f"BENCH_r0{i}.json") for i in range(1, 6)]


def _tree(path):
    with open(path, encoding="utf-8") as f:
        return ast.parse(f.read())


@pytest.fixture(scope="module")
def profiled(tmp_path_factory):
    """One CPU run of profile_verify (N = 2, one measured iteration) on a
    fixture cache of its own: (record, profiler, fixture)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(fixtures, "FIXTURE_DIR",
                   str(tmp_path_factory.mktemp("fixtures")))
        args = profile_verify.parser().parse_args(
            ["2", "--iters", "1", "--cpu"])
        record, prof = profile_verify.run(args)
        yield record, prof, fixtures.bench_fixture(2)


def test_profile_verify_cpu_record(profiled, tmp_path):
    """The JSON tail loads through the port's load_record, carries all
    four stages and the JAX script's keys, and its fixture is bench.py's
    keys and votes (the JAX oracle's signatures)."""
    record, _, (sigs, h, pks) = profiled
    tail = tmp_path / "profile.json"
    tail.write_text(json.dumps(record) + "\n")
    rec = ledger.load_record(str(tail))
    assert (rec.metric, rec.unit) == (profile_verify.METRIC, "verifies/s")
    assert rec.value == record["verifies_per_s"] > 0
    assert set(record["stages_ms"]) == set(profile_verify.STAGES)
    assert {f"verify_batch/{s}" for s in profile_verify.STAGES} <= set(
        rec.stages)
    assert (record["device"], record["n"], record["stragglers"]) == (
        "cpu", 2, [])
    script = _tree(os.path.join(SCRIPTS, "profile_verify.py"))
    (keys,) = [[k.value for k in node.args[0].keys]
               for node in ast.walk(script) if isinstance(node, ast.Call)
               and getattr(node.func, "attr", None) == "annotate"]
    assert set(record) == set(keys) | {"ledger_version", "ts", "env",
                                       "profile"}
    assert h == jax_sm3(b"bench-block-hash")
    assert sigs == [jax_oracle.sign(0xBEEF + 97 * i, h) for i in range(2)]
    assert pks == [jax_oracle.sk_to_pk(0xBEEF + 97 * i) for i in range(2)]


def test_waterfall_reconstructs_the_port_ring(profiled, tmp_path):
    """scripts/waterfall.py rebuilds every round of the profiler's ring,
    each with the provider's four stages."""
    _, prof, _ = profiled
    path = tmp_path / "statusz.json"
    path.write_text(json.dumps({"profile": prof.statusz()}))
    out = subprocess.run(
        [sys.executable, os.path.join(SCRIPTS, "waterfall.py"), str(path),
         "--json"], capture_output=True, text=True, timeout=60)
    assert out.returncode == 0, out.stderr
    doc = json.loads(out.stdout)
    ring = prof.tail()
    assert doc["count"] == len(ring) >= 1
    assert [r["round_id"] for r in doc["rounds"]] == sorted(
        r["round_id"] for r in ring)
    for r in doc["rounds"]:
        assert {s["stage"] for s in r["segments"]} == set(
            profile_verify.STAGES)


def _argparse_calls(tree):
    """Each add_parser / add_argument call in order: its name, its
    positional arguments and its keywords but help, unparsed (a module
    prefix `ledger.` dropped)."""
    calls = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and getattr(
                node.func, "attr", None) in ("add_argument", "add_parser"):
            calls.append((node.lineno, node.func.attr,
                          [ast.unparse(a) for a in node.args],
                          {k.arg: ast.unparse(k.value).replace(
                              "ledger.", "")
                           for k in node.keywords if k.arg != "help"}))
    return [c[1:] for c in sorted(calls, key=lambda c: c[0])]


def _flags(tree):
    return sorted({n.value for n in ast.walk(tree)
                   if isinstance(n, ast.Constant) and isinstance(n.value, str)
                   and re.fullmatch(r"--[a-z-]+", n.value)})


def _default_literal(tree, name):
    """The literal a hand parser falls back to for `name`: the last
    operand of `name = ... or [..]`, or the else of `... if ... else N`."""
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and any(
                getattr(t, "id", None) == name for t in node.targets):
            value = node.value
            if isinstance(value, ast.BoolOp):
                return ast.literal_eval(value.values[-1])
            if isinstance(value, ast.IfExp):
                return ast.literal_eval(value.orelse)
    raise AssertionError(f"no default for {name}")


@pytest.mark.parametrize("tool", ["profile_verify", "ledger",
                                  "pairing_smoke", "warm_cache"])
def test_tools_take_the_scripts_flags(tool):
    """profile_verify and the ledger CLI declare the script's subcommands
    and arguments in its order, with its types, defaults and actions;
    pairing_smoke and warm_cache (hand-parsed scripts) take the script's
    flags and positional default, pairing_smoke --cpu besides."""
    script = _tree(os.path.join(SCRIPTS, f"{tool}.py"))
    port = _tree(os.path.join(PORT, "obs" if tool == "ledger" else "tools",
                              f"{tool}.py"))
    if tool in ("profile_verify", "ledger"):
        assert _argparse_calls(port) == _argparse_calls(script)
    elif tool == "pairing_smoke":
        assert _flags(script) == ["--inject-loss", "--mesh"]
        assert _flags(port) == ["--cpu", "--inject-loss", "--mesh"]
        ap = pairing_smoke.parser()
        assert ap.parse_args([]).n == _default_literal(script, "N") == 4
        got = ap.parse_args(["6", "--mesh", "3", "--inject-loss", "1"])
        assert (got.n, got.mesh, got.inject_loss, got.cpu) == (
            6, 3, 1, False)
    else:
        assert _flags(script) == _flags(port) == []
        assert _default_literal(port, "rungs") == _default_literal(
            script, "rungs") == [32, 128, 512]


def test_pairing_smoke_agrees_and_a_tampered_set_fails(monkeypatch, capsys):
    """At N = 2 every verdict is the oracle's and the expectation (exit
    0); a set whose signature is forged after its expectation was fixed
    is reported and fails the run (exit 1)."""
    assert pairing_smoke.main(["2", "--cpu"]) == 0
    assert "ok: 2/2 device verdicts" in capsys.readouterr().out
    make_sets = pairing_smoke.make_sets

    def tampered(n):
        from consensus_overlord_tpu_torch.crypto import bls12381 as oracle
        sets = make_sets(n)
        sig, pk, h_pt, want = sets[0]
        sets[0] = (oracle.g1_mul(sig, 3), pk, h_pt, want)
        return sets

    monkeypatch.setattr(pairing_smoke, "make_sets", tampered)
    assert pairing_smoke.main(["1", "--cpu"]) == 1
    out = capsys.readouterr().out
    assert "set 0: device=False host=False expected=True MISMATCH" in out
    assert "FAIL: 1/1 sets disagree" in out


def test_ledger_cli_matches_the_script(tmp_path):
    """show, diff, trend and check over BENCH_r01-r05, and check against
    a 10% regression: the port's CLI prints what scripts/ledger.py prints
    and exits with its code."""
    newest = ledger.load_record(BENCH[-1])
    regressed = tmp_path / "regressed.json"
    regressed.write_text(json.dumps({"metric": newest.metric,
                                     "value": newest.value * 0.9,
                                     "unit": newest.unit}))
    cases = [(["show", BENCH[-1]], 0), (["diff", *BENCH[-2:]], 0),
             (["trend", *BENCH], 0), (["check", *BENCH], 0),
             (["check", BENCH[-1], str(regressed)], 1)]
    for argv, rc in cases:
        script = subprocess.run(
            [sys.executable, os.path.join(SCRIPTS, "ledger.py"), *argv],
            cwd=REPO, capture_output=True, text=True, timeout=60)
        port = subprocess.run(
            [sys.executable, "-m", "consensus_overlord_tpu_torch.obs.ledger",
             *argv], cwd=REPO, capture_output=True, text=True, timeout=60)
        assert (port.returncode, port.stdout) == (
            script.returncode, script.stdout), argv
        assert port.returncode == rc, (argv, port.stderr)
    assert "FAIL [regression]" in port.stdout


def test_tools_without_a_card_exit_naming_it(capsys):
    """Without --cpu and with no card, each tool exits 2 naming the
    missing card, and runs nothing."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible")
    from consensus_overlord_tpu_torch.tools import warm_cache

    for tool, argv in ((profile_verify, ["2"]), (pairing_smoke, ["2"]),
                       (warm_cache, ["32"])):
        assert tool.main(argv) == 2
        captured = capsys.readouterr()
        assert "no CUDA card is visible" in captured.err
        assert captured.out == ""
