"""The slice as a whole: the port's validator fleet committing BLS12-381
heights on CudaBlsCrypto's CPU twin (every kernel's plain PyTorch
version), checked against the JAX package (its controller's block and
its CpuBlsCrypto's audit of the proof), and the port's entry point
``python -m consensus_overlord_tpu_torch.sim.run`` in a subprocess:
it runs without jax, grpc or prometheus_client, and asks for the card
unless told otherwise.  Tolerance: none (bytes and verdicts)."""

import asyncio
import os
import subprocess
import sys

import pytest
import torch

from consensus_overlord_tpu.core.bitmap import extract_voters
from consensus_overlord_tpu.core.sm3 import sm3_hash
from consensus_overlord_tpu.core.types import Proof, Vote, VoteType
from consensus_overlord_tpu.crypto.provider import CpuBlsCrypto
from consensus_overlord_tpu.sim.controller import SimController
from consensus_overlord_tpu_torch.crypto.cuda_provider import CudaBlsCrypto
from consensus_overlord_tpu_torch.sim import SimNetwork
from consensus_overlord_tpu_torch.sim.run import sum_status

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_bls_fleet_on_the_cpu_twin_commits_an_audited_block():
    torch.set_num_threads(1)

    async def main():
        # A 10-s interval: height 1 is not paced by it, but its round
        # timers must outlast the plain verify rounds on a loaded CPU,
        # or the nodes choke and every choke round is another batch to
        # verify.
        net = SimNetwork(
            n_validators=4, block_interval_ms=10000, use_frontier=True,
            sim_device_crypto=True,
            crypto_factory=lambda i: CudaBlsCrypto(
                0x1000 + 7919 * i, device="cpu", device_threshold=2,
                qc_device_threshold=10**9))
        net.start(init_height=1)
        try:
            await net.run_until_height(1, timeout=120)
        finally:
            await net.stop()
        return net

    net = asyncio.run(main())
    c = net.controller
    # The providers were left unwrapped: CudaBlsCrypto has its breaker.
    assert all(isinstance(n.crypto, CudaBlsCrypto) for n in net.nodes)
    ref_ctl = SimController(c.validators, 10000)
    assert c.chain[1] == ref_ctl.make_content(1)
    proof = Proof.decode(c.proofs[1])
    voters = extract_voters(ref_ctl.authority_list(),
                            proof.signature.address_bitmap)
    assert 3 * len(voters) > 2 * len(c.validators)
    vote = Vote(proof.height, proof.round, VoteType.PRECOMMIT,
                proof.block_hash)
    oracle = CpuBlsCrypto(0x1000)
    assert oracle.verify_aggregated_signature(
        proof.signature.signature, sm3_hash(vote.encode()), voters)
    status = sum_status(n.crypto.degraded_status() for n in net.nodes)
    # The leader's vote batches ran the plain verify round.
    assert status["calls"]["verify_batch"]["device"] >= 1
    assert status["total_failures"] == 0
    assert status["pairing_host_fallbacks"] == 0
    assert status["state"] == {"closed": 4}
    assert sum(n.frontier.stats.reverified for n in net.nodes) == 0
    assert not c.violations


def _run_entry(args, blocked=("grpc", "prometheus_client")):
    """sim.run as a subprocess with `blocked` modules unimportable; the
    last stdout line reports the leftover modules of interest."""
    code = (
        "import runpy, sys\n"
        f"for m in {list(blocked)!r}:\n"
        "    sys.modules[m] = None\n"
        f"sys.argv = ['sim.run'] + {list(args)!r}\n"
        "runpy.run_module('consensus_overlord_tpu_torch.sim.run',\n"
        "                 run_name='__main__')\n"
        "print('LOADED', sorted(m for m, v in sys.modules.items()\n"
        "      if v is not None and m.split('.')[0] in\n"
        "      ('jax', 'jaxlib', 'grpc', 'prometheus_client',\n"
        "       'consensus_overlord_tpu')))\n")
    env = dict(os.environ, PYTHONPATH=REPO, CUDA_VISIBLE_DEVICES="")
    return subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)


def test_entry_point_runs_without_jax_grpc_or_prometheus():
    import json

    out = _run_entry(["--crypto", "simhash", "--validators", "4",
                      "--heights", "3", "--device", "cpu"])
    assert out.returncode == 0, out.stdout + out.stderr
    lines = out.stdout.strip().splitlines()
    assert lines[-1] == "LOADED []"
    summary = json.loads(lines[-2])
    assert summary["metric"] == "consensus-rounds"
    assert (summary["validators"], summary["heights"]) == (4, 3)
    assert summary["ms_per_height"] > 0 and summary["delivered"] > 0
    assert summary["crypto_status"]["state"] == {"closed": 4}
    for h in (1, 2, 3):
        assert any(ln.startswith(f"height {h} committed") for ln in lines)


def test_bls_without_a_card_fails_instead_of_falling_back():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = _run_entry(["--crypto", "bls", "--validators", "4",
                      "--heights", "1"])
    assert out.returncode != 0
    assert "torch.cuda.is_available() is False" in out.stderr
    assert "height 1 committed" not in out.stdout


@pytest.mark.parametrize("name", ["ed25519", "secp256k1", "sm2"])
def test_schemes_not_ported_are_refused(name):
    """Each of the JAX package's schemes runs through the entry point on
    the CPU (4 validators, one height, the providers' host path below
    the default threshold); a scheme outside its five is refused."""
    import json

    out = _run_entry(["--crypto", name, "--device", "cpu", "--validators",
                      "4", "--heights", "1", "--flightrec", "0"])
    assert out.returncode == 0, out.stdout + out.stderr
    lines = out.stdout.strip().splitlines()
    assert lines[-1] == "LOADED []"
    summary = json.loads(lines[-2])
    assert (summary["crypto"], summary["device"]) == (name, "cpu")
    assert summary["crypto_status"]["calls"]["verify_batch"]["host"] > 0
    assert any(ln.startswith("height 1 committed") for ln in lines)
    out = _run_entry(["--crypto", name + "x", "--device", "cpu"])
    assert out.returncode == 2 and "invalid choice" in out.stderr


def test_ed25519_is_the_default_scheme():
    from consensus_overlord_tpu_torch.sim import run as sim_run

    args = sim_run.make_parser().parse_args([])
    assert (args.crypto, args.device) == ("ed25519", "cuda")


#: The device step each breaker-less provider's verify_batch goes through.
_DEVICE_STEPS = {"ed25519": ("ed25519_cuda", "decompress_lanes"),
                 "secp256k1": ("ecdsa_cuda", "verify_lanes"),
                 "sm2": ("ecdsa_cuda", "verify_lanes")}


@pytest.mark.parametrize("name", sorted(_DEVICE_STEPS))
def test_device_fault_of_each_scheme_fails_the_run(name, monkeypatch):
    """A device step raising a RuntimeError in a --device cpu fleet of
    Ed25519CudaCrypto / Secp256k1Crypto / Sm2Crypto (each wrapped in
    SimDeviceCrypto): the provider raises, the frontier keeps the
    fault, nothing re-verifies on the host, and sim.run exits 3."""
    import importlib

    from consensus_overlord_tpu_torch.sim import run as sim_run

    module, step = _DEVICE_STEPS[name]
    mod = importlib.import_module(f"consensus_overlord_tpu_torch.crypto."
                                  f"{module}")

    def broken(*a, **k):
        raise RuntimeError(f"{step}: device fault")

    monkeypatch.setattr(mod, step, broken)
    args = sim_run.make_parser().parse_args(
        ["--crypto", name, "--device", "cpu", "--validators", "4",
         "--heights", "1", "--device-threshold", "2", "--interval-ms",
         "10000", "--timeout", "60", "--flightrec", "0"])
    base = sim_run.crypto_factory(args)
    built = []

    def factory(i):
        built.append(base(i))
        return built[-1]

    with pytest.raises(SystemExit) as exc:
        asyncio.run(sim_run.run(args, factory, True, 1))
    assert exc.value.code == 3
    status = sum_status(p.degraded_status() for p in built)
    assert status["calls"]["verify_batch"]["device"] >= 1


def test_sum_status_adds_counts_and_tallies_states():
    docs = [{"state": "closed", "total_failures": 1, "fault_injected": False,
             "last_failure_reason": None,
             "calls": {"verify_batch": {"device": 2, "host": 1}}},
            {"state": "open", "total_failures": 2, "fault_injected": True,
             "last_failure_reason": "x",
             "calls": {"verify_batch": {"device": 3, "host": 0}}}]
    assert sum_status(docs) == {
        "state": {"closed": 1, "open": 1}, "total_failures": 3,
        "fault_injected": 1, "last_failure_reason": {"x": 1},
        "calls": {"verify_batch": {"device": 5, "host": 1}}}


def test_provider_counts_calls_by_where_they_ran():
    """`calls` (in degraded_status) counts the device dispatches issued
    and the calls a threshold or an open breaker routed to the host; a
    dispatch that an injected fault stopped is neither."""
    from consensus_overlord_tpu_torch.crypto.breaker import CircuitBreaker

    cpus = [CpuBlsCrypto(0x1000 + 7919 * i) for i in range(4)]
    h = b"\x09" * 32
    sigs, pks = [c.sign(h) for c in cpus], [c.pub_key for c in cpus]
    p = CudaBlsCrypto(0x1000, device="cpu", device_threshold=4,
                      breaker=CircuitBreaker(failure_threshold=1,
                                             cooldown_s=60.0))
    assert p.verify_batch(sigs[:2], [h] * 2, pks[:2]) == [True, True]
    p.breaker.inject_faults(60.0)
    assert p.aggregate_signatures(sigs, pks) == \
        cpus[0].aggregate_signatures(sigs, pks)  # fails over, opens
    assert p.verify_batch(sigs, [h] * 4, pks) == [True] * 4  # breaker open
    assert p.degraded_status()["calls"] == {
        "verify_batch": {"device": 0, "host": 2},
        "aggregate": {"device": 0, "host": 0},
        "verify_aggregated": {"device": 0, "host": 0}}


class _BrokenKernels:
    """A kernel set whose every device step raises a RuntimeError that no
    chaos hook injected: what a failed CUDA launch or readback raises."""

    def __getattr__(self, name):
        if name == "lanes":
            return 1

        def step(*a, **k):
            raise RuntimeError(f"{name}: device fault")
        return step


def test_device_fault_fails_the_run_instead_of_committing():
    """A device step raising inside a --device cpu BLS fleet: the frontier
    keeps the fault, nothing re-verifies on the host, and sim.run exits 3
    without committing a height."""
    from consensus_overlord_tpu_torch.sim import run as sim_run

    torch.set_num_threads(1)
    args = sim_run.make_parser().parse_args(
        ["--crypto", "bls", "--device", "cpu", "--validators", "4",
         "--heights", "1", "--device-threshold", "2", "--interval-ms",
         "10000", "--timeout", "60", "--flightrec", "0"])
    base = sim_run.crypto_factory(args)
    built = []

    def factory(i):
        p = base(i)
        p._kernels = _BrokenKernels()
        built.append(p)
        return p

    with pytest.raises(SystemExit) as exc:
        asyncio.run(sim_run.run(args, factory, True, 1))
    assert exc.value.code == 3
    status = sum_status(p.degraded_status() for p in built)
    assert status["total_failures"] == 0  # the breaker took nothing
    assert status["calls"]["verify_batch"]["device"] >= 1


def test_warm_bls_runs_every_device_path_once():
    """crypto/warm.py (sim.run --prewarm) at rung 8 on the CPU twin: every
    path goes to the (plain) device steps, and a device fault raises at
    once instead of being retried."""
    from consensus_overlord_tpu_torch.crypto.warm import rungs_for, warm_bls

    torch.set_num_threads(1)
    assert rungs_for(8) == [8]
    p = CudaBlsCrypto(0x1000, device="cpu", device_threshold=8)
    warm_bls(p, [8], group_sizes=(1, 2))
    calls = p.degraded_status()["calls"]
    assert calls["verify_batch"] == {"device": 2, "host": 0}
    assert calls["aggregate"] == {"device": 1, "host": 0}
    assert calls["verify_aggregated"] == {"device": 1, "host": 0}
    p._kernels = _BrokenKernels()
    with pytest.raises(RuntimeError, match="device fault"):
        warm_bls(p, [8], group_sizes=(1,))
    assert p.breaker.status()["total_failures"] == 0


class _IssueCheckedKernels:
    """The real kernel set, noting for each device step called whether
    the calling thread held the process-wide issue lock."""

    def __init__(self, inner):
        self.inner = inner
        self.held = {}

    def __getattr__(self, name):
        from consensus_overlord_tpu_torch.crypto import cuda_provider

        got = getattr(self.inner, name)
        if not callable(got):
            return got

        def step(*a, **k):
            self.held.setdefault(name, set()).add(
                cuda_provider._ISSUE._is_owned())
            return got(*a, **k)
        return step


def test_device_work_issues_under_one_lock_per_process():
    """Every device step of every path is issued with cuda_provider._ISSUE
    held, and a second provider cannot issue while another thread holds
    it (a fleet's dispatchers take turns instead of trading the GIL on
    every torch call)."""
    import threading

    from consensus_overlord_tpu_torch.crypto import cuda_provider

    torch.set_num_threads(1)
    cpus = [CpuBlsCrypto(0x1000 + 7919 * i) for i in range(8)]
    h = b"\x0b" * 32
    sigs, pks = [c.sign(h) for c in cpus], [c.pub_key for c in cpus]
    p = CudaBlsCrypto(0x1000, device="cpu", device_threshold=8)
    p._kernels = checked = _IssueCheckedKernels(p._kernels)
    p.update_pubkeys(pks)
    assert p.verify_batch(sigs, [h] * 8, pks) == [True] * 8
    agg = p.aggregate_signatures(sigs, pks)
    assert agg == cpus[0].aggregate_signatures(sigs, pks)
    assert p.verify_aggregated_signature(agg, h, pks)
    # (The CPU twin pairs on the host unless asked: no multi_pairing.)
    assert set(checked.held) >= {"g2_validate", "verify_round",
                                 "g1_validate_sum", "g2_sum_rows"}
    assert all(v == {True} for v in checked.held.values()), checked.held
    calls = p.degraded_status()["calls"]
    assert calls["verify_batch"]["device"] == 1
    assert calls["aggregate"]["device"] == 1
    assert calls["verify_aggregated"]["device"] == 1

    q = CudaBlsCrypto(0x1000 + 7919, device="cpu", device_threshold=8)
    q.update_pubkeys(pks)
    box = {}
    with cuda_provider._ISSUE:
        t = threading.Thread(target=lambda: box.setdefault(
            "ok", q.verify_aggregated_signature(agg, h, pks)))
        t.start()
        t.join(0.5)
        assert t.is_alive() and q.degraded_status()["calls"][
            "verify_aggregated"]["device"] == 0
    t.join(120)
    assert box == {"ok": True}
