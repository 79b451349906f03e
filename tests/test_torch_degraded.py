"""Degraded mode of CudaBlsCrypto (consensus_overlord_tpu_torch/crypto/
cuda_provider.py) on the CPU: the circuit breaker around every device
path, the counted host fallback of a failed device pairing, the dispatch
watchdog and the chaos hooks, verdict for verdict against the JAX
package's CpuBlsCrypto — twins of tests/test_pairing.py
test_injected_pairing_fault_host_fallback, tests/test_resilience.py
TestDeviceFallback and tests/test_mesh_resilience.py's single-chip
watchdog tests — and the port's copy of the breaker held against the
JAX package's.

Faults are injected in Python only: the breaker's fault window, a kernel
set whose steps raise InjectedDeviceFault, or the chaos hooks.  Any other
exception of a device step or readback is a real device fault: it
propagates and never reaches the breaker.  Device pairing stays off
except where the pairing fallback is the subject, and there the fault
fires before the tower runs."""

import random
import threading
import time

import pytest
import torch

from consensus_overlord_tpu.core.sm3 import sm3_hash
from consensus_overlord_tpu.crypto import breaker as jbreaker
from consensus_overlord_tpu.crypto.provider import CpuBlsCrypto
from consensus_overlord_tpu.obs import Metrics, snapshot
from consensus_overlord_tpu_torch.crypto import breaker
from consensus_overlord_tpu_torch.crypto import cuda_provider
from consensus_overlord_tpu_torch.crypto.breaker import (
    CircuitBreaker,
    DispatchTimeout,
    InjectedDeviceFault,
)
from consensus_overlord_tpu_torch.crypto.cuda_provider import CudaBlsCrypto
from consensus_overlord_tpu_torch.obs.prof import DeviceProfiler

# One intra-op thread: several worker processes share the cores.
torch.set_num_threads(1)

N = 4
KEYS = [0x2222 * (i + 1) + 11 for i in range(N)]


class FakeClock:
    def __init__(self):
        self.t = 1000.0

    def __call__(self):
        return self.t


class FlakyKernels(cuda_provider._SingleChipKernels):
    """The real kernel set, with every device step raising while `fail`
    is set — an injected device fault that needs no hardware."""

    def __init__(self, fault=InjectedDeviceFault):
        self.fail = True
        self.fault = fault
        self.calls = 0

    def _gate(self, name, *a):
        self.calls += 1
        if self.fail:
            raise self.fault("device fault")
        return getattr(cuda_provider._SingleChipKernels, name)(*a)

    def verify_round(self, *a):
        return self._gate("verify_round", *a)

    def verify_round_multi(self, *a):
        return self._gate("verify_round_multi", *a)

    def g1_validate_sum(self, *a):
        return self._gate("g1_validate_sum", *a)

    def g2_sum_rows(self, *a):
        return self._gate("g2_sum_rows", *a)

    def g2_validate(self, *a):
        return self._gate("g2_validate", *a)


class FailingPairing(cuda_provider._SingleChipKernels):
    """A kernel set whose device pairing raises at dispatch."""

    @staticmethod
    def multi_pairing(*_a):
        raise InjectedDeviceFault("pairing device fault")


@pytest.fixture(scope="module")
def cpus():
    return [CpuBlsCrypto(k) for k in KEYS]


@pytest.fixture(scope="module")
def cache(cpus):
    """A pubkey cache validated once on the device path."""
    p = CudaBlsCrypto(KEYS[0], device_threshold=1, device="cpu",
                      device_pairing=False)
    p.update_pubkeys([c.pub_key for c in cpus])
    return p._pk


def provider(cache, **kw):
    kw.setdefault("device_pairing", False)
    p = CudaBlsCrypto(KEYS[0], device_threshold=1, device="cpu", **kw)
    p.load_pubkey_cache(cache)
    return p


def batch(cpus, msg, bad=1):
    """N votes on one hash; lane `bad` signed another hash."""
    h = sm3_hash(msg)
    sigs = [c.sign(h) for c in cpus]
    sigs[bad] = cpus[bad].sign(sm3_hash(b"other"))
    return sigs, h, [c.pub_key for c in cpus]


def reference(cpus, sigs, h, voters):
    return [cpus[0].verify_signature(s, h, v) for s, v in zip(sigs, voters)]


# -- the counted pairing fallback (tests/test_pairing.py) -----------------------

@pytest.mark.parametrize("path", ["verify_batch", "verify_aggregated"])
def test_injected_pairing_fault_host_fallback(cpus, cache, path):
    """A device fault on the pairing dispatch feeds the breaker, lands in
    pairing_host_fallbacks, and the host oracle still gives exact
    verdicts; one fault does not open the breaker."""
    t = provider(cache, device_pairing=True)
    t._kernels = FailingPairing()
    sigs, h, voters = batch(cpus, b"fault-pairing")
    if path == "verify_batch":
        assert t.verify_batch(sigs, [h] * N, voters) == reference(
            cpus, sigs, h, voters)
    else:
        agg = cpus[0].aggregate_signatures(sigs, voters)
        assert t.verify_aggregated_signature(agg, h, voters) is (
            cpus[0].verify_aggregated_signature(agg, h, voters))
    st = t.degraded_status()
    assert t.pairing_host_fallbacks == st["pairing_host_fallbacks"] == 1
    assert st["state"] == "closed"  # one fault ≠ open
    assert st["last_failure_reason"] == "pairing: InjectedDeviceFault"


# -- device failures and the breaker (tests/test_resilience.py) ------------------

def test_failed_dispatch_reverifies_on_host(cpus, cache):
    """A forced device failure gives the correct verdicts via the host
    oracle, counts into the bound metrics, and trips the breaker; an
    open breaker sends nothing to the device."""
    clock = FakeClock()
    t = provider(cache, breaker=CircuitBreaker(
        failure_threshold=2, cooldown_s=30.0, clock=clock))
    flaky = t._kernels = FlakyKernels()
    m = Metrics()
    t.bind_metrics(m)
    sigs, h, voters = batch(cpus, b"degraded-block")
    want = reference(cpus, sigs, h, voters)
    assert want == [True, False, True, True]

    assert t.verify_batch(sigs, [h] * N, voters) == want
    assert flaky.calls == 1
    scraped = snapshot(m.registry)
    assert scraped["crypto_device_failures_total{path=verify_batch}"] == 1.0
    assert scraped["crypto_host_fallbacks_total{path=verify_batch}"] == 1.0
    assert t.breaker.state == "closed"  # threshold 2: one more to trip

    assert t.verify_batch(sigs, [h] * N, voters) == want
    assert t.breaker.state == "open"
    scraped = snapshot(m.registry)
    assert scraped["crypto_breaker_open"] == 1.0
    assert scraped["crypto_breaker_transitions_total{to=open}"] == 1.0

    assert t.verify_batch(sigs, [h] * N, voters) == want
    assert flaky.calls == 2


def test_breaker_recovers_after_fault_clears(cpus, cache):
    clock = FakeClock()
    t = provider(cache, breaker=CircuitBreaker(
        failure_threshold=1, cooldown_s=5.0, clock=clock))
    flaky = t._kernels = FlakyKernels()
    h = sm3_hash(b"recovery-block")
    sigs = [c.sign(h) for c in cpus]
    voters = [c.pub_key for c in cpus]

    assert t.verify_batch(sigs, [h] * N, voters) == [True] * N
    assert t.breaker.state == "open"
    flaky.fail = False                  # the card comes back
    assert t.verify_batch(sigs, [h] * N, voters) == [True] * N
    assert t.breaker.state == "open"    # still cooling down: host path
    clock.t += 5.1
    # The half-open probe rides the real (restored) kernels and closes.
    assert t.verify_batch(sigs, [h] * N, voters) == [True] * N
    assert t.breaker.state == "closed"
    assert t.degraded_status()["times_opened"] == 1
    assert flaky.calls == 2


def test_injected_faults_on_every_path_open_the_breaker(cpus, cache):
    """The breaker's fault window fails verify_batch, aggregate and
    verify_aggregated in turn; each gives CpuBlsCrypto's result, the
    third failure opens the breaker, and after the window is cleared and
    the cooldown has passed one clean device call closes it."""
    clock = FakeClock()
    t = provider(cache, qc_device_threshold=1, breaker=CircuitBreaker(
        failure_threshold=3, cooldown_s=5.0, clock=clock))
    sigs, h, voters = batch(cpus, b"chaos-block")
    good = [c.sign(h) for c in cpus]
    agg = cpus[0].aggregate_signatures(good, voters)
    t.breaker.inject_faults(60.0)
    assert t.verify_batch(sigs, [h] * N, voters) == reference(
        cpus, sigs, h, voters)
    assert t.aggregate_signatures(good, voters) == agg
    assert t.breaker.state == "closed"
    assert t.verify_aggregated_signature(agg, h, voters) is True
    st = t.degraded_status()
    assert st["state"] == "open" and st["total_injected"] == 3
    assert st["last_failure_reason"] == \
        "verify_aggregated: InjectedDeviceFault"
    t.breaker.clear_injected_faults()
    clock.t += 5.1
    assert t.aggregate_signatures(good, voters) == agg  # the probe
    assert t.breaker.state == "closed"


def test_update_pubkeys_device_failure_falls_back_to_host(cpus, cache):
    """A failed device validation validates on the host, with no row
    appended twice: the cache equals the device-validated one."""
    t = CudaBlsCrypto(KEYS[0], device_threshold=1, device="cpu",
                      device_pairing=False)
    flaky = t._kernels = FlakyKernels()
    voters = [c.pub_key for c in cpus] + [b"\x02" * 96]
    t.update_pubkeys(voters)
    assert flaky.calls == 1
    assert t.breaker.status()["last_failure_reason"] == \
        "update_pubkeys: InjectedDeviceFault"
    assert t._pk.px.shape[0] == len(voters)
    assert t._pk.aff[:N] == cache.aff
    assert t._pk.index[voters[-1]] == -1
    assert [t._pk.index[v] for v in voters[:N]] == list(range(N))


def test_device_loss_hook(cpus, cache):
    """inject_device_loss names the lane "type:index"; while armed, every
    watched call raises DeviceLossError and re-verifies on the host."""
    t = provider(cache)
    sigs, h, voters = batch(cpus, b"loss-block")
    t.inject_device_loss("cuda:0", 60.0)  # another lane: no effect
    assert t._watched(lambda: 7, path="verify_batch") == 7
    t.inject_device_loss("cuda:0", 0)
    t.inject_device_loss("cpu:0", 60.0)
    assert t.verify_batch(sigs, [h] * N, voters) == reference(
        cpus, sigs, h, voters)
    assert t.breaker.status()["last_failure_reason"] == \
        "verify_batch: DeviceLossError"
    t.inject_device_loss("cpu:0", 0)
    assert t._inject_loss == {}


def test_profiler_stages_of_the_qc_paths(cpus, cache):
    """A bound DeviceProfiler records each QC call's stages and padded
    shape, and names the device."""
    t = provider(cache, qc_device_threshold=1)
    prof = DeviceProfiler()
    t.bind_profiler(prof)
    h = sm3_hash(b"profiled-qc")
    sigs = [c.sign(h) for c in cpus]
    voters = [c.pub_key for c in cpus]
    agg = t.aggregate_signatures(sigs, voters)
    assert t.verify_aggregated_signature(agg, h, voters)
    totals = prof.stage_totals()
    for op, stages in (("aggregate", ("parse", "dispatch", "readback")),
                       ("verify_aggregated",
                        ("parse", "dispatch", "readback", "pairing"))):
        for stage in stages:
            assert totals[f"{op}/{stage}"]["count"] == 1
    assert [r["padded"] for r in prof.tail()] == [8, 8]
    assert prof.summary()["devices"] == ["cpu:0"]


# -- the dispatch watchdog (tests/test_mesh_resilience.py) -----------------------

def test_deadline_scales_with_the_batch_rung():
    t = CudaBlsCrypto(0xBEEF, device="cpu", dispatch_deadline_s=2.0)
    assert t._deadline_for(cuda_provider._PAD_SIZES[0]) == 2.0
    assert t._deadline_for(4 * cuda_provider._PAD_SIZES[0]) == 4.0
    assert t._deadline_for(0) == 2.0  # floor at the base
    off = CudaBlsCrypto(0xBEEF, device="cpu", dispatch_deadline_s=0.0)
    assert off._deadline_for(8192) is None


def test_deadline_reads_the_environment(monkeypatch):
    monkeypatch.setenv("CONSENSUS_DISPATCH_DEADLINE_S", "1.5")
    assert CudaBlsCrypto(0xBEEF, device="cpu")._deadline_for(8) == 1.5
    monkeypatch.delenv("CONSENSUS_DISPATCH_DEADLINE_S")
    assert CudaBlsCrypto(0xBEEF, device="cpu")._deadline_for(8) is None


def test_wedged_dispatch_times_out_with_exact_host_verdicts(cpus, cache):
    """A stall longer than the deadline surfaces as a DispatchTimeout
    breaker failure at the deadline (not at the end of the stall), and
    the batch re-verifies exactly on the host oracle."""
    t = provider(cache, dispatch_deadline_s=0.0)
    sigs, h, voters = batch(cpus, b"watchdog-block")
    want = reference(cpus, sigs, h, voters)
    t._dispatch_deadline_s = 1.5
    t.inject_dcn_stall(30.0)
    t0 = time.monotonic()
    with pytest.raises(DispatchTimeout):
        t._watched(lambda: None, size=8, path="verify_batch")
    cut = time.monotonic() - t0
    assert 1.4 <= cut < 1.5 + 1.0, f"watchdog fired at {cut:.2f}s"
    t0 = time.monotonic()
    got = t.verify_batch(sigs, [h] * N, voters)
    elapsed = time.monotonic() - t0
    t.inject_dcn_stall(0.0)
    assert got == want                     # exact host re-verify
    assert elapsed < 15.0, f"verify took {elapsed:.1f}s: rode out the wedge"
    st = t.breaker.status()
    assert "DispatchTimeout" in st["last_failure_reason"]
    assert t.pairing_host_fallbacks == 0   # the batch path, not the pairing


def test_clearing_the_stall_releases_the_abandoned_readback(cache):
    """Clearing dcn_stall wakes the readback the watchdog abandoned, and
    that readback ends without touching the device."""
    t = provider(cache, dispatch_deadline_s=0.2)
    before = set(threading.enumerate())
    touched = []
    t.inject_dcn_stall(30.0)
    with pytest.raises(DispatchTimeout) as caught:
        t._watched(lambda: touched.append(1), size=8, path="verify_batch")
    assert caught.value.injected
    workers = [w for w in threading.enumerate() if w not in before]
    assert [w.name for w in workers] == ["dispatch-watchdog-verify_batch"]
    t.inject_dcn_stall(0.0)
    workers[0].join(2.0)
    assert not workers[0].is_alive()
    assert touched == []


# -- real device faults propagate ------------------------------------------------

class FailingPairingForReal(cuda_provider._SingleChipKernels):
    """A kernel set whose device pairing raises as a CUDA error would."""

    @staticmethod
    def multi_pairing(*_a):
        raise RuntimeError("device fault")


@pytest.mark.parametrize("path", ["verify_batch", "aggregate",
                                  "verify_aggregated", "pairing",
                                  "update_pubkeys"])
def test_device_fault_propagates(cpus, cache, path):
    """A device step that fails with anything but an injected fault (a
    RuntimeError here, as a launch or CUDA runtime error would be)
    raises from the provider: no host re-verify, nothing fed to the
    breaker, no fallback counted, no half-appended pubkey cache."""
    t = provider(cache, qc_device_threshold=1,
                 device_pairing=path == "pairing")
    if path == "update_pubkeys":
        t = CudaBlsCrypto(KEYS[0], device_threshold=1, device="cpu",
                          device_pairing=False)
    if path == "pairing":
        t._kernels = FailingPairingForReal()
    else:
        flaky = t._kernels = FlakyKernels(RuntimeError)
    m = Metrics()
    t.bind_metrics(m)
    h = sm3_hash(b"real-fault")
    sigs = [c.sign(h) for c in cpus]
    voters = [c.pub_key for c in cpus]
    with pytest.raises(RuntimeError, match="device fault") as caught:
        if path == "verify_batch":
            t.verify_batch(sigs, [h] * N, voters)
        elif path == "aggregate":
            t.aggregate_signatures(sigs, voters)
        elif path == "update_pubkeys":
            t.update_pubkeys(voters)
        else:
            t.verify_aggregated_signature(
                cpus[0].aggregate_signatures(sigs, voters), h, voters)
    assert not isinstance(caught.value, InjectedDeviceFault)
    if path != "pairing":
        assert flaky.calls == 1
    st = t.degraded_status()
    assert st["state"] == "closed" and st["total_failures"] == 0
    assert st["pairing_host_fallbacks"] == 0
    assert not any(v for k, v in snapshot(m.registry).items()
                   if k.startswith(("crypto_host_fallbacks_total",
                                    "crypto_device_failures_total")))
    if path == "update_pubkeys":
        assert t._pk.px.shape[0] == 0 and t._pk.index == {}


def test_real_watchdog_timeout_propagates(cpus, cache, monkeypatch):
    """A readback that overruns the deadline with no stall armed is a
    wedged card, not a chaos fault: its DispatchTimeout reaches the
    caller unmarked, and the breaker records nothing."""
    t = provider(cache, qc_device_threshold=1, dispatch_deadline_s=0.2)
    release = threading.Event()
    readback = cuda_provider._readback

    def slow(out):
        release.wait(10.0)
        return readback(out)

    monkeypatch.setattr(cuda_provider, "_readback", slow)
    h = sm3_hash(b"wedged-card")
    sigs = [c.sign(h) for c in cpus]
    try:
        with pytest.raises(DispatchTimeout) as caught:
            t.aggregate_signatures(sigs, [c.pub_key for c in cpus])
    finally:
        release.set()
    assert not caught.value.injected
    assert t.breaker.status()["total_failures"] == 0


def test_breaker_status_serves_cooldown_remaining():
    clock = FakeClock()
    b = CircuitBreaker(failure_threshold=1, cooldown_s=5.0, clock=clock)
    st = b.status()
    assert st["last_failure_reason"] == ""
    assert st["cooldown_remaining_s"] == 0.0
    b.record_failure("verify_batch: DispatchTimeout")
    clock.t += 2.0
    st = b.status()
    assert st["state"] == "open"
    assert st["last_failure_reason"] == "verify_batch: DispatchTimeout"
    assert st["cooldown_remaining_s"] == pytest.approx(3.0)
    clock.t += 3.1
    assert b.allow()  # half-open probe
    b.record_success()
    st = b.status()
    assert st["cooldown_remaining_s"] == 0.0  # closed: no countdown
    assert st["last_failure_reason"] != ""    # sticky: forensics


# -- the breaker copy against the JAX package's ---------------------------------

@pytest.mark.parametrize("seed", [1, 2, 3])
def test_breaker_copy_matches_the_reference(seed):
    """The port's CircuitBreaker and the JAX package's, driven by one
    seeded sequence of calls, agree on every answer and status."""
    rng = random.Random(seed)
    clocks = FakeClock(), FakeClock()
    ours = breaker.CircuitBreaker(failure_threshold=3, cooldown_s=5.0,
                                  clock=clocks[0])
    ref = jbreaker.CircuitBreaker(failure_threshold=3, cooldown_s=5.0,
                                  clock=clocks[1])
    for _ in range(300):
        op = rng.choice(["allow", "success", "failure", "tick", "inject",
                         "clear", "raise"])
        arg = rng.uniform(0.0, 4.0)
        outs = []
        for b, clock, fault in ((ours, clocks[0], breaker.InjectedDeviceFault),
                                (ref, clocks[1], jbreaker.InjectedDeviceFault)):
            if op == "allow":
                outs.append(b.allow())
            elif op == "success":
                b.record_success()
            elif op == "failure":
                b.record_failure("x: RuntimeError")
            elif op == "tick":
                clock.t += arg
            elif op == "inject":
                b.inject_faults(arg, min_faults=int(arg))
            elif op == "clear":
                b.clear_injected_faults()
            else:
                try:
                    b.raise_if_injected("p")
                    outs.append(False)
                except fault:
                    outs.append(True)
            outs.append(b.status())
        assert outs[:len(outs) // 2] == outs[len(outs) // 2:], op
