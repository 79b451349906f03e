"""The port's MeshSupervisor (consensus_overlord_tpu_torch/parallel/
supervisor.py) held against the JAX package's: one stub provider, one
fake clock and one signal sequence per scenario of the JAX package's
ladder tests (tests/test_mesh_resilience.py TestSupervisorLadder) walk
both ladders, and every rung, quarantine, apply_mesh_rung call, statusz()
document, metric sample and flightrec event must be the same.  Each
scenario also asserts the JAX test's own expectations, on both.
Tolerance: none (exact)."""

from types import SimpleNamespace

import pytest

from consensus_overlord_tpu import obs as ref_obs
from consensus_overlord_tpu.crypto import breaker as ref_breaker
from consensus_overlord_tpu.obs import flightrec as ref_flightrec
from consensus_overlord_tpu.parallel import supervisor as ref_supervisor
from consensus_overlord_tpu_torch.crypto import breaker
from consensus_overlord_tpu_torch.obs import flightrec, metrics
from consensus_overlord_tpu_torch.parallel import supervisor

KITS = {
    "port": SimpleNamespace(
        sup=supervisor, DeviceLossError=breaker.DeviceLossError,
        Metrics=metrics.Metrics, snapshot=metrics.snapshot,
        FlightRecorder=flightrec.FlightRecorder),
    "jax": SimpleNamespace(
        sup=ref_supervisor, DeviceLossError=ref_breaker.DeviceLossError,
        Metrics=ref_obs.Metrics, snapshot=ref_obs.snapshot,
        FlightRecorder=ref_flightrec.FlightRecorder),
}


class FakeClock:
    def __init__(self):
        self.t = 1000.0

    def __call__(self):
        return self.t


class StubProvider:
    """Duck-typed provider: records apply_mesh_rung calls."""

    def __init__(self, lanes=8, fail_rungs=()):
        self._lanes = lanes
        self.fail_rungs = set(fail_rungs)
        self.applied = []

    def mesh_device_names(self):
        return [f"sim:{i}" for i in range(self._lanes)]

    def apply_mesh_rung(self, rung, quarantined):
        if rung in self.fail_rungs:
            raise RuntimeError(f"rebuild of {rung} failed")
        self.applied.append((rung, tuple(quarantined)))


def _sup(kit, provider=None, **kw):
    clock = FakeClock()
    kw.setdefault("step_threshold", 2)
    kw.setdefault("probe_successes", 2)
    kw.setdefault("probe_cooldown_s", 5.0)
    provider = provider or StubProvider()
    return kit.sup.MeshSupervisor(provider, clock=clock, **kw), clock, \
        provider


def _state(sup, provider):
    return (sup.rung, sup.quarantined_devices(), sup.statusz(),
            list(provider.applied))


def rung_order(kit):
    assert kit.sup.RUNGS == ("full_mesh", "sub_mesh", "single_chip",
                             "host_oracle")
    return [kit.sup.RUNGS]


def attributed_loss(kit):
    sup, _, provider = _sup(kit)
    e = kit.DeviceLossError("sim:5")
    sup.record_failure("verify_batch", e)
    trace = [_state(sup, provider)]
    assert sup.rung == "full_mesh"  # below threshold
    sup.record_failure("verify_batch", e)
    assert sup.rung == "sub_mesh"
    assert sup.quarantined_devices() == ["sim:5"]
    assert provider.applied == [("sub_mesh", ("sim:5",))]
    return trace + [_state(sup, provider)]


def success_resets_streak(kit):
    sup, _, provider = _sup(kit)
    sup.record_failure("verify_batch", kit.DeviceLossError("sim:1"))
    sup.record_success()
    sup.record_failure("verify_batch", kit.DeviceLossError("sim:1"))
    assert sup.rung == "full_mesh"  # streak broken: never 2 in a row
    return [_state(sup, provider)]


def unattributed_failure(kit):
    sup, _, provider = _sup(kit)
    for _ in range(2):
        sup.record_failure("aggregate", RuntimeError("wedged"))
    assert sup.rung == "single_chip"
    assert sup.quarantined_devices() == []
    return [_state(sup, provider)]


def straggler_attribution(kit):
    class Straggler:
        @staticmethod
        def flagged_devices():
            return ["sim:3"]

    sup, _, provider = _sup(kit, straggler=Straggler())
    for _ in range(2):
        sup.record_failure("verify_batch", RuntimeError("slow"))
    assert sup.rung == "sub_mesh"
    assert sup.quarantined_devices() == ["sim:3"]
    return [_state(sup, provider)]


def full_down_and_up(kit):
    sup, clock, provider = _sup(kit)
    trace = []

    def down(exc):
        for _ in range(2):
            sup.record_failure("verify_batch", exc)
        trace.append(_state(sup, provider))

    down(kit.DeviceLossError("sim:5"))
    assert sup.rung == "sub_mesh"
    down(RuntimeError("wedged"))
    assert sup.rung == "single_chip"
    down(RuntimeError("wedged"))
    assert sup.rung == "host_oracle"
    down(RuntimeError("still dead"))
    assert sup.rung == "host_oracle"  # the bottom rung holds
    # Probe successes inside the dwell window do not promote.
    sup.record_success()
    sup.record_success()
    assert sup.rung == "host_oracle"
    clock.t += 5.1
    for want in ("single_chip", "sub_mesh", "full_mesh"):
        sup.record_success()
        sup.record_success()
        trace.append(_state(sup, provider))
        assert sup.rung == want
    assert sup.quarantined_devices() == []
    assert [r for r, _ in provider.applied] == [
        "sub_mesh", "single_chip", "host_oracle", "single_chip",
        "sub_mesh", "full_mesh"]
    st = sup.statusz()
    assert st["rung"] == "full_mesh"
    assert st["transitions"] == 6
    assert [t["reason"] for t in st["recent"][-3:]] == ["probe"] * 3
    return trace


def host_oracle_probe_per_cooldown(kit):
    sup, clock, provider = _sup(kit)
    for _ in range(6):
        sup.record_failure("verify_batch", RuntimeError("dead"))
    assert sup.rung == "host_oracle"
    gates = [sup.allow_device(), sup.allow_device()]
    clock.t += 5.1
    gates.append(sup.allow_device())
    assert gates == [True, False, True]
    sup2, _, _ = _sup(kit)
    assert sup2.allow_device() and sup2.allow_device()
    return [gates, _state(sup, provider)]


def failed_rebuild(kit):
    sup, _, provider = _sup(kit, StubProvider(fail_rungs={"sub_mesh"}))
    for _ in range(2):
        sup.record_failure("verify_batch", kit.DeviceLossError("sim:2"))
    assert sup.rung == "single_chip"
    assert sup.statusz()["recent"][-1]["reason"].startswith(
        "rebuild_failed")
    return [_state(sup, provider)]


def too_few_survivors(kit):
    sup, _, provider = _sup(kit, StubProvider(lanes=2))
    for _ in range(2):
        sup.record_failure("verify_batch", kit.DeviceLossError("sim:0"))
    assert sup.rung == "single_chip"  # 1 survivor is not a mesh
    return [_state(sup, provider)]


def metered_and_recorded(kit):
    m = kit.Metrics()
    rec = kit.FlightRecorder(capacity=16)
    sup, _, provider = _sup(kit, metrics=m, recorder=rec)
    for _ in range(2):
        sup.record_failure("verify_batch", kit.DeviceLossError("sim:4"))
    scraped = kit.snapshot(m.registry)
    assert scraped[
        "mesh_ladder_transitions_total{from=full_mesh,"
        "reason=verify_batch: DeviceLossError,to=sub_mesh}"] == 1.0
    assert scraped["mesh_quarantined_devices"] == 1.0
    clock_keys = ("ts", "mono", "seq")
    events = [{k: v for k, v in e.items() if k not in clock_keys}
              for e in rec.tail(16)]
    assert "ladder_transition" in [e["kind"] for e in events]
    mesh = {k: v for k, v in scraped.items() if k.startswith("mesh_")}
    return [_state(sup, provider), mesh, events]


SCENARIOS = [rung_order, attributed_loss, success_resets_streak,
             unattributed_failure, straggler_attribution, full_down_and_up,
             host_oracle_probe_per_cooldown, failed_rebuild,
             too_few_survivors, metered_and_recorded]


@pytest.mark.parametrize("scenario", SCENARIOS,
                         ids=[s.__name__ for s in SCENARIOS])
def test_supervisor_walks_as_the_jax_one(scenario):
    got = scenario(KITS["port"])
    want = scenario(KITS["jax"])
    assert got == want
