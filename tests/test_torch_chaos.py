"""The chaos and soak lanes of the port (sim/chaos.py, the harness's
crash/restart hooks, SharedFrontier.inject_stall, SimDeviceCrypto's
chaos hooks and sim/run.py's chaos, soak and tenant flags), held against
the JAX package: the same seed gives the same schedule event for event,
and the port's runs meet the JAX package's acceptance checks on the CPU
(simhash validators; one BLS12-381 provider on CudaBlsCrypto's CPU
twin).  Tolerance: none (schedules, verdicts and counters are exact)."""

import asyncio
import dataclasses
import json
import os
import subprocess
import sys
from types import SimpleNamespace

import pytest
import torch

from consensus_overlord_tpu.crypto.provider import CpuBlsCrypto
from consensus_overlord_tpu.sim.chaos import ChaosSchedule as JaxSchedule
from consensus_overlord_tpu_torch.crypto.cuda_provider import CudaBlsCrypto
from consensus_overlord_tpu_torch.crypto.provider import (
    SimDeviceCrypto,
    SimHashCrypto,
)
from consensus_overlord_tpu_torch.crypto.tenancy import SharedFrontier
from consensus_overlord_tpu_torch.engine.wal import FileWal
from consensus_overlord_tpu_torch.obs.metrics import Metrics
from consensus_overlord_tpu_torch.parallel.supervisor import MeshSupervisor
from consensus_overlord_tpu_torch.sim import (
    ChaosEvent,
    ChaosRunner,
    ChaosSchedule,
    SimNetwork,
)
from consensus_overlord_tpu_torch.sim import run as sim_run

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run(coro, timeout=90):
    return asyncio.run(asyncio.wait_for(coro, timeout))


def _cli(*args, timeout=120):
    """python -m consensus_overlord_tpu_torch.sim.run with no card."""
    env = dict(os.environ, PYTHONPATH=REPO, CUDA_VISIBLE_DEVICES="")
    return subprocess.run(
        [sys.executable, "-m", "consensus_overlord_tpu_torch.sim.run",
         *args], capture_output=True, text=True, timeout=timeout, cwd=REPO,
        env=env)


# -- the schedule ----------------------------------------------------------------

def test_seed7_schedule_matches_golden_fixture():
    """The pinned seed-7 schedule (tests/data/chaos_schedule_seed7.json,
    the JAX package's golden fixture) replays event for event."""
    with open(os.path.join(REPO, "tests", "data",
                           "chaos_schedule_seed7.json")) as f:
        golden = json.load(f)
    sched = ChaosSchedule.generate(
        golden["seed"], heights=golden["heights"],
        n_validators=golden["n_validators"], crashes=golden["crashes"],
        stalls=golden["stalls"], partitions=golden["partitions"],
        byzantine=golden["byzantine"],
        device_faults=golden["device_faults"])
    assert [dataclasses.asdict(e) for e in sched.events] == golden["events"]


#: (heights, validators, keyword counts): every event kind, the mesh
#: kinds included, at the acceptance run's fleet size and a small one.
_GRID = [
    (8, 100, dict(device_faults=1, adaptive=1, tenant_floods=1)),
    (14, 4, dict(byzantine=2, device_faults=1, adaptive=2, tenant_floods=1,
                 tenant_stalls=1, device_losses=2, dcn_stalls=1,
                 behaviors=["forger", "withholder"], byz_window=3)),
    (3, 7, dict(crashes=9, stalls=2, partitions=2, byzantine=3,
                device_faults=2, device_losses=1, dcn_stalls=2,
                mesh_lanes=3, downtime_s=0.1, window_s=0.2,
                device_window_s=0.3, tenant_window_s=0.4,
                mesh_window_s=0.5)),
]


@pytest.mark.parametrize("seed", [0, 7, 11, 10014])
@pytest.mark.parametrize("heights, validators, kw", _GRID)
def test_schedule_equals_the_jax_package(seed, heights, validators, kw):
    """ChaosSchedule.generate draws as the JAX package's does, call for
    call: the same events for the same seed, every kind included."""
    port = ChaosSchedule.generate(seed, heights, validators, **kw)
    jax_ = JaxSchedule.generate(seed, heights, validators, **kw)
    assert [dataclasses.asdict(e) for e in port.events] == [
        dataclasses.asdict(e) for e in jax_.events]
    assert [dataclasses.asdict(e) for e in port.shift(40).events] == [
        dataclasses.asdict(e) for e in jax_.shift(40).events]


def test_new_kinds_never_perturb_legacy_event_timing():
    """The append-only draw order: a schedule that adds adaptive,
    tenant and mesh events keeps every legacy event at its height and
    target, and the added draws are themselves deterministic."""
    kw = dict(heights=14, n_validators=4, crashes=2, stalls=1,
              partitions=1, byzantine=2, device_faults=1)
    legacy = ChaosSchedule.generate(7, **kw).events
    grown = ChaosSchedule.generate(
        7, **kw, adaptive=2, tenant_floods=1, tenant_stalls=1,
        device_losses=1, dcn_stalls=1).events
    assert grown[:len(legacy)] == legacy
    extras = grown[len(legacy):]
    assert [e.kind for e in extras] == [
        "adaptive", "adaptive", "tenant_flood", "tenant_stall",
        "device_loss", "dcn_stall"]
    assert all(e.behavior == "adaptive" for e in extras[:2])
    assert all(2 <= e.at_height <= 13 for e in extras)
    assert grown == ChaosSchedule.generate(
        7, **kw, adaptive=2, tenant_floods=1, tenant_stalls=1,
        device_losses=1, dcn_stalls=1).events


@pytest.mark.parametrize("kind", ["device_loss", "dcn_stall"])
def test_runner_fires_mesh_events(kind):
    """A mesh event fires through the target provider's hook: a call in
    the window fails over to the host with the exact verdict and walks
    the provider's MeshSupervisor down (a named lane quarantined for
    device_loss, the single-chip rung for dcn_stall); a clean call after
    the window climbs it back, and drain finds it at full_mesh.  The
    summary carries the window and the transitions."""
    async def main():
        base = SimHashCrypto(b"\x05" * 32)
        prov = SimDeviceCrypto(base)
        sup = MeshSupervisor(prov, step_threshold=1, probe_successes=1,
                             probe_cooldown_s=0.0)
        prov.attach_supervisor(sup)
        node = SimpleNamespace(crypto=prov, recorder=None)
        net = SimpleNamespace(controller=SimpleNamespace(on_new_height=[]),
                              nodes=[node, node])
        ev = ChaosEvent(2, kind, node=1, duration_s=0.2,
                        device=3 if kind == "device_loss" else -1)
        runner = ChaosRunner(net, ChaosSchedule([ev]))
        runner._on_height(2)
        await asyncio.gather(*list(runner._tasks))
        h = base.hash(b"block")
        sig = base.sign(h)
        pk = base.pub_key
        assert prov.verify_batch([sig, b"\x00" * len(sig)], [h, h],
                                 [pk, pk]) == [True, False]  # in the window
        down = "sub_mesh" if kind == "device_loss" else "single_chip"
        assert sup.rung == down
        await asyncio.sleep(0.25)  # the window ends
        assert prov.verify_signature(sig, h, base.pub_key)
        await runner.drain(timeout=5)
        assert sup.rung == "full_mesh"
        s = runner.summary()
        assert s["events_fired"] == 1
        if kind == "device_loss":
            assert s["device_losses"] == [
                {"node": 1, "device": 3, "duration_s": 0.2}]
            assert s["ladder_transitions"][0]["quarantined"] == ["sim:3"]
        else:
            assert s["dcn_stalls"] == [{"node": 1, "duration_s": 0.2}]
        assert [(t["from"], t["to"]) for t in s["ladder_transitions"]] == [
            ("full_mesh", down), (down, "full_mesh")]
        assert runner.ladder_supervisors == [sup]
    run(main())


# -- the runs --------------------------------------------------------------------

def test_chaos_run_reconverges_with_zero_violations(tmp_path):
    """Seeded crash-restart of 2 validators from their FileWals, a
    controller stall and a partition flip: the chain reaches its target
    with no safety violation, and every crashed node commits again after
    its restart."""
    async def main():
        heights = 8
        wal_dir = str(tmp_path / "wals")
        net = SimNetwork(
            n_validators=4, block_interval_ms=30,
            crypto_factory=lambda i: SimHashCrypto(bytes([i + 1]) * 32),
            wal_factory=lambda i: FileWal(f"{wal_dir}/node{i}"),
            flight_recorder_capacity=128)
        net.start(init_height=1)
        schedule = ChaosSchedule.generate(
            11, heights=heights, n_validators=4, crashes=2, stalls=1,
            partitions=1, downtime_s=0.15, window_s=0.15)
        chaos = ChaosRunner(net, schedule)
        try:
            for h in range(1, heights + 1):
                await net.run_until_height(h, timeout=30)
            await chaos.drain()
            # Post-fault runway: everyone participates again.
            await net.run_until_height(net.controller.latest_height + 2,
                                       timeout=30)
            await asyncio.sleep(0.2)
        except Exception:
            print(net.dump_flight_recorders(32))
            raise
        assert not net.controller.violations
        assert chaos.summary()["events_fired"] == 4
        crashed = [e.node for e in schedule.events if e.kind == "crash"]
        assert len(set(crashed)) == 2
        for i in crashed:
            name = net.nodes[i].name
            revived = [h for node, h, _ in net.controller.commit_log
                       if node == name]
            assert revived and max(revived) > heights, (
                f"crashed node {i} never committed after restart")
        await net.stop()
    run(main())


def test_device_fault_on_the_bls_provider_behind_a_shared_frontier():
    """A chaos device_fault window on the shared frontier's provider, a
    CudaBlsCrypto on the CPU with sim.run's fast-cooldown breaker: the
    breaker opens, every verdict meanwhile comes from the host oracle and
    equals the JAX package's CpuBlsCrypto, and after the window a clean
    device round closes the breaker again."""
    torch.set_num_threads(1)
    metrics = Metrics()
    shared = sim_run.shared_provider(
        lambda i: CudaBlsCrypto(0x1000 + 7919 * i, device="cpu",
                                device_threshold=2,
                                qc_device_threshold=10**9), metrics)
    assert isinstance(shared, CudaBlsCrypto)
    assert shared.breaker.cooldown_s == 0.25
    signers = [CpuBlsCrypto(0x1000 + 7919 * i) for i in range(3)]
    h = b"\x31" * 32
    sigs = [c.sign(h) for c in signers]
    pks = [c.pub_key for c in signers]
    # Lane 2 carries lane 0's signature: False on every path.
    batch = [(sigs[0], pks[0]), (sigs[1], pks[1]), (sigs[0], pks[2])]
    want = [signers[0].verify_signature(s, h, v) for s, v in batch]
    assert want == [True, True, False]

    async def main():
        core = SharedFrontier(shared, max_batch=64, linger_s=0.005,
                              metrics=metrics)
        lane = core.register("v-0")
        net = SimpleNamespace(
            controller=SimpleNamespace(on_new_height=[]),
            nodes=[SimpleNamespace(crypto=shared, recorder=None)],
            shared_frontier=core)
        runner = ChaosRunner(net, ChaosSchedule(
            [ChaosEvent(2, "device_fault", node=0, duration_s=0.2)]))
        runner._on_height(2)
        await asyncio.sleep(0)
        assert shared.breaker.fault_injected

        async def one_batch():
            return list(await asyncio.gather(
                *(lane.verify(s, h, v) for s, v in batch)))

        got = [await one_batch() for _ in range(4)]
        assert shared.breaker.times_opened >= 1
        await asyncio.sleep(0.35)  # the window and the cooldown pass
        got.append(await one_batch())  # the half-open probe: on the device
        await runner.drain()
        core.close()
        return got, runner.summary()

    got, summary = run(main(), timeout=120)
    assert all(g == want for g in got)
    assert shared.breaker.state == "closed"
    assert summary["device_faults_fired"] == 1
    assert summary["device_faults_effective"] == 1
    status = shared.degraded_status()
    assert status["calls"]["verify_batch"]["host"] >= 1
    assert status["calls"]["verify_batch"]["device"] >= 1
    assert status["total_failures"] >= 3


def test_breaker_ignores_successes_admitted_before_the_window():
    """record_success(epoch) of a call admitted before the latest fault
    window neither resets the failure count nor closes the breaker; a
    call admitted after it counts, and no epoch means the JAX package's
    behaviour."""
    from consensus_overlord_tpu_torch.crypto.breaker import (
        CircuitBreaker,
        InjectedDeviceFault,
    )

    clock = SimpleNamespace(t=0.0)
    b = CircuitBreaker(failure_threshold=3, cooldown_s=1.0,
                       clock=lambda: clock.t)
    stale = b.raise_if_injected("p")
    b.inject_faults(0.0, min_faults=3)
    for k in range(3):
        with pytest.raises(InjectedDeviceFault):
            b.raise_if_injected("p")
        b.record_failure("p: InjectedDeviceFault")
        b.record_success(stale)  # a stale success between the faults
    assert b.state == "open" and b.times_opened == 1
    assert not b.fault_injected
    b.record_success(stale)
    assert b.state == "open"
    clock.t += 1.0
    assert b.allow()  # the half-open probe, admitted under the window
    b.record_success(b.raise_if_injected("p"))
    assert b.state == "closed"
    b.record_failure("p: x")
    b.record_success()
    assert b.status()["consecutive_failures"] == 0


def test_device_fault_opens_the_breaker_past_an_inflight_qc_verify():
    """A QC verify dispatched before a device_fault window and resolved
    cleanly inside it says nothing of the device under the fault: its
    success must not reset the failure count, so the window's min_faults
    (the breaker's threshold) still opens the breaker.  The window here is
    0 s long, so only min_faults keeps it armed; verdicts stay exact."""
    torch.set_num_threads(1)
    metrics = Metrics()
    shared = sim_run.shared_provider(
        lambda i: CudaBlsCrypto(0x1000 + 7919 * i, device="cpu",
                                device_threshold=10**9,
                                qc_device_threshold=2), metrics)
    signers = [CpuBlsCrypto(0x1000 + 7919 * i) for i in range(3)]
    h = b"\x52" * 32
    pks = [c.pub_key for c in signers]
    agg = signers[0].aggregate_signatures([c.sign(h) for c in signers], pks)
    shared.update_pubkeys(pks)
    net = SimpleNamespace(
        controller=SimpleNamespace(on_new_height=[]),
        nodes=[SimpleNamespace(crypto=shared, recorder=None)],
        shared_frontier=SimpleNamespace(_provider=shared))
    runner = ChaosRunner(net, ChaosSchedule(
        [ChaosEvent(2, "device_fault", node=0, duration_s=0.0)]))
    qc = (agg, h, pks)

    async def main():
        inflight = shared.verify_aggregated_async(*qc)
        runner._on_height(2)
        await asyncio.sleep(0)
        assert shared.breaker.fault_injected
        got = [shared.verify_aggregated_signature(*qc)]
        got.append(inflight())  # the clean call dispatched before
        got += [shared.verify_aggregated_signature(*qc) for _ in range(2)]
        assert shared.breaker.times_opened == 1
        assert not shared.breaker.fault_injected  # the quota is spent
        await asyncio.sleep(0.3)  # the cooldown passes
        got.append(shared.verify_aggregated_signature(*qc))
        await runner.drain()
        return got

    verdicts = run(main(), timeout=120)
    assert verdicts == [True] * 5
    assert shared.breaker.state == "closed"
    assert runner.device_faults_effective == 1
    status = shared.degraded_status()
    # The three faulted calls fell back on the host; the call in flight
    # and the half-open probe ran on the device.
    assert status["total_failures"] == 3
    assert status["calls"]["verify_aggregated"] == {"device": 2, "host": 0}


def test_host_qc_fallback_uses_the_cached_keys():
    """The QC host path (the degraded window of a device_fault, and QCs
    below the device threshold): it sums the voters' cached points, an
    unseen voter's key validated into the cache first, instead of
    re-checking each key, and its verdicts equal the JAX package's
    CpuBlsCrypto on a valid QC, the wrong hash, a key cached as bad, an
    unseen voter, a malformed or non-canonical signature, a duplicated
    voter and no voters."""
    signers = [CpuBlsCrypto(0x1000 + 7919 * i) for i in range(5)]
    h = b"\x42" * 32
    sigs = [c.sign(h) for c in signers]
    pks = [c.pub_key for c in signers]
    bad_key = b"\xa0" + b"\x00" * 95  # x = 0 is off the curve: cached bad
    prov = CudaBlsCrypto(0x1000, device="cpu", device_threshold=10**9,
                         qc_device_threshold=10**9)
    prov.update_pubkeys(pks[:4] + [bad_key])
    agg = signers[0].aggregate_signatures(sigs[:4], pks[:4])
    agg2 = signers[0].aggregate_signatures(sigs[:2] + sigs[:1],
                                           pks[:2] + pks[:1])
    cases = [(agg, h, pks[:4]), (agg, b"\x43" * 32, pks[:4]),
             (agg, h, pks[:3] + [bad_key]), (agg2, h, pks[:2] + pks[:1]),
             (agg, h, pks[:3] + [pks[4]]), (b"\x00" * 48, h, pks[:4]),
             (agg[:-1], h, pks[:4]), (agg, h, [])]
    want = [signers[0].verify_aggregated_signature(a, m, v)
            for a, m, v in cases]
    assert want[0] and want[3] and not any(want[1:3] + want[4:])
    cached = prov._cpu.verify_aggregated_signature
    seen = []
    prov._cpu.verify_aggregated_signature = lambda *a: (
        seen.append(a), cached(*a))[1]
    got = [prov.verify_aggregated_signature(a, m, v) for a, m, v in cases]
    assert got == want
    # No QC went through CpuBlsCrypto; the unseen voter is cached now.
    assert seen == []
    assert prov._pk.index[pks[4]] >= 0


def test_shared_frontier_stall_holds_batches_until_the_window_ends():
    """SharedFrontier.inject_stall (chaos tenant_stall): a composed batch
    waits out the window before its dispatch, and the window reads as
    armed until then."""
    prov = SimDeviceCrypto(SimHashCrypto(b"\x05" * 32))
    h = b"\x07" * 32
    sig = prov.sign(h)

    async def main():
        core = SharedFrontier(prov, max_batch=8, linger_s=0.001)
        lane = core.register("t")
        core.inject_stall(0.3)
        assert core.stall_injected
        loop = asyncio.get_running_loop()
        t0 = loop.time()
        ok = await lane.verify(sig, h, prov.pub_key)
        waited = loop.time() - t0
        core.close()
        return ok, waited, core.stall_injected

    ok, waited, armed = run(main())
    assert ok and waited >= 0.25 and not armed


def test_soak_chaos_cli_end_to_end(tmp_path):
    """The --soak-chaos surface through the CLI at smoke length:
    recurring seeded cycles against a SharedFrontier fleet, telemetry
    sampled throughout, the drift gate evaluated, and a
    soak-chaos-survival record that loads through the port's ledger."""
    from consensus_overlord_tpu_torch.obs import ledger

    record = tmp_path / "soak_record.json"
    samples = tmp_path / "samples.jsonl"
    out = _cli("--validators", "4", "--heights", "2", "--interval-ms", "40",
               "--crypto", "simhash", "--device", "cpu", "--chaos",
               "--seed", "5", "--chaos-crashes", "1", "--chaos-stalls", "0",
               "--chaos-partitions", "0", "--chaos-adaptive", "1",
               "--chaos-tenant-floods", "1", "--shared-frontier",
               "--soak-chaos", "--soak-seconds", "6",
               "--sample-every", "0.5",
               "--soak-out", str(samples), "--soak-record", str(record),
               # warm-up RSS growth over a 6-s window is all slope; the
               # gate under test is the plumbing, not the ceiling values
               "--soak-max-rss-slope-mb", "512")
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-2000:]
    lines = [ln for ln in out.stdout.splitlines() if ln.startswith("{")]
    rec = json.loads(lines[0])  # the soak record line
    summary = json.loads(lines[-1])
    assert rec["metric"] == "soak-chaos-survival"
    assert rec["unit"] == "heights/s" and rec["value"] > 0
    assert rec["soak"]["safety_violations"] == 0
    assert rec["soak"]["chaos_cycles"] >= 1
    assert rec["drift_failures"] == []
    assert "torch" in rec["env"] and "jax" not in rec["env"]
    sc = summary["soak_chaos"]
    assert sc["soak_heights"] > 0
    assert summary["chaos"]["safety_violations"] == 0
    assert summary["adversary"].get("adaptive_switch", 0) > 0
    floods = [f for c in sc["cycles"] for f in c["tenant_floods"]]
    assert floods and all(f["sheds"] > 0 for f in floods), floods
    assert all(f["rejected"] == f["sent"] for f in floods)
    # Each cycle keeps its fired events at their heights, inside the
    # cycle's span of the chain.
    for c in sc["cycles"]:
        assert len(c["events"]) == c["events_fired"]
        assert all(c["from_height"] < e["fired_height"] <= c["to_height"]
                   for e in c["events"]), c
    assert summary["telemetry"]["samples"] >= 5
    assert summary["frontier_batches"] > 0  # rode the shared core
    assert summary["frontier_shared"] is True
    loaded = ledger.load_record(json.load(open(record)), run="soak")
    assert loaded.soak["commit_rate_heights_per_s"] > 0
    assert samples.exists() and samples.read_text().count("\n") >= 5


def test_liveness_failure_dump_includes_telemetry_trend():
    """A run that misses its height exits 2 and dumps the telemetry
    trend beside the flight recorders and the chaos summary: 2
    validators cannot survive a crash (no quorum while one is down)."""
    out = _cli("--validators", "2", "--heights", "4", "--interval-ms", "40",
               "--crypto", "simhash", "--chaos", "--seed", "3",
               "--chaos-crashes", "2", "--chaos-stalls", "0",
               "--chaos-partitions", "0", "--chaos-downtime-ms", "30000",
               "--sample-every", "0.5", "--timeout", "4")
    assert out.returncode == 2, (out.returncode, out.stderr[-800:])
    assert "LIVENESS FAILURE" in out.stderr
    assert "telemetry trend:" in out.stderr
    assert "chaos summary:" in out.stderr


@pytest.mark.parametrize("flag", ["--chaos-device-losses",
                                  "--chaos-dcn-stalls"])
def test_mesh_chaos_flags_need_chaos(flag):
    """A mesh chaos count without --chaos is a usage error (exit 2), as
    in the JAX package."""
    out = _cli("--crypto", "simhash", flag, "1")
    assert out.returncode == 2
    assert "need --chaos" in out.stderr


def test_seeded_mesh_chaos_run_exits_zero():
    """The JAX package's seeded mesh chaos run (tests/test_mesh_resilience
    .py TestMeshChaosRun): device_loss and dcn_stall windows on the shared
    frontier's SimDeviceCrypto.  The fleet commits every height with no
    safety violation, the fired events (kind, height, node, lane) are the
    JAX package's schedule for the seed, and the ladder is back at
    full_mesh with a down-and-up walk in its history."""
    argv = ["--validators", "4", "--heights", "6", "--interval-ms", "40",
            "--crypto", "simhash", "--chaos", "--seed", "7",
            "--chaos-crashes", "0", "--chaos-stalls", "0",
            "--chaos-partitions", "0", "--chaos-device-losses", "2",
            "--chaos-dcn-stalls", "1", "--chaos-mesh-window-ms", "300",
            "--shared-frontier"]
    out = _cli(*argv)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-2000:]
    summary = json.loads(out.stdout.splitlines()[-1])
    chaos = summary["chaos"]
    assert chaos["safety_violations"] == 0
    args = sim_run.make_parser().parse_args(argv)
    behaviors, n_byzantine = sim_run.chaos_behaviors(args)
    want = JaxSchedule.generate(
        args.seed, args.heights, args.validators,
        crashes=args.chaos_crashes, stalls=args.chaos_stalls,
        partitions=args.chaos_partitions, byzantine=n_byzantine,
        device_faults=args.chaos_device_faults, behaviors=behaviors,
        byz_window=args.chaos_byz_window,
        downtime_s=args.chaos_downtime_ms / 1000.0,
        window_s=args.chaos_window_ms / 1000.0,
        device_window_s=args.chaos_device_window_ms / 1000.0,
        adaptive=args.chaos_adaptive,
        tenant_floods=args.chaos_tenant_floods,
        tenant_stalls=args.chaos_tenant_stalls,
        tenant_window_s=args.chaos_tenant_window_ms / 1000.0,
        device_losses=args.chaos_device_losses,
        dcn_stalls=args.chaos_dcn_stalls,
        mesh_window_s=args.chaos_mesh_window_ms / 1000.0)
    key = (lambda kind, at, node, device:  # noqa: E731
           (kind, at, node, device if kind == "device_loss" else None))
    assert sorted(key(e["kind"], e["at_height"], e["node"], e.get("device"))
                  for e in chaos["events"]) == sorted(
        key(e.kind, e.at_height, e.node, e.device) for e in want.events)
    assert chaos["events_fired"] == 3
    assert len(chaos["device_losses"]) == 2
    assert len(chaos["dcn_stalls"]) == 1
    supervisors = summary["ladder"]["supervisors"]
    assert {s["rung"] for s in supervisors} == {"full_mesh"}
    reasons = [t["reason"] for s in supervisors for t in s["recent"]]
    assert "probe" in reasons and any(r != "probe" for r in reasons)


def test_cuda_chaos_without_a_card_exits_nonzero():
    """--device cuda with no GPU: the providers' constructors raise and
    nothing falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = _cli("--crypto", "bls", "--device", "cuda", "--validators", "4",
               "--heights", "1", "--chaos", "--chaos-device-faults", "1",
               "--shared-frontier")
    assert out.returncode != 0
    assert "torch.cuda.is_available() is False" in out.stderr
    assert "height 1 committed" not in out.stdout
