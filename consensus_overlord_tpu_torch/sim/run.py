"""CLI entry for the simulation harness, on the port's providers.

    python -m consensus_overlord_tpu_torch.sim.run --crypto bls --validators 64

Runs an in-process validator fleet until the target height, printing per-
height commit latency and a one-line JSON summary: consensus_overlord_tpu/
sim/run.py's main, with its argument names and defaults.  Every node
verifies on its own device provider behind a batching frontier (or, with
``--shared-frontier``, through its tenant lane on one shared core), on
the card unless ``--device cpu`` asks for the CPU (the kernels' plain
versions); with no GPU the providers' constructors raise and the run
exits non-zero.  The schemes are the JAX package's five: ``ed25519``
(the default; Ed25519CudaCrypto, seeds 0x4000 + 7919·i), ``bls``
(CudaBlsCrypto, the reference's keys 0x1000 + 7919·i), ``secp256k1`` and
``sm2`` (Secp256k1Crypto and Sm2Crypto, keys 0x2000 and 0x3000 + 7919·i),
and ``simhash``, the dependency-free sim-grade provider.  The
breaker-less providers run inside SimDeviceCrypto, whose frontier keeps
a device error as a fault: the run exits 3.

The chaos lane (``--chaos``, sim/chaos.py): a seeded schedule of
crash-restarts from per-node FileWals, controller stalls, partitions,
Byzantine and adaptive adversaries, device faults (the breaker's injected
window; on a shared frontier, the shared provider's breaker) and tenant
floods and stalls on the shared frontier; the run then asserts zero
safety violations and that every active fault was caught
(``_assert_adversarial``).  The soak lane (``--soak-seconds``,
``--soak-chaos``) keeps the fleet committing, under recurring shifted
chaos cycles with ``--soak-chaos``, samples telemetry drift, gates it
(exit 3 on a breach) and writes a ledger record (obs/ledger.py).
``--critpath-out``, ``--statusz-port``, ``--profile-dir`` (torch.profiler
captures, obs/prof.py ProfileSession) and ``--straggler-ratio`` are the
JAX package's observability flags.  The mesh chaos events
(``--chaos-device-losses``, ``--chaos-dcn-stalls``) attach a
MeshSupervisor (parallel/supervisor.py) to the shared provider, or to
every node's, and the run asserts that every ladder they walked came back
to ``full_mesh`` (the summary's ``ladder`` block, /statusz "ladder").
"""

from __future__ import annotations

import argparse
import asyncio
import json
import logging
import sys
import time

#: Validator count at which runs default onto the batching frontier:
#: at fleet scale the per-message host verify path is not the
#: production shape (--no-frontier overrides).
FLEET_FRONTIER_MIN = 16

#: Fleet-scale fabric defaults: at this many validators the sim fabric
#: shards (sim/router.py ShardedRouter) and, when --interval-ms was left
#: at its default, the base round timer scales with fleet size: a 100 ms
#: timer that n=4 meets easily is a choke/view-change storm at n=1000.
FLEET_SHARD_MIN = 256
FLEET_DEFAULT_SHARDS = 8


def sum_status(docs) -> dict:
    """Sum providers' degraded_status() documents: numbers add, a bool
    counts the providers where it is true, a string counts providers by
    value, a nested dict sums the same way; None is skipped."""
    out: dict = {}
    for doc in docs:
        for key, v in doc.items():
            if v is None:
                continue
            if isinstance(v, dict):
                out[key] = sum_status([out.get(key, {}), v])
            elif isinstance(v, bool):
                out[key] = out.get(key, 0) + int(v)
            elif isinstance(v, (int, float)):
                out[key] = out.get(key, 0) + v
            else:
                counts = out.setdefault(key, {})
                counts[str(v)] = counts.get(str(v), 0) + 1
    return out


def _assert_adversarial(metrics, chaos, snapshot, net) -> None:
    """Chaos acceptance beyond safety+liveness: every active adversary
    behavior must have been CAUGHT (nonzero rejection counters for its
    signature reasons; the withholder must have actually withheld
    traffic — chokes alone can come from other chaos events), and an
    injected device fault must have driven the breaker through a full
    open -> half_open -> closed cycle.  Nothing to assert when the
    schedule had no such events."""
    from .adversary import REJECTION_REASONS

    scraped = snapshot(metrics.registry)
    summary = chaos.summary()
    # With the batching frontier on, invalid-signature traffic (the
    # forger's fabricated-identity votes) is dropped at the frontier
    # before the engine's non_validator guard can see it — but it is
    # still COUNTED, under bad_sig_frontier (engine/smr.py).
    frontier_on = any(n.frontier is not None for n in net.nodes)
    for behavior in summary["behaviors_active"]:
        if behavior == "adaptive":
            # Which tactics fired depends on observed state; the
            # deterministic obligation is that the adversary actually
            # ADAPTED (shim-side tactic-switch tally, surviving
            # crash-restarts like the other behavior stats).
            switches = sum(
                n.adversary.behavior_stats.get("adaptive_switch", 0)
                for n in net.nodes)
            assert switches > 0, (
                "adaptive adversary active but no tactic switch "
                "recorded")
            continue
        reasons = REJECTION_REASONS[behavior]
        if not reasons:  # withholder: silence, not forgeries
            withheld = sum(
                n.adversary.behavior_stats.get("adversary_withhold", 0)
                for n in net.nodes)
            assert withheld > 0, (
                "withholder active but nothing was withheld")
            continue
        for reason in reasons:
            if frontier_on and reason == "non_validator":
                # Provider-dependent disposition: a sim-grade
                # signature from a fabricated identity may verify
                # (SimHashCrypto — the engine then counts
                # non_validator) or fail at the frontier (real
                # schemes — counted as bad_sig_frontier).  Either
                # way the fabricated vote must have been counted
                # SOMEWHERE.
                counted = (scraped.get(
                    "consensus_byzantine_rejections_total"
                    "{reason=non_validator}", 0)
                    + scraped.get(
                        "consensus_byzantine_rejections_total"
                        "{reason=bad_sig_frontier}", 0))
                assert counted > 0, (
                    "forger active with the frontier on but neither "
                    "non_validator nor bad_sig_frontier ticked")
                continue
            count = scraped.get(
                "consensus_byzantine_rejections_total"
                f"{{reason={reason}}}", 0)
            if behavior == "replayer" and count == 0:
                # Replay detection races the randomized resend delays
                # against height progression: a duplicate landing after
                # the fleet moved on (or at a peer that never accepted
                # the original) is dropped silently as an honest
                # straggler.  The deterministic obligation is shim-side
                # — duplicates actually left the adversary.
                replayed = sum(
                    n.adversary.behavior_stats.get("adversary_replay", 0)
                    for n in net.nodes)
                assert replayed > 0, (
                    "replayer active but nothing was replayed")
                print("warning: replayer duplicates all landed outside "
                      "the detection window (timing); shim sent "
                      f"{replayed} replay volleys", file=sys.stderr)
                continue
            assert count > 0, (
                f"behavior {behavior} active but rejection counter "
                f"{reason!r} stayed zero")
    # Fleet-scale evidence: while an adversary window was armed on a
    # frontier-riding fleet, the batched pipeline must have kept
    # flushing device batches — rejection floods rode the real path,
    # not a per-message host loop.
    marks = [m for m in summary.get("frontier_marks", [])
             if m["batches_at_disarm"] is not None]
    if frontier_on and marks:
        deltas = [m["batches_at_disarm"] - m["batches_at_arm"]
                  for m in marks]
        assert any(d > 0 for d in deltas), (
            f"adversary windows armed on a frontier fleet but no "
            f"device batch flushed during any window: {marks}")
    # Tenant chaos: every flood must have engaged admission control
    # (sheds > 0 — overflow went to the host oracle, not the floor)
    # and its invalid signatures must have been rejected.
    for flood in summary.get("tenant_floods", []):
        assert flood["sheds"] > 0, (
            f"tenant_flood on {flood['tenant']} never shed "
            f"(sent={flood['sent']}) — the admission bound did not "
            f"engage")
        assert flood["rejected"] > 0, (
            f"tenant_flood on {flood['tenant']} sent {flood['sent']} "
            f"invalid verifies but none were rejected")
    # Mesh chaos: every ladder a device_loss/dcn_stall window actually
    # drove must have RECOVERED — final rung back at full_mesh, with a
    # step-down and a probe step-up in its history (the down-AND-up
    # self-healing cycle).  A window no device call ever hit (sub-
    # threshold path) fires no transition; warn, don't fail.
    if summary.get("device_losses") or summary.get("dcn_stalls"):
        walked = [s for s in chaos.ladder_supervisors
                  if s.statusz()["transitions"]]
        if not walked:
            print("warning: mesh chaos window(s) armed but no ladder "
                  "transition fired (no device call hit the window?)",
                  file=sys.stderr)
        for sup in walked:
            st = sup.statusz()
            assert st["rung"] == "full_mesh", (
                f"mesh ladder stuck at {st['rung']!r} after drain "
                f"(quarantined={st['quarantined']}): {st['recent']}")
            downs = [t for t in st["recent"] if t["reason"] != "probe"]
            ups = [t for t in st["recent"] if t["reason"] == "probe"]
            assert downs and ups, (
                f"mesh chaos fired but the ladder history shows no "
                f"down-and-up cycle: {st['recent']}")
    if summary["device_faults_fired"]:
        if chaos.device_faults_effective == 0:
            # The window never bit: this crypto path made no device
            # calls at all (a provider below its batch threshold
            # early-outs to the host before raise_if_injected), so no
            # open->closed cycle can exist and asserting one would fail
            # a healthy run.  Say so loudly instead.
            print("warning: device_fault window(s) armed but no device "
                  "call ever hit them (sub-threshold device path?); "
                  "breaker-cycle assertion skipped", file=sys.stderr)
            return
        for to in ("open", "half_open", "closed"):
            count = scraped.get(
                f"crypto_breaker_transitions_total{{to={to}}}", 0)
            assert count > 0, (
                f"device faults fired but no breaker transition to "
                f"{to!r} recorded")
        # The transition counters above prove the cycle happened at some
        # point; a breaker left stuck OPEN at run end — recovery that
        # never completed — must fail the run too.  Only windows that
        # actually bit are held to it (an idle window leaves its breaker
        # closed trivially, and _settle_breakers already cleared
        # leftovers).
        for b, _, injected0 in chaos._breakers:
            if b.total_injected > injected0:
                assert b.state == "closed", (
                    f"device_fault breaker finished {b.state!r}, not "
                    f"re-closed: {b.status()}")


def make_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="in-process consensus fleet on the port's providers")
    parser.add_argument("--validators", type=int, default=4)
    parser.add_argument("--heights", "--target-height", type=int, default=5,
                        dest="heights",
                        help="commit this many heights (--target-height "
                        "is an alias)")
    parser.add_argument("--interval-ms", type=int, default=100)
    parser.add_argument("--shards", type=int, default=0,
                        help="sim fabric shards (sim/router.py "
                        "ShardedRouter); 0 = auto "
                        f"({FLEET_DEFAULT_SHARDS} at "
                        f">={FLEET_SHARD_MIN} validators, else 1)")
    parser.add_argument("--shard-workers", choices=("inline", "thread"),
                        default="inline",
                        help="per-shard pump workers: 'inline' (asyncio "
                        "tasks on the main loop, deterministic) or "
                        "'thread' (one worker thread per shard)")
    parser.add_argument("--drop-rate", type=float, default=0.0)
    parser.add_argument("--seed", type=int, default=0,
                        help="router RNG seed (drop/delay schedule); also "
                        "the default chaos seed")
    parser.add_argument("--chaos", action="store_true",
                        help="run a seeded ChaosSchedule against the "
                        "fleet: crash-restart validators from their "
                        "FileWals mid-run, stall the controller, flip a "
                        "partition — then assert the chain still reached "
                        "--heights with zero safety violations")
    parser.add_argument("--chaos-seed", type=int, default=None,
                        help="chaos schedule seed (default: --seed)")
    parser.add_argument("--chaos-crashes", type=int, default=2)
    parser.add_argument("--chaos-stalls", type=int, default=1)
    parser.add_argument("--chaos-partitions", type=int, default=1)
    parser.add_argument("--chaos-byzantine", type=int, default=0,
                        help="Byzantine adversary windows on the "
                        "schedule: a live validator's outbound traffic "
                        "is mutated by a behavior (sim/adversary.py) "
                        "for a few heights, never exceeding "
                        "f=(n-1)//3 faulty nodes concurrently with "
                        "crashes.  Behaviors round-robin through "
                        "equivocator/forger/replayer/withholder "
                        "unless per-behavior counts are given; the "
                        "run then ALSO asserts nonzero "
                        "byzantine-rejection counters for each "
                        "active behavior")
    parser.add_argument("--chaos-equivocators", type=int, default=0)
    parser.add_argument("--chaos-forgers", type=int, default=0)
    parser.add_argument("--chaos-replayers", type=int, default=0)
    parser.add_argument("--chaos-withholders", type=int, default=0)
    parser.add_argument("--chaos-adaptive", type=int, default=0,
                        help="adaptive adversary windows: the armed "
                        "node SWITCHES tactics on observed engine "
                        "state (withhold only when about to lead, "
                        "equivocate only holding a lock, replay "
                        "hardest in view-change storms; honest "
                        "otherwise); the run then also asserts nonzero "
                        "tactic-switch counters")
    parser.add_argument("--chaos-tenant-floods", type=int, default=0,
                        help="tenant_flood events: a flood task pumps "
                        "invalid-signature verify bursts past the "
                        "target tenant's queue bound on the fleet's "
                        "SharedFrontier (needs --shared-frontier, "
                        "auto-enabled), overflow shedding to the host "
                        "oracle")
    parser.add_argument("--chaos-tenant-stalls", type=int, default=0,
                        help="tenant_stall events: the SharedFrontier "
                        "device path stalls for the window; bounded "
                        "queues must shed to the host oracle so the "
                        "chain keeps committing")
    parser.add_argument("--chaos-tenant-window-ms", type=float,
                        default=800.0,
                        help="tenant_flood / tenant_stall window length")
    parser.add_argument("--chaos-device-faults", type=int, default=0,
                        help="device_fault events: the target's crypto "
                        "circuit breaker (on a shared frontier, the "
                        "shared provider's) fails every device dispatch "
                        "for the window, so breaker-open -> host-oracle "
                        "fallback -> half-open recovery runs inside the "
                        "schedule; the run then also asserts a full "
                        "open/half_open/closed transition cycle in "
                        "metrics")
    parser.add_argument("--chaos-device-losses", type=int, default=0,
                        help="device_loss events: a mesh lane of the "
                        "target crypto (on a shared frontier, the shared "
                        "provider's) is lost for the window; the "
                        "MeshSupervisor quarantines it and rebuilds a "
                        "survivor sub-mesh, and the run asserts the "
                        "ladder climbed back to full_mesh")
    parser.add_argument("--chaos-dcn-stalls", type=int, default=0,
                        help="dcn_stall events: the target crypto's "
                        "device calls wedge past the dispatch watchdog "
                        "for the window (DispatchTimeout, exact host "
                        "re-verify), walking the same ladder")
    parser.add_argument("--chaos-mesh-window-ms", type=float,
                        default=800.0,
                        help="device_loss / dcn_stall window length")
    parser.add_argument("--chaos-byz-window", type=int, default=None,
                        help="heights an adversary stays armed "
                        "(default: max(2, min(--validators, 12)), so "
                        "leader-dependent behaviors get their turn)")
    parser.add_argument("--chaos-downtime-ms", type=float, default=400.0,
                        help="crash-to-restart window per crash event")
    parser.add_argument("--chaos-window-ms", type=float, default=400.0,
                        help="controller-fault / partition window length")
    parser.add_argument("--chaos-device-window-ms", type=float,
                        default=600.0,
                        help="device fault-injection window length")
    parser.add_argument("--crypto",
                        choices=["ed25519", "bls", "secp256k1", "sm2",
                                 "simhash"],
                        default="ed25519",
                        help="the signature scheme: votes and QCs past "
                        "--device-threshold are verified by the port's "
                        "kernels (ed25519: Ed25519CudaCrypto, bls: "
                        "CudaBlsCrypto, secp256k1 / sm2: Secp256k1Crypto "
                        "/ Sm2Crypto); 'simhash' is the dependency-free "
                        "sim-grade provider (NOT real crypto), the chaos "
                        "lane's choice where the engine's fault machinery "
                        "is the thing under test")
    parser.add_argument("--device", choices=["cuda", "cpu"],
                        default="cuda",
                        help="where the providers of every scheme but "
                        "simhash run their device paths: the card, or "
                        "the kernels' plain PyTorch versions on the CPU. "
                        " With no GPU, 'cuda' fails; nothing falls back "
                        "to the CPU")
    parser.add_argument("--frontier", action="store_true",
                        help="verify inbound signatures at the batching "
                        "frontier (always on for the device schemes: "
                        "the device path needs coalesced batches and "
                        "off-loop dispatch).  Auto-enabled at fleet "
                        f"scale (>= {FLEET_FRONTIER_MIN} validators)")
    parser.add_argument("--no-frontier", action="store_true",
                        help="force per-message host verify even at "
                        "fleet scale (simhash only; incompatible with "
                        "--shared-frontier)")
    parser.add_argument("--shared-frontier", action="store_true",
                        help="every validator feeds ONE SharedFrontier "
                        "core (crypto/tenancy.py) through its own "
                        "tenant lane instead of a private "
                        "BatchingVerifier — the multi-tenant admission/"
                        "fairness machinery under consensus traffic; "
                        "the core wraps one provider of the chosen "
                        "scheme.  Required (and auto-enabled) by "
                        "--chaos-tenant-*")
    parser.add_argument("--tenant-queue-bound", type=int, default=512,
                        help="per-tenant pending bound on the shared "
                        "frontier (arrivals over it shed to the host "
                        "oracle); sized well below the single-tenant "
                        "default so chaos floods engage admission "
                        "control at CI length")
    parser.add_argument("--frontier-linger-ms", type=float, default=2.0)
    parser.add_argument("--dispatch-deadline-s", type=float, default=None,
                        help="watchdog deadline for each blocking device "
                        "call of the bls providers (rung-scaled; the "
                        "other schemes have no watchdog).  "
                        "Default: CONSENSUS_DISPATCH_DEADLINE_S, else "
                        "off")
    parser.add_argument("--device-threshold", type=int, default=8,
                        help="batch size at which the providers ship "
                        "work to the device instead of the host oracle "
                        "(also their QC threshold)")
    parser.add_argument("--timeout", type=float, default=120.0)
    parser.add_argument("--critpath-out", default=None, metavar="PATH",
                        help="write the causal commit tracer's Perfetto/"
                        "Chrome-trace JSON here at run end, with the "
                        "embedded 'critpath' payload (obs/causal.py; the "
                        "tracer itself is always on: the summary's "
                        "'critpath' block and the /statusz 'commits' "
                        "section cost nothing extra)")
    parser.add_argument("--statusz-port", type=int, default=None,
                        help="serve /metrics + /statusz on this port for "
                        "the duration of the run (0 = OS-assigned)")
    parser.add_argument("--profile-dir", default=None,
                        help="capture torch.profiler traces into this "
                        "directory (obs/prof.py ProfileSession; node 0's "
                        "engine drives the round-boundary cadence — the "
                        "profiler is process-wide).  The staged round "
                        "profiles in the JSON summary are independent "
                        "of this and always on")
    parser.add_argument("--profile-every-n-rounds", type=int, default=0,
                        help="with --profile-dir: capture a one-round "
                        "trace at every Nth round (0 = capture the "
                        "first round only)")
    parser.add_argument("--soak-seconds", type=float, default=0.0,
                        help="after the target height, keep the fleet "
                        "committing until this much wall-clock has "
                        "passed since start, with the telemetry "
                        "sampler recording drift (WAL size, flightrec "
                        "churn, RSS, occupancy) the whole way")
    parser.add_argument("--sample-every", type=float, default=10.0,
                        help="telemetry sampling interval in seconds "
                        "(obs/telemetry.py TelemetrySampler)")
    parser.add_argument("--soak-out", default=None,
                        help="JSONL path for the telemetry time series "
                        "(default with --soak-seconds: "
                        "soak_samples.jsonl; without it samples stay "
                        "in the in-memory window served at /statusz)")
    parser.add_argument("--soak-chaos", action="store_true",
                        help="the long-soak survival lane: after the "
                        "initial schedule, keep the fleet under "
                        "RECURRING seeded chaos cycles (each cycle a "
                        "fresh schedule from a derived seed, shifted "
                        "to the current height) until --soak-seconds "
                        "of SOAK time is spent, then gate the telemetry "
                        "drift rates (RSS slope, WAL growth, flight-"
                        "recorder drop rate, compile-cache ratio) and "
                        "emit one ledger soak BenchRecord.  Exit 3 on "
                        "a drift breach.  Needs --chaos and "
                        "--soak-seconds")
    parser.add_argument("--soak-cycle-heights", type=int, default=12,
                        help="heights each recurring soak-chaos "
                        "schedule spans")
    parser.add_argument("--soak-record", default="soak_record.json",
                        help="where --soak-chaos writes its ledger "
                        "BenchRecord (metric=soak-chaos-survival; "
                        "obs/ledger.py check gates WAL-growth/RSS-slope "
                        "regressions across soaks)")
    parser.add_argument("--soak-metric", default="soak-chaos-survival",
                        help="ledger metric name for the soak "
                        "BenchRecord — lanes with different fleet "
                        "shapes must trend separately (ledger "
                        "comparability is keyed on metric+unit)")
    parser.add_argument("--soak-max-rss-slope-mb", type=float,
                        default=4.0,
                        help="drift gate: max RSS slope over the "
                        "sample window, MB/s (<= 0 disables)")
    parser.add_argument("--soak-max-wal-growth-mb", type=float,
                        default=4.0,
                        help="drift gate: max summed WAL growth rate, "
                        "MB/s (<= 0 disables)")
    parser.add_argument("--soak-max-flightrec-drop-rate", type=float,
                        default=50000.0,
                        help="drift gate: max flight-recorder eviction "
                        "rate, events/s (<= 0 disables; rings evict "
                        "routinely once full — this catches runaway "
                        "churn, not steady state)")
    parser.add_argument("--soak-min-cache-ratio", type=float,
                        default=0.0,
                        help="drift gate: min compile-cache hit ratio "
                        "at soak end (0 disables)")
    parser.add_argument("--soak-max-commit-latency-drift", type=float,
                        default=3.0,
                        help="drift gate: max second-half/first-half "
                        "p50 commit-latency ratio over the causal "
                        "tracer's window (obs/causal.py) — a chain "
                        "whose commits keep getting slower is leaking "
                        "capacity even when RSS and WAL stay flat "
                        "(<= 0 disables)")
    parser.add_argument("--soak-max-alerts", type=int, default=None,
                        help="alert gate: fail the soak (exit 3, like a "
                        "drift breach) when the anomaly layer "
                        "(obs/anomaly.py) raised more than this many "
                        "alerts by soak end (omit to disable; 0 = any "
                        "alert fails)")
    parser.add_argument("--soak-inject-alerts", type=int, default=0,
                        help="raise this many synthetic alerts before "
                        "the gate runs — the alert-storm fixture that "
                        "proves --soak-max-alerts actually gates")
    parser.add_argument("--straggler-ratio", type=float, default=1.5,
                        help="straggler detection threshold: flag a "
                        "device whose rolling-median stage time exceeds "
                        "the mesh median by this ratio (obs/fleet.py; "
                        "one card has no peer to compare, so it never "
                        "flags there; <= 0 disables the detector)")
    parser.add_argument("--flightrec", type=int, default=256,
                        help="per-node flight-recorder capacity (events); "
                        "rings are dumped if the run times out.  0 = off")
    parser.add_argument("--prewarm", action="store_true",
                        help="run one batch through every device path "
                        "at every rung the fleet can hit before the fleet "
                        "starts (crypto/warm.py), so the kernels' build "
                        "and first touch stay out of the measured "
                        "heights (every scheme but simhash)")
    parser.add_argument("-v", "--verbose", action="store_true")
    return parser


def crypto_factory(args):
    """Node i's provider (the keys of the JAX package's sim.run)."""
    if args.crypto == "bls":
        from ..crypto.cuda_provider import CudaBlsCrypto

        return lambda i: CudaBlsCrypto(  # noqa: E731
            0x1000 + 7919 * i, device=args.device,
            device_threshold=args.device_threshold,
            dispatch_deadline_s=args.dispatch_deadline_s)
    if args.crypto == "ed25519":
        from ..crypto.ed25519_cuda import Ed25519CudaCrypto

        return lambda i: Ed25519CudaCrypto(  # noqa: E731
            (0x4000 + 7919 * i).to_bytes(32, "big"), device=args.device,
            device_threshold=args.device_threshold)
    if args.crypto in ("secp256k1", "sm2"):
        from ..crypto.ecdsa_cuda import Secp256k1Crypto, Sm2Crypto

        cls = Secp256k1Crypto if args.crypto == "secp256k1" else Sm2Crypto
        base = 0x2000 if args.crypto == "secp256k1" else 0x3000
        return lambda i: cls(  # noqa: E731
            base + 7919 * i, device=args.device,
            device_threshold=args.device_threshold)
    from ..crypto.provider import SimHashCrypto

    return lambda i: SimHashCrypto(  # noqa: E731
        (0x5000 + 7919 * i).to_bytes(32, "big"))


def shared_provider(factory, metrics):
    """The one provider behind a shared frontier: factory(10**7), with a
    fast-cooldown breaker (sim chains commit every tens of ms, so a
    half-open probe must come up within a run).  A provider with its own
    breaker (CudaBlsCrypto) gets that breaker in place of its default; a
    breaker-less one runs inside SimDeviceCrypto, as in the JAX package.
    Verification in every provider depends only on (sig, hash, voter), so
    one instance serves every tenant."""
    from ..crypto.breaker import CircuitBreaker
    from ..crypto.provider import SimDeviceCrypto

    base = factory(10**7)
    breaker = CircuitBreaker(failure_threshold=3, cooldown_s=0.25,
                             metrics=metrics)
    if getattr(base, "breaker", None) is None:
        return SimDeviceCrypto(base, breaker=breaker, metrics=metrics)
    base.breaker = breaker
    base.bind_metrics(metrics)
    return base


def chaos_behaviors(args):
    """(behaviors, n_byzantine): per-behavior counts override the
    round-robin --chaos-byzantine assignment; naming any behavior
    explicitly defines the full set.  behaviors=None lets
    ChaosSchedule.generate apply its own round-robin default."""
    explicit = (["equivocator"] * args.chaos_equivocators
                + ["forger"] * args.chaos_forgers
                + ["replayer"] * args.chaos_replayers
                + ["withholder"] * args.chaos_withholders)
    return (explicit or None,
            len(explicit) if explicit else args.chaos_byzantine)


def shared_frontier_on(args) -> bool:
    """Tenant chaos attacks the multi-tenant core: a fleet that doesn't
    ride one has nothing to attack, so tenant events turn it on."""
    return bool(args.shared_frontier or args.chaos_tenant_floods
                or args.chaos_tenant_stalls)


async def run(args, factory, use_frontier: bool, shards: int,
              on_start=None) -> dict:
    """Drive the fleet to args.heights (then through the chaos runway and
    the soak, where asked); returns the JSON summary.  A height missed
    within args.timeout is a liveness failure (exit 2), a device fault
    kept by a node's frontier a device failure (exit 3): the flight
    recorders, the chaos summary, the router counters and the telemetry
    trend go to stderr first.  on_start(net, statusz_port), when given,
    is called once the fleet has started (an in-process caller's view of
    the live fleet)."""
    import tempfile

    from ..obs import ledger
    from ..obs.anomaly import AnomalyDetector
    from ..obs.causal import CommitTracer
    from ..obs.fleet import FleetAggregator, StragglerDetector
    from ..obs.metrics import Metrics, snapshot
    from ..obs.prof import DeviceProfiler, ProfileSession
    from ..obs.telemetry import TelemetrySampler, drift_check, wal_size_bytes
    from . import SimNetwork

    byz_behaviors, n_byzantine = chaos_behaviors(args)
    metrics = Metrics()
    # Causal commit tracer: one shared instance for the whole fleet
    # (the shared instance is the cross-node trace-context channel) —
    # pure clock reads, zero RNG draws, so the seed contract is
    # untouched.
    causal = CommitTracer(metrics=metrics)
    # Staged round profiles ride every run (the "profile" block in the
    # JSON summary); torch.profiler capture only when --profile-dir
    # names a destination.
    profiler = DeviceProfiler(metrics)
    session = ProfileSession(args.profile_dir, args.profile_every_n_rounds)
    wal_tmp = None
    wal_factory = None
    if args.chaos:
        # Durable per-node WALs: crash-restart must recover through the
        # framed FileWal load path, not an in-memory stand-in.
        from ..engine.wal import FileWal

        wal_tmp = tempfile.TemporaryDirectory(prefix="chaos_wal_")
        wal_factory = lambda i: FileWal(  # noqa: E731
            f"{wal_tmp.name}/node{i}", metrics=metrics)
    shared_core = None
    shared = None
    frontier_factory = None
    if shared_frontier_on(args):
        # One device core for the whole fleet: every validator registers
        # a tenant lane keyed on its pubkey, so a crash-restarted node
        # re-registers INTO its existing lane (SharedFrontier.register is
        # idempotent by tenant id).
        from ..crypto.tenancy import SharedFrontier

        shared = shared_provider(factory, metrics)
        shared.bind_profiler(profiler)
        shared_core = SharedFrontier(
            shared, max_batch=1024,
            linger_s=args.frontier_linger_ms / 1000.0, metrics=metrics)
        frontier_factory = lambda crypto: shared_core.register(  # noqa: E731
            "v-" + crypto.pub_key[:4].hex(),
            queue_bound=args.tenant_queue_bound)
    net = SimNetwork(n_validators=args.validators,
                     block_interval_ms=args.interval_ms,
                     seed=args.seed,
                     drop_rate=args.drop_rate, crypto_factory=factory,
                     use_frontier=use_frontier,
                     frontier_linger_s=args.frontier_linger_ms / 1000.0,
                     metrics=metrics,
                     flight_recorder_capacity=args.flightrec,
                     wal_factory=wal_factory,
                     # Breaker-less providers get the simulated device
                     # path; CudaBlsCrypto has its own breaker and is
                     # left as it is.
                     sim_device_crypto=True,
                     profiler=profiler,
                     frontier_factory=frontier_factory,
                     shared_frontier=shared_core,
                     shards=shards,
                     shard_workers=args.shard_workers,
                     causal=causal)
    # Soak telemetry: sample the fleet's drift axes on a cadence.
    # Collectors dereference net.nodes at sample time (chaos
    # crash-restarts swap node objects mid-run); WAL bytes sum the
    # whole fleet so per-node growth can't hide in an average.
    soak_out = args.soak_out
    if soak_out is None and args.soak_seconds > 0:
        soak_out = "soak_samples.jsonl"
    sampler = TelemetrySampler(
        metrics=metrics,
        interval_s=args.sample_every,
        out_path=soak_out,
        wal_size_fn=lambda: sum(
            wal_size_bytes(n.wal) or 0 for n in net.nodes),
        recorders_fn=lambda: [n.recorder for n in net.nodes],
        breaker_status_fn=getattr(shared if shared is not None
                                  else net.nodes[0].crypto,
                                  "degraded_status", None),
        profiler=profiler)
    # Fleet observability (obs/fleet.py + obs/anomaly.py): the straggler
    # detector rides the profiler's per-device stage samples, the
    # anomaly detector rides every telemetry sample, and the fleet
    # aggregator merges this process's trend in single-process
    # degenerate mode.  Node 0's recorder survives chaos crash-restarts
    # (the harness carries it across), so straggler/alert events stay
    # findable.
    event_recorder = net.nodes[0].recorder
    straggler = None
    if args.straggler_ratio > 0:
        straggler = StragglerDetector(metrics=metrics,
                                      recorder=event_recorder,
                                      ratio=args.straggler_ratio)
        profiler.attach_straggler(straggler)
    anomaly = AnomalyDetector(metrics=metrics, recorder=event_recorder,
                              straggler=straggler)
    sampler.add_observer(anomaly.observe_sample)
    fleet = FleetAggregator("sim", sampler.trend)
    # Mesh resilience (parallel/supervisor.py): a ladder supervisor on
    # every provider that can host one when the schedule carries mesh
    # events.  Sim providers walk the ladder as bookkeeping (no kernel
    # sets to swap); a CudaBlsCrypto swaps its kernel sets.  Fast probe
    # cadence: sim chains commit every tens of ms, so the down-AND-up
    # cycle must complete inside a run.
    supervisors = []
    if args.chaos_device_losses + args.chaos_dcn_stalls:
        from ..parallel.supervisor import MeshSupervisor

        def _attach_supervisor(provider):
            if not hasattr(provider, "attach_supervisor"):
                return
            sup = MeshSupervisor(provider, metrics=metrics,
                                 recorder=event_recorder,
                                 straggler=straggler, anomaly=anomaly,
                                 step_threshold=3, probe_successes=4,
                                 probe_cooldown_s=0.2)
            provider.attach_supervisor(sup)
            supervisors.append(sup)

        if shared_core is not None:
            _attach_supervisor(shared)
        else:
            for n in net.nodes:
                _attach_supervisor(n.crypto)
    statusz_port = None
    if args.statusz_port is not None:
        # The fleet shares one registry; statusz reports node 0's engine
        # (all nodes track the same chain) plus every ring.  Sources
        # dereference net.nodes[0] at scrape time: a chaos crash-restart
        # replaces the node object mid-run.
        metrics.add_status_source(
            "consensus", lambda: net.nodes[0].engine.status())
        metrics.add_status_source(
            "flightrec", lambda: (net.nodes[0].recorder.tail(64)
                                  if net.nodes[0].recorder else []))
        # Router delivery/drop counters + live partition state:
        # adversarial message loss must be attributable per run.
        metrics.add_status_source("router", net.router.stats)
        degraded = getattr(shared if shared is not None
                           else net.nodes[0].crypto, "degraded_status", None)
        if degraded is not None:
            metrics.add_status_source("crypto", degraded)
        metrics.add_status_source(
            "profile", lambda: {**profiler.statusz(),
                                "session": session.status()})
        # Drift over the retained sample window.
        metrics.add_status_source("trend", sampler.trend)
        # Causal commit-latency decomposition (obs/causal.py).
        metrics.add_status_source("commits", causal.statusz)
        if straggler is not None:
            metrics.add_status_source("mesh", straggler.statusz)
        metrics.add_status_source("alerts", anomaly.statusz)
        metrics.add_status_source("fleet", fleet.statusz)
        # Ladder state (rung, quarantine, transition history) of the
        # first supervisor: the one mesh chaos targets (the shared
        # provider's, or node 0's).
        if supervisors:
            metrics.add_status_source("ladder", supervisors[0].statusz)
        metrics.add_debug_handler(
            "/debug/profile",
            lambda q: session.request(int(q.get("rounds", "1"))))
        statusz_port = metrics.start_exporter(args.statusz_port,
                                              addr="127.0.0.1")
        print(f"statusz: http://127.0.0.1:{statusz_port}/statusz",
              flush=True)
    # Node 0's engine drives the capture cadence (the profiler is
    # process-wide — one session per process); without an explicit
    # cadence, capture the first committed round.
    net.nodes[0].engine.profile = session
    if session.available and args.profile_every_n_rounds == 0:
        session.request(1)
    sampler.start()  # baseline sample lands before the first height
    net.start(init_height=1)
    chaos = None
    chaos_seed = (args.chaos_seed if args.chaos_seed is not None
                  else args.seed)

    def make_schedule(seed: int, heights: int):
        from .chaos import ChaosSchedule

        return ChaosSchedule.generate(
            seed, heights, args.validators,
            crashes=args.chaos_crashes, stalls=args.chaos_stalls,
            partitions=args.chaos_partitions,
            byzantine=n_byzantine,
            device_faults=args.chaos_device_faults,
            behaviors=byz_behaviors,
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

    if args.chaos:
        from .chaos import ChaosRunner

        schedule = make_schedule(chaos_seed, args.heights)
        chaos = ChaosRunner(net, schedule)
        for ev in schedule.events:
            detail = ""
            if ev.kind == "crash":
                detail = f" (node {ev.node})"
            elif ev.kind in ("byzantine", "adaptive"):
                detail = f" ({ev.behavior}, {ev.heights} heights)"
            elif ev.kind in ("device_fault", "tenant_flood",
                             "dcn_stall"):
                detail = f" (node {ev.node}, {ev.duration_s:.1f}s)"
            elif ev.kind == "device_loss":
                detail = (f" (node {ev.node}, lane {ev.device}, "
                          f"{ev.duration_s:.1f}s)")
            elif ev.kind == "tenant_stall":
                detail = f" ({ev.duration_s:.1f}s)"
            print(f"chaos: {ev.kind} armed at height {ev.at_height}"
                  + detail)
    if on_start is not None:
        on_start(net, statusz_port)
    t0 = time.perf_counter()
    last = t0
    height_ms = []
    soak_cycles: list = []
    soak_heights = 0
    soak_wall_s = 0.0

    async def advance(h: int, label: str = "") -> None:
        """One height of progress.  A miss is a liveness failure — as
        load-bearing a red flag as a SafetyViolation — and a device fault
        a device failure: dump every flight recorder (the wedged,
        possibly adversarial, run must be diagnosable) and exit
        non-zero."""
        failure = None
        try:
            await net.run_until_height(h, timeout=args.timeout)
        except asyncio.TimeoutError:
            failure = (2, f"LIVENESS FAILURE: stuck at height "
                       f"{net.controller.latest_height}, wanted {h}"
                       f"{label} within {args.timeout}s")
        except RuntimeError as e:
            failure = (3, f"DEVICE FAILURE at height {h}{label}: {e}")
        if failure is None:
            return
        print(failure[1], file=sys.stderr)
        if args.flightrec:
            print(net.dump_flight_recorders(64), file=sys.stderr)
        if chaos is not None:
            print(f"chaos summary: {json.dumps(chaos.summary())}",
                  file=sys.stderr)
        print(f"router: {json.dumps(net.router.stats())}", file=sys.stderr)
        # The drift series belongs in the post-mortem: a soak that died
        # of a slow leak is only diagnosable from the telemetry trend,
        # not from flight recorders alone.
        print("telemetry trend: "
              + json.dumps(sampler.trend(), default=repr), file=sys.stderr)
        # Tear the fleet down before exiting: N live engine tasks dying
        # with the loop would spray task-destroyed warnings over the
        # forensic dump above.
        sampler.stop()
        if statusz_port is not None:
            metrics.stop_exporter()
        try:
            await net.stop()
        except Exception:  # noqa: BLE001 — exiting anyway
            pass
        if shared_core is not None:
            shared_core.close()
        raise SystemExit(failure[0])

    try:
        for h in range(1, args.heights + 1):
            await advance(h, f" (of {args.heights})")
            now = time.perf_counter()
            height_ms.append((now - last) * 1000)
            print(f"height {h} committed (+{height_ms[-1]:.1f} ms)",
                  flush=True)
            last = now
        # total_s / ms_per_height measure the TARGET heights only — the
        # schedule runway below commits extra heights and must not skew
        # timings compared across seeds (it gets its own runway_s).
        t_target = time.perf_counter()
        if chaos is not None:
            # Runway: a dense schedule (or f-bound deferrals) can leave
            # events unfired at the target height — keep committing
            # until the whole schedule has played out (every event
            # fired, every adversary window closed), bounded so a
            # starved event can't run us forever.
            runway_cap = net.controller.latest_height + \
                4 * len(schedule.events) + 8
            while ((chaos.pending_count or chaos.byzantine_armed
                    or chaos.inflight_count)
                   and net.controller.latest_height < runway_cap):
                await advance(net.controller.latest_height + 1,
                              " (schedule runway)")
            await chaos.drain()
            # The run's whole point: every injected fault recovered, the
            # chain reached its target, and no two nodes ever committed
            # different blocks at one height.
            assert not net.controller.violations, (
                f"safety violations: {net.controller.violations}")
            assert net.controller.latest_height >= args.heights
            _assert_adversarial(metrics, chaos, snapshot, net)
        if args.soak_seconds > 0:
            # Soak: hold the fleet committing until the wall-clock
            # budget is spent, one height at a time so a wedge is still
            # a diagnosed liveness failure, not a silent hang.
            soak_start_h = net.controller.latest_height
            soak_start_t = time.perf_counter()
            # The survival lane budgets the soak itself (at fleet scale
            # the initial schedule + runway can alone exceed a budget
            # measured from t0); the plain hold counts from t0.
            soak_deadline = ((soak_start_t if args.soak_chaos else t0)
                             + args.soak_seconds)
            if args.soak_chaos:
                # The survival lane: recurring seeded chaos cycles until
                # the budget is spent.  Each cycle derives a fresh
                # schedule (seed + cycle stride — still deterministic
                # for a given --seed) shifted to the chain's current
                # height, fires it to completion, drains, and asserts
                # safety before the next one.
                from .chaos import ChaosRunner

                if chaos is not None:
                    chaos.detach()  # the initial schedule is spent
                cycle = 0
                while time.perf_counter() < soak_deadline:
                    cycle += 1
                    base_h = net.controller.latest_height
                    sched = make_schedule(
                        chaos_seed + 10007 * cycle,
                        args.soak_cycle_heights).shift(base_h)
                    runner = ChaosRunner(net, sched)
                    cap = (base_h + args.soak_cycle_heights
                           + 4 * len(sched.events) + 8)
                    while ((runner.pending_count or runner.byzantine_armed
                            or runner.inflight_count)
                           and net.controller.latest_height < cap
                           and time.perf_counter() < soak_deadline):
                        await advance(net.controller.latest_height + 1,
                                      f" (soak-chaos cycle {cycle})")
                    await runner.drain()
                    runner.detach()
                    assert not net.controller.violations, (
                        f"safety violations in soak cycle {cycle}: "
                        f"{net.controller.violations}")
                    s = runner.summary()
                    soak_cycles.append({
                        "cycle": cycle,
                        "seed": chaos_seed + 10007 * cycle,
                        "from_height": base_h,
                        "to_height": net.controller.latest_height,
                        "events_fired": s["events_fired"],
                        "events_skipped": s["events_skipped"],
                        # The fired events at their heights, as the
                        # initial schedule's are under "chaos".
                        "events": s["events"],
                        "behaviors_active": s["behaviors_active"],
                        "tenant_floods": s["tenant_floods"],
                        "tenant_stalls": len(s["tenant_stalls"]),
                        "device_losses": len(s["device_losses"]),
                        "dcn_stalls": len(s["dcn_stalls"]),
                    })
            else:
                while time.perf_counter() < soak_deadline:
                    await advance(net.controller.latest_height + 1,
                                  " (soak)")
            soak_heights = net.controller.latest_height - soak_start_h
            soak_wall_s = time.perf_counter() - soak_start_t
    except Exception:
        if args.flightrec:
            print(net.dump_flight_recorders(64), file=sys.stderr)
        raise
    finally:
        if statusz_port is not None:
            metrics.stop_exporter()
    total = t_target - t0
    runway_s = time.perf_counter() - t_target
    # Final sample while the fleet is still live (WAL/recorder
    # collectors dereference nodes), then stop the cadence.
    sampler.stop(final_sample=True)
    # stop() unregisters every node — snapshot the router while the
    # fleet is still live so registered/partition state is truthful.
    router_stats = net.router.stats()
    # Per-tenant state must be read before teardown too.
    tenants_status = (shared_core.tenants_status()
                      if shared_core is not None else None)
    await net.stop()
    if shared_core is not None:
        # Lanes' close() is a no-op; the run owns the core.
        shared_core.close()
        await asyncio.sleep(0.05)  # let the shutdown drain resolve
    # A capture the run ended mid-window must still flush its trace; in
    # the common case the capture already closed at a round boundary,
    # so fall back to where that one landed.
    trace_dir = session.stop() or session.status()["last_capture_dir"]
    if wal_tmp is not None:
        wal_tmp.cleanup()
    srt = sorted(height_ms)

    def pct(q: float) -> float:
        return round(srt[min(len(srt) - 1, int(q * len(srt)))], 1)

    frontier = {}
    if shared_core is not None:
        s = shared_core.stats
        frontier = {
            "frontier_batches": s.batches,
            "frontier_mean_batch": round(s.mean_batch, 1),
            "frontier_max_batch": s.max_batch,
            "frontier_sheds": s.sheds,
            "frontier_reverified": s.reverified,
            "frontier_shared": True,
            "tenants": tenants_status,
        }
    else:
        stats = [n.frontier.stats for n in net.nodes
                 if getattr(n, "frontier", None) is not None]
        if stats:
            batches = sum(s.batches for s in stats)
            frontier = {
                "frontier_batches": batches,
                "frontier_mean_batch": round(
                    sum(s.requests for s in stats) / max(1, batches), 1),
                "frontier_max_batch": max(s.max_batch for s in stats),
                "frontier_reverified": sum(s.reverified for s in stats),
            }
    # Scrape the fleet's shared registry into the summary: count/sum
    # pairs are enough to reconstruct means; full bucket detail stays on
    # /metrics.
    scraped = snapshot(metrics.registry)
    obs = {k: v for k, v in scraped.items()
           if k.split("{", 1)[0].endswith(("_count", "_sum", "_total"))}
    status = [n.crypto.degraded_status() for n in net.nodes
              if hasattr(n.crypto, "degraded_status")]
    out = {
        "metric": "consensus-rounds",
        "validators": args.validators,
        "heights": args.heights,
        "shards": shards,
        "shard_workers": args.shard_workers,
        "crypto": args.crypto,
        "device": args.device if args.crypto != "simhash" else None,
        "total_s": round(total, 3),
        "runway_s": round(runway_s, 3),
        "ms_per_height": round(total * 1000 / args.heights, 1),
        "p50_ms": pct(0.50),
        "p95_ms": pct(0.95),
        "delivered": router_stats["delivered"],
        "dropped": router_stats["dropped"],
        "router": router_stats,
        **frontier,
        "metrics": obs,
        # Staged device profile: cumulative stage split per op,
        # last-batch occupancy, the recent per-call ring, and the
        # capture session's disposition (obs/prof.py).
        "profile": {**profiler.summary(),
                    "recent": profiler.tail(16),
                    "session": session.status(),
                    "trace_dir": trace_dir},
        # Every node's breaker and fallback counters, summed, and the
        # shared frontier's provider's own.
        "crypto_status": sum_status(status),
        # Soak telemetry disposition: how many samples landed and where,
        # plus the drift deltas over the retained window.
        "telemetry": {"samples": sampler.samples_taken,
                      "out_path": soak_out,
                      "soak_seconds": args.soak_seconds,
                      "trend": sampler.trend()},
        # The anomaly-alert tally and, when the straggler detector ran,
        # its per-device medians ("mesh").
        "alerts": anomaly.statusz(8),
        # Causal commit decomposition: rolling latency quantiles + mean
        # critical-path stage shares over the tracer's window.
        "critpath": causal.summary(),
    }
    if shared is not None:
        out["shared_crypto_status"] = shared.degraded_status()
    if args.critpath_out:
        with open(args.critpath_out, "w") as f:
            json.dump(causal.to_perfetto(), f)
        print(f"critpath: {out['critpath']['commits']} commit "
              f"traces -> {args.critpath_out}")
    if straggler is not None:
        out["mesh"] = straggler.statusz()
    if supervisors:
        # The ladders' disposition (the summary twin of /statusz
        # "ladder").
        out["ladder"] = {"supervisors": [s.statusz() for s in supervisors]}
    if chaos is not None:
        out["chaos"] = {
            "seed": chaos_seed,
            "safety_violations": len(net.controller.violations),
            **chaos.summary(),
        }
        rejections = {
            k.split("reason=", 1)[1].rstrip("}"): v
            for k, v in scraped.items()
            if k.startswith("consensus_byzantine_rejections_total{")}
        if rejections or n_byzantine or args.chaos_adaptive:
            out["byzantine"] = {
                "behaviors_active": out["chaos"]["behaviors_active"],
                "rejections": rejections,
            }
        # Shim-side adversary tallies summed across the fleet
        # (adaptive_switch / adaptive_<tactic> / adversary_*).
        adversary_stats: dict = {}
        for n in net.nodes:
            for k, v in n.adversary.behavior_stats.items():
                adversary_stats[k] = adversary_stats.get(k, 0) + v
        out["adversary"] = adversary_stats
    if args.soak_chaos:
        trend = out["telemetry"]["trend"]
        thresholds = {
            "max_rss_slope_bytes_per_s":
                (args.soak_max_rss_slope_mb * 1024 * 1024
                 if args.soak_max_rss_slope_mb > 0 else None),
            "max_wal_growth_bytes_per_s":
                (args.soak_max_wal_growth_mb * 1024 * 1024
                 if args.soak_max_wal_growth_mb > 0 else None),
            "max_flightrec_drop_per_s":
                (args.soak_max_flightrec_drop_rate
                 if args.soak_max_flightrec_drop_rate > 0 else None),
            "min_compile_cache_hit_ratio": args.soak_min_cache_ratio,
        }
        drift_failures = drift_check(trend, thresholds)
        # Commit-latency drift rides the same verdict as RSS/WAL growth:
        # a chain that keeps committing but ever slower is a capacity
        # leak the byte-counting gates can't see.
        latency_drift = causal.drift_ratio()
        if (args.soak_max_commit_latency_drift > 0
                and latency_drift is not None
                and latency_drift > args.soak_max_commit_latency_drift):
            drift_failures.append(
                f"commit latency p50 drift: second-half/first-half "
                f"ratio {latency_drift:.2f} exceeds "
                f"--soak-max-commit-latency-drift "
                f"{args.soak_max_commit_latency_drift}")
        # Synthetic alert storm: the fixture for the alert gate — raised
        # through the real raise_alert path so the counter, flightrec
        # event, and /statusz section all light up.
        for i in range(args.soak_inject_alerts):
            anomaly.raise_alert("synthetic_storm", index=i)
        if args.soak_max_alerts is not None and \
                anomaly.alert_count() > args.soak_max_alerts:
            drift_failures.append(
                f"alerts: {anomaly.alert_count()} raised exceeds "
                f"--soak-max-alerts {args.soak_max_alerts}")
        breaker_cycles = scraped.get(
            "crypto_breaker_transitions_total{to=closed}", 0)
        soak_dims = {k: v for k, v in {
            "rss_slope_bytes_per_s": trend.get("rss_slope_bytes_per_s"),
            "wal_growth_bytes_per_s": trend.get("wal_growth_bytes_per_s"),
            "flightrec_drop_per_s": trend.get("flightrec_drop_per_s"),
            "compile_cache_hit_ratio":
                trend.get("compile_cache_hit_ratio"),
            "commit_rate_heights_per_s":
                (round(soak_heights / soak_wall_s, 4)
                 if soak_wall_s > 0 else None),
            "commit_latency_p50_ms":
                (round(out["critpath"]["p50_ms"], 3)
                 if out["critpath"]["commits"] else None),
            "commit_latency_drift_ratio":
                (round(latency_drift, 4)
                 if latency_drift is not None else None),
            "breaker_cycles": breaker_cycles,
            "chaos_cycles": len(soak_cycles),
            "samples": sampler.samples_taken,
            "safety_violations": len(net.controller.violations),
            # Fleet-shape dims: ledger-gated (obs/ledger.py
            # SOAK_DIMENSIONS) so the survival lane can't quietly
            # shrink its fleet between records.
            "validators": args.validators,
            "shards": shards,
        }.items() if v is not None}
        out["soak_chaos"] = {
            "cycles": soak_cycles,
            "soak_heights": soak_heights,
            "soak_wall_s": round(soak_wall_s, 3),
            "thresholds": thresholds,
            "drift_failures": drift_failures,
            "soak": soak_dims,
            "record_path": args.soak_record,
            "alerts": anomaly.alert_count(),
            "max_alerts": args.soak_max_alerts,
        }
        # The survival BenchRecord: one ledger line per soak, so a trend
        # tracks commit rate and drift dims across runs and `check`
        # gates WAL-growth/RSS-slope regressions like perf regressions.
        soak_record = ledger.annotate({
            "metric": args.soak_metric,
            "value": soak_dims.get("commit_rate_heights_per_s", 0.0),
            "unit": "heights/s",
            "context": {
                "validators": args.validators,
                "shards": shards,
                "shard_workers": args.shard_workers,
                "seed": args.seed,
                "chaos_seed": chaos_seed,
                "soak_seconds": args.soak_seconds,
                "cycle_heights": args.soak_cycle_heights,
                "chaos_cycles": len(soak_cycles),
                "shared_frontier": shared_core is not None,
            },
            "soak": soak_dims,
            "drift_failures": drift_failures,
            "profile": profiler.summary(),
        })
        with open(args.soak_record, "w") as f:
            json.dump(soak_record, f, indent=2)
        print(json.dumps(soak_record))
        for failure in drift_failures:
            print(f"SOAK DRIFT FAILURE: {failure}", file=sys.stderr)
    return out


def main(argv=None, on_start=None) -> dict:
    """The CLI: parse, validate, build the providers, run the fleet and
    print the summary as a ledger line (obs/ledger.py annotate); returns
    the summary.  Exits 2 on a usage error or a missed height, 3 on a
    device failure, a host re-verify or a soak drift breach.  on_start:
    see run()."""
    from ..obs import ledger

    parser = make_parser()
    args = parser.parse_args(argv)
    logging.basicConfig(
        level=logging.DEBUG if args.verbose else logging.WARNING,
        format="%(asctime)s %(message)s")

    shards = args.shards
    if shards <= 0:
        shards = (FLEET_DEFAULT_SHARDS
                  if args.validators >= FLEET_SHARD_MIN else 1)
    if (args.validators >= FLEET_SHARD_MIN
            and args.interval_ms == parser.get_default("interval_ms")):
        # 4x headroom: a choke storm is only escapable while the capped
        # round backoff exceeds the cost of one full choke round.
        args.interval_ms = max(args.interval_ms, 4 * args.validators)
        print(f"fleet default: --interval-ms scaled to {args.interval_ms} "
              f"for {args.validators} validators (pass --interval-ms "
              "explicitly to override)")
    # Validated up front: a usage error must not cost a prewarm.
    _, n_byzantine = chaos_behaviors(args)
    n_tenant_events = args.chaos_tenant_floods + args.chaos_tenant_stalls
    n_mesh_events = args.chaos_device_losses + args.chaos_dcn_stalls
    if (n_byzantine or args.chaos_device_faults or args.chaos_adaptive
            or n_tenant_events or n_mesh_events) and not args.chaos:
        parser.error("--chaos-byzantine / --chaos-device-faults / "
                     "--chaos-adaptive / --chaos-tenant-* / "
                     "--chaos-device-losses / --chaos-dcn-stalls "
                     "need --chaos")
    if args.soak_chaos and not (args.chaos and args.soak_seconds > 0):
        parser.error("--soak-chaos needs --chaos and --soak-seconds")
    device_batched = args.crypto != "simhash"
    if args.no_frontier and (device_batched or shared_frontier_on(args)):
        parser.error(f"--no-frontier is incompatible with --crypto "
                     f"{args.crypto} / --shared-frontier / "
                     f"--chaos-tenant-*")
    use_frontier = (not args.no_frontier
                    and (args.frontier or device_batched
                         or shared_frontier_on(args)
                         or args.validators >= FLEET_FRONTIER_MIN))
    factory = crypto_factory(args)

    if args.prewarm and device_batched:
        from ..crypto.warm import rungs_for, warm_bls, warm_simple

        t0 = time.time()
        warm = factory(10**6)  # same thresholds as the fleet's providers
        # Every rung the fleet's coalesced batches can hit: up to
        # ~validators lanes per batch, and at least the threshold.
        rungs = rungs_for(max(args.device_threshold, args.validators, 8))
        (warm_bls if args.crypto == "bls" else warm_simple)(warm, rungs)
        print(f"prewarm: device paths loaded for rungs {rungs} "
              f"in {time.time() - t0:.1f}s")

    # The summary line IS a ledger entry: stamp the envelope (version,
    # ts, env fingerprint) so sim JSON tails diff/trend like bench
    # records.
    out = asyncio.run(run(args, factory, use_frontier, shards,
                          on_start=on_start))
    print(json.dumps(ledger.annotate(out)), flush=True)
    if out.get("frontier_reverified"):
        # A provider call raised and its batch was verified on the host:
        # the heights committed, but not on the path the run asked for.
        print(f"HOST RE-VERIFY: {out['frontier_reverified']} frontier "
              "batches were re-verified on the host after their provider "
              "call raised", file=sys.stderr)
        raise SystemExit(3)
    if out.get("soak_chaos", {}).get("drift_failures"):
        # Drift breaches are the soak lane's whole verdict: distinct
        # from exit 2 (liveness failure) so CI can tell "died" from
        # "leaking".
        raise SystemExit(3)
    return out


if __name__ == "__main__":
    main()
