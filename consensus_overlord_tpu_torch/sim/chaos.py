"""Deterministic chaos schedule for the sim fleet: crash-restarts,
controller stall/error windows, partition flips, Byzantine adversary
windows, and device-path fault injection on a height timeline.

SURVEY §5 names fault injection/recovery a rebuild obligation; the
fault-tolerance machinery this exercises (WAL recovery, commit-retry,
choke/view-change, the RichStatus resync, frontier teardown/rebuild,
the engine's Byzantine guards, the device circuit breaker) only counts
as *built* once a seeded adversarial schedule drives all of it in one
run and the fleet still reconverges with zero safety violations.

Shape: `ChaosSchedule.generate(seed, ...)` derives a list of ChaosEvents
from one RNG — same seed, same schedule — each pinned to a chain height.
`ChaosRunner` arms itself on the controller's on_new_height callback and
fires every event whose height has been reached:

  crash        SimNode torn down abruptly (engine task cancelled, router
               deregistered — the kill -9 analog), then restarted after
               `duration_s` from the SAME WAL/keys/address at the
               controller's current height (the ping_controller resume)
  stall        every controller Brain callback blocks for the window (a
               wedged controller: get_block times out into nil prevotes,
               commits re-drive from the retry timer)
  error        controller callbacks raise for the window (the error twin)
  partition    the router isolates a minority group for the window, then
               heals (round-skip / choke liveness on heal)
  byzantine    an adversary behavior (sim/adversary.py: equivocator,
               forger, withholder, replayer) is armed on a live node for
               `heights` chain heights, then disarmed.  node=-1 defers
               target choice to fire time: the runner picks a node that
               will LEAD two heights out (so leader-dependent behaviors
               actually get the ball), skipping currently-faulty nodes
  device_fault tells the target node's crypto CircuitBreaker to fail
               every device dispatch for `duration_s`
               (crypto/breaker.py raise_if_injected) — the breaker must
               open, route to the host oracle, half-open probe, and
               close again inside the same schedule as everything else
  adaptive     arms the state-observing Adaptive behavior
               (sim/adversary.py) on an upcoming leader — a byzantine
               window whose tactics switch on live engine state.  Same
               f-bound budget and fire-time target resolution as
               `byzantine`
  tenant_flood a flood task pumps invalid-signature verify bursts
               (past the lane's queue bound) into the target node's
               tenant lane on the fleet's SharedFrontier for
               `duration_s` — Byzantine rejection floods riding the
               real device-batched pipeline, overflow shedding to the
               host oracle with exact verdicts
  tenant_stall the SharedFrontier's device path stalls
               (`inject_stall`) for `duration_s`: composed batches
               sleep before dispatch, queues back up, the bounded
               admission path sheds to the host oracle — the
               shed-to-host-oracle survival story under a wedged
               shared chip
  device_loss  a mesh lane of the target node's crypto provider is
               lost for `duration_s` (`inject_device_loss`):
               dispatches touching the lane raise DeviceLossError
               until the MeshSupervisor quarantines it and rebuilds a
               survivor sub-mesh — the self-healing ladder walk
               (parallel/supervisor.py), down AND back up, in-run
  dcn_stall    the provider's device calls wedge inside their dispatch
               window for `duration_s` (`inject_dcn_stall`): the
               dispatch watchdog converts the wedge to DispatchTimeout
               breaker failures within dispatch_deadline_s — bounded
               latency instead of a liveness hole

The f-bound invariant: the runner never lets crashed + Byzantine nodes
(`byzantine` OR `adaptive` windows) exceed f = ⌊(n−1)/3⌋ concurrently
(one for n=4).  An event that would breach it is DEFERRED one height
(bounded retries), keeping schedules valid without making seeds
fragile.  Chaos proves degraded-mode liveness and safety under f
faults, not that BFT needs quorum; device_fault and tenant_* targets
stay honest (degraded crypto / flow control, exact host-oracle
results) and don't consume the budget.

RNG draw-order contract (append-only): every new event family draws
AFTER all legacy draws, so a schedule generated with the new counts at
zero is bit-identical to the pre-existing generator's output AND —
stronger — the legacy events in a schedule that DOES include new kinds
keep their exact legacy heights/targets (the golden-fixture test in
tests/test_adversary.py pins both).

The port's own copy of consensus_overlord_tpu/sim/chaos.py (the port
imports nothing of the JAX package).  `generate` is the JAX package's
draw for draw, so one seed gives one schedule in both packages,
`device_loss` and `dcn_stall` events included.  Those two fire through
the target provider's mesh hooks (CudaBlsCrypto's or SimDeviceCrypto's
`inject_device_loss` / `inject_dcn_stall`), and drain waits for every
MeshSupervisor they touched to climb back to `full_mesh`.
"""

from __future__ import annotations

import asyncio
import dataclasses
import logging
import random
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from .adversary import BEHAVIORS

logger = logging.getLogger("consensus_overlord_tpu_torch.chaos")

__all__ = ["ChaosEvent", "ChaosSchedule", "ChaosRunner"]

#: An event deferred this many times (f-budget never freed up / target
#: never resolvable) is dropped with a log instead of wedging the run.
#: Deferrals are per-height and a Byzantine window spans several
#: heights, so a crash queued behind back-to-back adversary windows
#: legitimately defers for tens of heights; the run's own runway cap
#: (sim/run.py) bounds wall-clock, not this.
MAX_DEFERS = 64


#: Event kinds that arm an adversary behavior and consume an f-bound
#: budget slot ("adaptive" is its own kind so schedules and summaries
#: name it, but budget-wise it IS a byzantine window).
ADVERSARY_KINDS = ("byzantine", "adaptive")


@dataclass(frozen=True)
class ChaosEvent:
    at_height: int          # fire when the chain first commits this height
    kind: str               # "crash" | "stall" | "error" | "partition"
    #                       # | "byzantine" | "device_fault" | "adaptive"
    #                       # | "tenant_flood" | "tenant_stall"
    #                       # | "device_loss" | "dcn_stall"
    node: int = -1          # crash/device_fault/tenant_flood/device_loss/
    #                       # dcn_stall: validator index; byzantine/
    #                       # adaptive: -1 = runner picks an upcoming
    #                       # leader at fire time
    duration_s: float = 0.5  # downtime / fault / flood / stall window
    behavior: str = ""      # byzantine/adaptive: adversary behavior name
    heights: int = 0        # byzantine/adaptive: window length in heights
    defers: int = 0         # times the runner pushed it back (f-bound)
    device: int = -1        # device_loss: mesh lane index to lose


@dataclass
class ChaosSchedule:
    events: List[ChaosEvent] = field(default_factory=list)

    @classmethod
    def generate(cls, seed: int, heights: int, n_validators: int,
                 crashes: int = 2, stalls: int = 1, partitions: int = 1,
                 byzantine: int = 0, device_faults: int = 0,
                 behaviors: Optional[List[str]] = None,
                 byz_window: Optional[int] = None,
                 downtime_s: float = 0.4, window_s: float = 0.4,
                 device_window_s: float = 0.6,
                 adaptive: int = 0, tenant_floods: int = 0,
                 tenant_stalls: int = 0,
                 tenant_window_s: float = 0.8,
                 device_losses: int = 0, dcn_stalls: int = 0,
                 mesh_lanes: int = 8,
                 mesh_window_s: float = 0.8) -> "ChaosSchedule":
        """Derive a schedule from one seeded RNG.  Events land on
        distinct heights in [2, heights-1] — height 1 establishes the
        fleet, and the last height is post-fault runway proving
        reconvergence.  Crash targets are distinct validators, so at
        most one is down per event window.

        byzantine: number of adversary windows; `behaviors` names them
        explicitly (len == byzantine) or they round-robin through
        adversary.BEHAVIORS (rejection-producing behaviors first).
        Each window lasts `byz_window` heights (default:
        max(2, min(n_validators, 12)) — enough for the fire-time
        target, an upcoming leader, to take its turn, without a
        100-validator fleet arming for 100 heights).  Targets resolve
        at fire time (node=-1).

        adaptive: windows arming the state-observing Adaptive behavior
        (its own event kind, same budget/window/target machinery).
        tenant_floods / tenant_stalls: SharedFrontier attack windows
        (no-ops, logged, when the fleet has no shared frontier).
        device_losses / dcn_stalls: mesh-resilience windows
        (inject_device_loss / inject_dcn_stall; no-ops, logged, when
        the target crypto has no mesh chaos hooks).  device_loss lanes
        draw from range(mesh_lanes); both use mesh_window_s.

        The RNG draw order is append-only: a schedule generated with
        byzantine=0 and device_faults=0 is bit-identical to one from
        the pre-Byzantine harness, and the new kinds (adaptive,
        tenant_*) draw strictly AFTER every legacy draw — legacy
        events keep their exact heights/targets even in a schedule
        that includes new kinds (seeds stay stable across PRs)."""
        rng = random.Random(seed)
        # At most one crash per validator: targets are distinct, so more
        # crash events than validators is unsatisfiable.
        crashes = min(crashes, n_validators)
        n_events = crashes + stalls + partitions + byzantine + device_faults
        lo, hi = 2, max(heights - 1, 2)
        span = list(range(lo, hi + 1))
        if len(span) >= n_events:
            slots = sorted(rng.sample(span, n_events))
        else:  # short run: reuse heights, still deterministic
            slots = sorted(rng.choice(span) for _ in range(n_events))
        kinds = (["crash"] * crashes + ["stall"] * stalls
                 + ["partition"] * partitions + ["byzantine"] * byzantine
                 + ["device_fault"] * device_faults)
        rng.shuffle(kinds)
        crash_targets = rng.sample(range(n_validators), crashes)
        if behaviors is None:
            behaviors = [BEHAVIORS[i % len(BEHAVIORS)]
                         for i in range(byzantine)]
        if len(behaviors) != byzantine:
            raise ValueError(f"{byzantine} byzantine events but "
                             f"{len(behaviors)} behaviors named")
        window = byz_window if byz_window is not None \
            else max(2, min(n_validators, 12))
        events, ci, bi = [], 0, 0
        for at, kind in zip(slots, kinds):
            if kind == "crash":
                events.append(ChaosEvent(at, "crash",
                                         node=crash_targets[ci],
                                         duration_s=downtime_s))
                ci += 1
            elif kind == "byzantine":
                events.append(ChaosEvent(at, "byzantine", node=-1,
                                         behavior=behaviors[bi],
                                         heights=window))
                bi += 1
            elif kind == "device_fault":
                events.append(ChaosEvent(
                    at, "device_fault",
                    node=rng.randrange(n_validators),
                    duration_s=device_window_s))
            else:
                events.append(ChaosEvent(at, kind, duration_s=window_s))
        # -- new kinds: every draw below is APPENDED after the legacy
        # draws above, so the events above are bit-identical to what
        # the legacy generator produced for this seed.
        # graftlint: sim001-legacy-draw-boundary — the port's graftlint
        # (consensus_overlord_tpu_torch/analysis, SIM001) pins the draw
        # sites above this line; new event families must draw below it
        # or every recorded seed re-rolls.
        for _ in range(adaptive):
            events.append(ChaosEvent(rng.choice(span), "adaptive",
                                     node=-1, behavior="adaptive",
                                     heights=window))
        for _ in range(tenant_floods):
            events.append(ChaosEvent(rng.choice(span), "tenant_flood",
                                     node=rng.randrange(n_validators),
                                     duration_s=tenant_window_s))
        for _ in range(tenant_stalls):
            events.append(ChaosEvent(rng.choice(span), "tenant_stall",
                                     duration_s=tenant_window_s))
        for _ in range(device_losses):
            events.append(ChaosEvent(rng.choice(span), "device_loss",
                                     node=rng.randrange(n_validators),
                                     duration_s=mesh_window_s,
                                     device=rng.randrange(
                                         max(int(mesh_lanes), 1))))
        for _ in range(dcn_stalls):
            events.append(ChaosEvent(rng.choice(span), "dcn_stall",
                                     node=rng.randrange(n_validators),
                                     duration_s=mesh_window_s))
        return cls(events)

    def shift(self, delta: int) -> "ChaosSchedule":
        """The same schedule displaced `delta` heights later — the
        soak-chaos lane replays freshly-seeded schedules cycle after
        cycle against a chain whose height only grows."""
        return ChaosSchedule([
            dataclasses.replace(e, at_height=e.at_height + delta)
            for e in self.events])


class ChaosRunner:
    """Fires a ChaosSchedule against a live SimNetwork.

    Construct AFTER net.start(); call `await drain()` once the run
    reaches its target height so in-flight restarts/heals/disarms and
    breaker recoveries complete before the fleet is stopped and
    asserted on."""

    def __init__(self, net, schedule: ChaosSchedule):
        self.net = net
        self.schedule = schedule
        #: Post-hoc log: one dict per fired event (run summaries embed it).
        self.fired: List[dict] = []
        #: Events dropped after MAX_DEFERS (f-bound never cleared).
        self.dropped: List[dict] = []
        self._pending = sorted(schedule.events, key=lambda e: e.at_height)
        self._tasks: set = set()
        #: node index -> "crash" | "byzantine": the live fault budget.
        #: Invariant: len(_faulty) <= f at all times.
        self._faulty: Dict[int, str] = {}
        #: byzantine disarms scheduled by height: (height, node index)
        self._disarm_at: List[tuple] = []
        #: breakers with injected fault windows (drain waits for their
        #: recovery so the open→half-open→closed cycle completes in-run)
        self._breakers: List = []
        #: events whose heights were never reached (counted at drain —
        #: _pending is cleared there, so the summary needs the tally)
        self._never_reached = 0
        #: per-adversary-window frontier batch marks: how many device
        #: batches the fleet's frontier(s) flushed while the window was
        #: armed — the "rejection floods rode the batched pipeline"
        #: evidence, keyed by node index of the armed adversary.
        self._frontier_marks: List[dict] = []
        #: tenant_flood outcomes: one dict per fired flood window.
        self.tenant_floods: List[dict] = []
        #: tenant_stall windows fired.
        self.tenant_stalls: List[dict] = []
        #: device_loss / dcn_stall windows fired (mesh resilience).
        self.device_losses: List[dict] = []
        self.dcn_stalls: List[dict] = []
        #: MeshSupervisors touched by mesh chaos (drain waits for their
        #: ladders to climb back to the top rung so the down-AND-up
        #: cycle completes in-run).
        self._supervisors: List = []
        net.controller.on_new_height.append(self._on_height)

    def detach(self) -> None:
        """Unhook from the controller's new-height callback.  The
        soak-chaos lane constructs one runner per chaos cycle against
        one long-lived fleet; without this every spent runner would
        keep firing its (empty) height scan forever."""
        try:
            self.net.controller.on_new_height.remove(self._on_height)
        except ValueError:
            pass

    @property
    def pending_count(self) -> int:
        """Events still waiting for their height (incl. f-bound
        deferrals).  Runs that must finish the whole schedule keep
        committing runway heights until this is zero."""
        return len(self._pending)

    @property
    def inflight_count(self) -> int:
        """Fired-but-unfinished event tasks.  A byzantine _fire queued
        on the current height hasn't armed yet — runway loops must not
        conclude the schedule is spent before it runs."""
        return len(self._tasks)

    @property
    def byzantine_armed(self) -> bool:
        """Any adversary window still open?  Runway heights let it
        play out (a behavior armed but disarmed before its leader turn
        proved nothing)."""
        return bool(self._disarm_at)

    @property
    def f(self) -> int:
        """Max concurrent faulty (crashed + Byzantine) nodes.  max(1,·)
        matches the partition event's minority sizing: tiny fleets
        still get chaos, full-size ones get the BFT bound."""
        return max(1, (len(self.net.nodes) - 1) // 3)

    def _on_height(self, height: int) -> None:
        # Disarm expired Byzantine windows first: their budget slots may
        # be what lets a deferred event finally fire at this height.
        still = []
        for at, idx in self._disarm_at:
            if at <= height:
                self._disarm(idx)
            else:
                still.append((at, idx))
        self._disarm_at = still
        while self._pending and self._pending[0].at_height <= height:
            ev = self._pending.pop(0)
            ev = self._reserve(ev, height)
            if ev is None:
                continue  # deferred or dropped
            task = asyncio.get_running_loop().create_task(
                self._fire(ev, height))
            self._tasks.add(task)
            task.add_done_callback(self._tasks.discard)

    # -- f-bound budget ----------------------------------------------------

    def _reserve(self, ev: ChaosEvent, height: int
                 ) -> Optional[ChaosEvent]:
        """Claim a fault-budget slot (and resolve node=-1) synchronously
        — _on_height fires events back-to-back, so the budget must be
        taken before any task runs.  Returns the (possibly rewritten)
        event to fire, or None after deferring/dropping it.

        The f-bound is the schedule's invariant: Byzantine windows (either
        adversary kind) never overlap crashes past f = ⌊(n−1)/3⌋ total
        faulty nodes.  Pure crash-crash overlap keeps the pre-Byzantine
        harness contract (distinct targets on distinct heights; a long
        downtime may still briefly overlap the next crash window) so
        legacy chaos schedules replay with their original timing."""
        if ev.kind != "crash" and ev.kind not in ADVERSARY_KINDS:
            return ev
        node = ev.node
        armed = sum(1 for k in self._faulty.values() if k == "byzantine")
        if ev.kind in ADVERSARY_KINDS:
            if node < 0:
                node = self._pick_byzantine_target(height)
            ok = (node is not None and node not in self._faulty
                  and len(self._faulty) < self.f)
        else:
            # Crash: on its ORIGINAL height, constrained only by live
            # adversary windows (the pre-Byzantine harness contract —
            # the generator emits crashes on distinct heights, so
            # legacy schedules replay with their original timing).  A
            # DEFERRED crash may have collapsed onto another crash's
            # height, so it must respect the full budget or n=4 loses
            # quorum to two simultaneous crashes.
            ok = (self._faulty.get(node) != "byzantine"
                  and (len(self._faulty) < self.f
                       or (ev.defers == 0 and armed == 0)))
        if not ok:
            if ev.defers + 1 > MAX_DEFERS:
                logger.warning("chaos: dropping %s (f-bound never "
                               "cleared after %d defers)", ev.kind,
                               ev.defers)
                self.dropped.append({"kind": ev.kind,
                                     "at_height": ev.at_height,
                                     "behavior": ev.behavior})
                return None
            deferred = dataclasses.replace(ev, at_height=height + 1,
                                           defers=ev.defers + 1)
            self._pending.append(deferred)
            self._pending.sort(key=lambda e: e.at_height)
            logger.info("chaos: deferring %s to height %d (f-bound)",
                        ev.kind, height + 1)
            return None
        # Both adversary kinds hold a "byzantine" budget slot (the
        # disarm sweep frees by that label).
        self._faulty[node] = ("byzantine" if ev.kind in ADVERSARY_KINDS
                              else ev.kind)
        return dataclasses.replace(ev, node=node)

    def _pick_byzantine_target(self, height: int) -> Optional[int]:
        """A non-faulty node that leads round 0 of an upcoming height —
        two heights out gives the arm time to land before its turn, so
        leader-dependent behaviors (equivocator, withholder) actually
        run their play inside the window."""
        by_addr = {n.name: i for i, n in enumerate(self.net.nodes)}
        for ahead in range(2, 2 + len(self.net.nodes)):
            try:
                addr = self.net.nodes[0].engine.leader(height + ahead, 0)
            except Exception:  # noqa: BLE001 — engine pre-run
                return None
            idx = by_addr.get(addr)
            if idx is not None and idx not in self._faulty:
                return idx
        return None

    def _disarm(self, idx: int) -> None:
        try:
            self.net.set_behavior(idx, None)
        except Exception:  # noqa: BLE001 — node may have been rebuilt
            logger.exception("chaos: disarm of node %d failed", idx)
        if self._faulty.get(idx) == "byzantine":
            del self._faulty[idx]
        for mark in self._frontier_marks:
            if mark["node"] == idx and mark["batches_at_disarm"] is None:
                mark["batches_at_disarm"] = self._frontier_batches()

    # -- event bodies ------------------------------------------------------

    async def _fire(self, ev: ChaosEvent, height: int) -> None:
        entry = {"kind": ev.kind, "at_height": ev.at_height,
                 "fired_height": height, "node": ev.node,
                 "duration_s": ev.duration_s}
        if ev.kind in ADVERSARY_KINDS:
            entry["behavior"] = ev.behavior
            entry["heights"] = ev.heights
        self.fired.append(entry)
        logger.info("chaos: %s at height %d (node=%d, %.2fs%s)",
                    ev.kind, height, ev.node, ev.duration_s,
                    f", {ev.behavior}" if ev.behavior else "")
        try:
            if ev.kind == "crash":
                await self._crash_restart(ev)
            elif ev.kind in ("stall", "error"):
                self.net.controller.inject_fault(ev.kind, ev.duration_s)
            elif ev.kind == "partition":
                await self._partition_flip(ev)
            elif ev.kind in ADVERSARY_KINDS:
                self._arm_byzantine(ev, height)
            elif ev.kind == "device_fault":
                self._inject_device_fault(ev)
            elif ev.kind == "tenant_flood":
                await self._tenant_flood(ev, entry)
            elif ev.kind == "tenant_stall":
                self._tenant_stall(ev, entry)
            elif ev.kind == "device_loss":
                self._device_loss(ev, entry)
            elif ev.kind == "dcn_stall":
                self._dcn_stall(ev, entry)
            else:
                logger.warning("chaos: unknown event kind %r", ev.kind)
        except Exception:  # noqa: BLE001 — chaos must not crash the run
            logger.exception("chaos event %s failed", ev.kind)
            entry["error"] = True
            # Free the fault-budget slot ONLY for the kind that holds
            # one here: crash releases itself in _crash_restart's
            # finally, and the other kinds never reserved — popping
            # unconditionally would release a slot some OTHER live
            # fault still owns (f-bound breach).
            if ev.kind in ADVERSARY_KINDS:
                self._faulty.pop(ev.node, None)

    async def _crash_restart(self, ev: ChaosEvent) -> None:
        node = self.net.nodes[ev.node]
        if node.recorder is not None:
            node.recorder.record("chaos_crash", node=ev.node)
        try:
            self.net.crash_node(ev.node)
            await asyncio.sleep(ev.duration_s)
            revived = self.net.restart_node(ev.node)
            if revived.recorder is not None:
                revived.recorder.record("chaos_restart", node=ev.node,
                                        init_height=revived.engine.height)
        finally:
            # Budget slot frees only once the node is back (or the
            # restart failed and the exception path logged it).
            self._faulty.pop(ev.node, None)

    async def _partition_flip(self, ev: ChaosEvent) -> None:
        """Isolate a minority (≤ f) group so the majority keeps
        committing; heal after the window.

        On a sharded fabric (net.shards > 1) the window ROLLS: it is
        split into one sub-window per shard, each isolating a different
        f-sized run of consecutive validators.  Consecutive indices map
        round-robin onto shards, so every sub-window's minority spans
        shard boundaries — the cut crosses the inter-shard trunk, not
        just intra-shard edges — and successive sub-windows sweep the
        cut around the whole fleet.  The picks derive from the event
        alone (no RNG draws: the schedule's append-only draw-order
        contract, SIM001, stays intact)."""
        nodes = self.net.nodes
        n = len(nodes)
        f = max(1, (n - 1) // 3)
        shards = max(1, getattr(self.net, "shards", 1))
        windows = shards if shards > 1 else 1
        sub_s = ev.duration_s / windows
        all_names = {node.name for node in nodes}
        for w in range(windows):
            start = (w * f) % n
            minority = {nodes[(start + j) % n].name for j in range(f)}
            self.net.router.set_partition(all_names - minority, minority)
            await asyncio.sleep(sub_s)
        self.net.router.set_partition()  # heal

    def _frontier_batches(self) -> int:
        """Device batches flushed by the fleet's frontier path so far:
        the shared core's count when the fleet rides one, else the sum
        over private per-node BatchingVerifiers (TenantLane handles
        onto a shared core expose TenantStats, which has no batch
        count — the core is the single source of truth there)."""
        core = getattr(self.net, "shared_frontier", None)
        if core is not None:
            return core.stats.batches
        total = 0
        for n in self.net.nodes:
            st = getattr(getattr(n, "frontier", None), "stats", None)
            batches = getattr(st, "batches", None)
            if batches:
                total += batches
        return total

    def _arm_byzantine(self, ev: ChaosEvent, height: int) -> None:
        self.net.set_behavior(ev.node, ev.behavior)
        self._disarm_at.append((height + max(ev.heights, 1), ev.node))
        # Frontier batch mark: the delta to the disarm-time count is
        # the "rejection floods hit the device-batched pipeline"
        # evidence runs assert on (sim/run.py).
        self._frontier_marks.append({
            "node": ev.node, "behavior": ev.behavior,
            "batches_at_arm": self._frontier_batches(),
            "batches_at_disarm": None})

    def _inject_device_fault(self, ev: ChaosEvent) -> None:
        node = self.net.nodes[ev.node]
        breaker = getattr(node.crypto, "breaker", None)
        core = getattr(self.net, "shared_frontier", None)
        if core is not None:
            # Shared-frontier fleet: the chip is SHARED — per-node
            # cryptos only sign, so a node-local breaker would never
            # see a device call (the fault window would idle out).
            # The meaningful fault is the shared device failing.
            shared_breaker = getattr(core._provider, "breaker", None)
            if shared_breaker is not None:
                breaker = shared_breaker
        if breaker is None or not hasattr(breaker, "inject_faults"):
            logger.warning("chaos: node %d crypto has no breaker; "
                           "device_fault skipped", ev.node)
            return
        # min_faults: the window must actually open the breaker even if
        # the target spends most of it crashed/idle (seed 7 crashes the
        # fault target mid-window) — the breaker keeps failing device
        # calls past the wall-clock window until threshold faults landed.
        breaker.inject_faults(
            ev.duration_s,
            min_faults=getattr(breaker, "failure_threshold", 0))
        if node.recorder is not None:
            node.recorder.record("chaos_device_fault", node=ev.node,
                                 duration_s=ev.duration_s)
        self._breakers.append((breaker, breaker.times_opened,
                               breaker.total_injected))

    # -- tenant events (SharedFrontier attack windows) ---------------------

    def _tenant_lane(self, node_idx: int):
        """The target node's tenant lane on the fleet's SharedFrontier,
        or None (logged) when the fleet doesn't ride a shared core —
        tenant events need the multi-tenant admission/fairness
        machinery to attack."""
        core = getattr(self.net, "shared_frontier", None)
        if core is None:
            logger.warning("chaos: fleet has no shared frontier; "
                           "tenant event skipped")
            return None
        lane = getattr(self.net.nodes[node_idx], "frontier", None)
        if lane is None or not hasattr(lane, "tenant_stats"):
            logger.warning("chaos: node %d has no tenant lane; "
                           "tenant event skipped", node_idx)
            return None
        return lane

    async def _tenant_flood(self, ev: ChaosEvent, entry: dict) -> None:
        """Pump invalid-signature verify bursts (each burst larger than
        the lane's queue bound) into the target tenant's lane for the
        window: rejection floods ride the real device-batched pipeline,
        and overflow sheds to the host oracle with exact (False)
        verdicts — flow control under attack, never a drop."""
        from ..core.sm3 import sm3_hash

        lane = self._tenant_lane(ev.node)
        if lane is None:
            return
        node = self.net.nodes[ev.node]
        if node.recorder is not None:
            node.recorder.record("chaos_tenant_flood", node=ev.node,
                                 tenant=lane.tenant_id,
                                 duration_s=ev.duration_s)
        sheds0 = lane.tenant_stats.sheds
        failures0 = lane.tenant_stats.failures
        burst = lane.queue_bound + 64
        h = sm3_hash(b"chaos tenant flood")
        sig, voter = b"\x00" * 32, b"\xff" * 32  # never verifies
        loop = asyncio.get_running_loop()
        deadline = loop.time() + ev.duration_s
        sent = 0
        while loop.time() < deadline:
            results = await asyncio.gather(
                *(lane.verify(sig, h, voter, msg_type="chaos_flood")
                  for _ in range(burst)),
                return_exceptions=True)
            sent += len(results)
        stats = {"node": ev.node, "tenant": lane.tenant_id,
                 "sent": sent,
                 "sheds": lane.tenant_stats.sheds - sheds0,
                 "rejected": lane.tenant_stats.failures - failures0}
        entry.update(stats)
        self.tenant_floods.append(stats)

    def _tenant_stall(self, ev: ChaosEvent, entry: dict) -> None:
        """Wedge the shared core's device path for the window
        (SharedFrontier.inject_stall): batches sleep before dispatch,
        per-tenant queues back up, and the bounded admission path must
        shed to the host oracle so every chain keeps committing."""
        core = getattr(self.net, "shared_frontier", None)
        if core is None or not hasattr(core, "inject_stall"):
            logger.warning("chaos: fleet has no shared frontier; "
                           "tenant_stall skipped")
            return
        core.inject_stall(ev.duration_s)
        stats = {"duration_s": ev.duration_s,
                 "sheds_at_stall": core.stats.sheds}
        entry.update(stats)
        self.tenant_stalls.append(stats)

    # -- mesh-resilience events (device_loss / dcn_stall) ------------------

    def _mesh_provider(self, node_idx: int, hook: str):
        """The crypto provider whose mesh the event attacks: the shared
        frontier's provider when the fleet rides one (per-node cryptos
        only sign there — same targeting as device_fault), else the
        node's own.  None (logged) when it lacks the chaos hook."""
        provider = self.net.nodes[node_idx].crypto
        core = getattr(self.net, "shared_frontier", None)
        if core is not None:
            shared = getattr(core, "_provider", None)
            if shared is not None and hasattr(shared, hook):
                provider = shared
        if not hasattr(provider, hook):
            logger.warning("chaos: node %d crypto has no %s; "
                           "mesh event skipped", node_idx, hook)
            return None
        sup = getattr(provider, "_supervisor", None)
        if sup is not None and sup not in self._supervisors:
            self._supervisors.append(sup)
        return provider

    def _device_loss(self, ev: ChaosEvent, entry: dict) -> None:
        """Lose one mesh lane for the window: dispatches touching it
        raise DeviceLossError until the supervisor quarantines the lane
        and rebuilds a survivor sub-mesh — after which the window is
        still live but dispatch runs clean (the self-healing proof)."""
        provider = self._mesh_provider(ev.node, "inject_device_loss")
        if provider is None:
            return
        provider.inject_device_loss(ev.device, ev.duration_s)
        node = self.net.nodes[ev.node]
        if node.recorder is not None:
            node.recorder.record("chaos_device_loss", node=ev.node,
                                 device=ev.device,
                                 duration_s=ev.duration_s)
        stats = {"node": ev.node, "device": ev.device,
                 "duration_s": ev.duration_s}
        entry.update(stats)
        self.device_losses.append(stats)

    def _dcn_stall(self, ev: ChaosEvent, entry: dict) -> None:
        """Wedge the provider's device calls inside their dispatch
        window: the watchdog converts the wedge to DispatchTimeout
        breaker failures within dispatch_deadline_s, and the ladder
        steps down — bounded latency, never a liveness hole."""
        provider = self._mesh_provider(ev.node, "inject_dcn_stall")
        if provider is None:
            return
        provider.inject_dcn_stall(ev.duration_s)
        node = self.net.nodes[ev.node]
        if node.recorder is not None:
            node.recorder.record("chaos_dcn_stall", node=ev.node,
                                 duration_s=ev.duration_s)
        stats = {"node": ev.node, "duration_s": ev.duration_s}
        entry.update(stats)
        self.dcn_stalls.append(stats)

    # -- teardown ----------------------------------------------------------

    async def drain(self, timeout: float = 10.0) -> None:
        """Wait for every fired event's follow-through (restarts, heals,
        breaker recoveries) to finish and disarm any still-active
        adversaries.  Pending events whose heights were never reached
        are dropped — the run decides how far the chain goes."""
        self._never_reached += len(self._pending)
        self._pending.clear()
        # Await in-flight _fire tasks BEFORE the disarm sweep: a
        # byzantine event queued on the final height would otherwise
        # arm after the sweep and stay armed (leaking its budget slot)
        # past the run.
        if self._tasks:
            await asyncio.wait_for(
                asyncio.gather(*list(self._tasks), return_exceptions=True),
                timeout)
        for _, idx in self._disarm_at:
            self._disarm(idx)
        self._disarm_at.clear()
        await self._settle_breakers(timeout)
        await self._settle_ladders(timeout)

    async def _settle_breakers(self, timeout: float) -> None:
        """Wait until every fault-injected breaker has run a genuine
        open → half-open → closed cycle: opened at least once SINCE its
        injection (times_opened past the baseline captured at inject
        time — plain `state == closed` is vacuously true for a breaker
        that never tripped), the fault window fully spent, and the
        state closed again.  The fleet keeps committing during drain,
        so device calls keep arriving to drive the cycle home.
        Best-effort: a breaker that cannot settle by the deadline is
        logged and its leftover fault window cleared (a crypto path
        that makes no device calls — e.g. CudaBlsCrypto below its batch
        threshold — would otherwise stay armed forever); the run's
        metric assertions consult device_faults_effective to tell a
        never-bit window from a genuinely stuck breaker."""
        if not self._breakers:
            return

        def settled() -> bool:
            return all(b.times_opened > opened0 and not b.fault_injected
                       and b.state == "closed"
                       for b, opened0, _ in self._breakers)

        loop = asyncio.get_running_loop()
        deadline = loop.time() + timeout
        while loop.time() < deadline:
            if settled():
                return
            await asyncio.sleep(0.05)
        logger.warning("chaos: breaker(s) still %s after drain timeout",
                       [(b.state, b.times_opened - opened0,
                         b.total_injected - injected0)
                        for b, opened0, injected0 in self._breakers])
        for b, _, _ in self._breakers:
            if b.fault_injected:
                b.clear_injected_faults()

    async def _settle_ladders(self, timeout: float) -> None:
        """Wait until every supervisor a mesh event touched has climbed
        back to the top rung — the down-AND-up half of the self-healing
        contract (the fleet keeps committing during drain, so clean
        dispatches keep arriving to probe the ladder up).  Best-effort:
        a ladder stuck below the top at the deadline is logged; the
        run's assertions decide whether that fails it."""
        if not self._supervisors:
            return

        def recovered() -> bool:
            return all(s.rung == "full_mesh" for s in self._supervisors)

        loop = asyncio.get_running_loop()
        deadline = loop.time() + timeout
        while loop.time() < deadline:
            if recovered():
                return
            await asyncio.sleep(0.05)
        logger.warning("chaos: ladder(s) still below full_mesh after "
                       "drain timeout: %s",
                       [s.statusz()["rung"] for s in self._supervisors])

    @property
    def ladder_supervisors(self) -> List:
        """Supervisors the mesh events touched (run assertions read
        their transition history post-drain)."""
        return list(self._supervisors)

    @property
    def device_faults_effective(self) -> int:
        """Fault-injected breakers whose window actually bit (at least
        one device call failed on injection).  Zero on a fleet whose
        crypto never dispatches to the device — e.g. CudaBlsCrypto under
        its batch threshold — where no open→closed cycle can exist and
        asserting one would fail a healthy run."""
        return sum(1 for b, _, injected0 in self._breakers
                   if b.total_injected > injected0)

    def summary(self) -> dict:
        return {
            "events_fired": len(self.fired),
            "events_skipped": (len(self._pending) + len(self.dropped)
                               + self._never_reached),
            "events": self.fired,
            "behaviors_active": sorted({e["behavior"]
                                        for e in self.fired
                                        if e["kind"] in ADVERSARY_KINDS}),
            "device_faults_fired": sum(1 for e in self.fired
                                       if e["kind"] == "device_fault"),
            "device_faults_effective": self.device_faults_effective,
            "tenant_floods": self.tenant_floods,
            "tenant_stalls": self.tenant_stalls,
            "device_losses": self.device_losses,
            "dcn_stalls": self.dcn_stalls,
            "ladder_transitions": [t for s in self._supervisors
                                   for t in s.statusz()["recent"]],
            # Device-batch throughput while each adversary window was
            # armed: disarm-time minus arm-time batch counts (None =
            # window still open — drain() closes them all).
            "frontier_marks": self._frontier_marks,
            "f_bound": self.f,
        }
