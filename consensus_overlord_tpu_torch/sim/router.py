"""Asyncio network fabric: the in-process stand-in for the CITA-Cloud
network microservice.

Implements the same two primitives the reference consumes over gRPC —
broadcast-to-all-others and point-to-point send (reference
src/consensus.rs:710, 762; origin routing rule src/util.rs:93-97) — plus
deterministic fault injection: message drop, delivery delay, and network
partitions.

Sharded fabric (sim/README.md "Sharded fabric"): a fleet is split across
S per-shard ``Router``s behind one ``ShardedRouter`` facade.  Each shard
owns the validators homed on it and pumps their inbound traffic in
per-tick delivery passes — every message due within a tick coalesces
into ONE scheduled pass instead of one asyncio task per message, which
is what capped the flat fabric near 100 validators.  Cross-shard traffic
rides an inter-shard trunk: the sending side appends to the target
shard's trunk inbox and the target's pump drains the inbox as a batch at
the top of its next pass, so shard boundaries cost one tick of latency
and zero extra tasks.

Determinism contract at S>1: drop/delay decisions come from
``EdgeDecider`` — a keyed hash of (seed, sender, target, per-edge
sequence number) — not from a shared sequential RNG, so the n-th message
on a directed edge gets the same verdict whatever the shard count or
delivery interleaving.  Same seed + same topology ⇒ identical
drop/delay/partition decisions; tests/test_sim_fabric.py pins this with
a 1-shard vs 4-shard golden fixture.

The port's own copy of consensus_overlord_tpu/sim/router.py
(the port imports nothing of the JAX package).
"""

from __future__ import annotations

import asyncio
import hashlib
import heapq
import logging
import threading
import time
from typing import (Awaitable, Callable, Dict, Iterable, List, Optional,
                    Sequence, Set, Tuple)

from ..core.types import Address

logger = logging.getLogger("consensus_overlord_tpu_torch.sim.router")

# handler(sender, msg_type, payload) — the legacy per-message shape, kept
# for standalone Router users; a fleet installs a batch sink instead.
Handler = Callable[[Address, str, bytes], Awaitable[None]]

#: Batch sink: one await per pump pass, carrying every due delivery for
#: the shard — [(target, sender, msg_type, payload, envelope), ...]
#: where envelope is the delivery's provenance stamp
#: (enq_monotonic, due_monotonic, trunk_drain_monotonic_or_0, delivered
#: _monotonic, via_trunk) — timestamps the causal commit tracer
#: (obs/causal.py) turns into router-queue-wait / trunk-hop stages.  The
#: harness installs one (decode-dedup + batched engine injection);
#: without a sink the pump falls back to legacy task-per-message
#: dispatch (the envelope is dropped there — legacy handlers keep the
#: (sender, msg_type, payload) shape).
Envelope = Tuple[float, float, float, float, bool]
BatchSink = Callable[[List[Tuple[bytes, bytes, str, bytes, Envelope]]],
                     Awaitable[None]]

_U64 = float(1 << 64)

#: Pump cadence: messages due within one tick coalesce into one
#: delivery pass (delays are quantized to this granularity).
DEFAULT_TICK_S = 0.002

#: Decode-dedup cache bound in the harness sink rides this too — kept
#: here so the fabric's sizing knobs live in one module.
WORKER_MODES = ("inline", "thread")


def _addr(address: Address) -> bytes:
    """Normalize an Address once at the fabric boundary (register /
    send / broadcast / partition groups).  Without this a bytearray or
    memoryview sender compares unequal to its stored bytes key — so
    broadcast self-delivers and partition membership silently misses."""
    return address if type(address) is bytes else bytes(address)


class EdgeDecider:
    """Deterministic per-edge drop/delay decisions, independent of shard
    layout and delivery interleaving.

    The flat router drew from one sequential ``random.Random``, so the
    decision stream depended on global send order — fine at S=1, but S
    shards interleave and the same seed would drop different messages at
    different shard counts.  Each decision instead hashes (seed, sender,
    target, edge-sequence): message n on a directed edge always gets the
    same verdict.  The per-edge counters are append-only state owned by
    the fabric, touched only from the event loop (admission happens on
    the caller's loop slice, never in shard worker threads)."""

    def __init__(self, seed: int):
        self._key = (int(seed) & 0xFFFFFFFFFFFFFFFF).to_bytes(8, "big")
        self._edge_seq: Dict[Tuple[bytes, bytes], int] = {}

    def decide(self, sender: bytes, target: bytes) -> Tuple[float, float]:
        """-> (u_drop, u_delay), each uniform in [0, 1)."""
        edge = (sender, target)
        seq = self._edge_seq.get(edge, 0)
        self._edge_seq[edge] = seq + 1
        h = hashlib.blake2b(sender + target + seq.to_bytes(8, "big"),
                            digest_size=16, key=self._key).digest()
        return (int.from_bytes(h[:8], "big") / _U64,
                int.from_bytes(h[8:], "big") / _U64)


class _PartitionState:
    """Partition groups shared by every shard of one fabric.  Group
    members are normalized to bytes on entry — the same boundary hygiene
    as registration, and what lets a partition expressed over bytearray
    node names still cut traffic."""

    def __init__(self) -> None:
        self.groups: Optional[List[Set[bytes]]] = None
        self.flips = 0

    def set(self, groups: Sequence[Iterable[Address]]) -> None:
        if groups:
            self.flips += 1
            self.groups = [{_addr(a) for a in g} for g in groups]
        else:
            self.groups = None

    def can_reach(self, a: bytes, b: bytes) -> bool:
        if self.groups is None:
            return True
        for group in self.groups:
            if a in group:
                return b in group
        return False  # unlisted nodes are isolated

    def render(self) -> List[List[str]]:
        if self.groups is None:
            return []
        return [sorted(a[:4].hex() for a in g) for g in self.groups]


class Router:
    """One shard of the sim fabric (standalone ``Router(seed=...)`` is
    the single-shard degenerate case and keeps the legacy constructor).

    Delivery is pumped, not task-per-message: admitted messages land in
    a due-time heap and a single pump per shard drains everything due
    each tick as one pass.  The pass goes to the installed batch sink in
    one await (zero tasks), or — for standalone users without a sink —
    to the legacy per-message handler tasks.

    Thread safety: the heap and trunk inbox are guarded by one lock so a
    ``worker="thread"`` pump can pop from its own thread; counters and
    the decider are only ever touched on the event loop (admission and
    dispatch both run there in either mode)."""

    def __init__(self, seed: int = 0, drop_rate: float = 0.0,
                 delay_range: tuple[float, float] = (0.0, 0.0),
                 tick_s: float = DEFAULT_TICK_S, shard_id: int = 0,
                 decider: Optional[EdgeDecider] = None,
                 partition: Optional[_PartitionState] = None,
                 worker: str = "inline", metrics=None):
        if worker not in WORKER_MODES:
            raise ValueError(f"worker must be one of {WORKER_MODES}")
        self._handlers: Dict[bytes, Handler] = {}
        self.drop_rate = drop_rate
        self.delay_range = delay_range
        self.tick_s = tick_s
        self.shard_id = shard_id
        self.worker = worker
        self._decider = decider if decider is not None else EdgeDecider(seed)
        self._partition = (partition if partition is not None
                           else _PartitionState())
        self._metrics = metrics
        self._sink: Optional[BatchSink] = None
        #: Pending deliveries: (due, seq, target, sender, msg_type,
        #: payload, enqueued_at, via_trunk, trunk_drained_at) — seq
        #: breaks due-time ties in admission order so replays are
        #: stable; the trailing provenance fields feed the batch sink's
        #: delivery envelopes and cost zero RNG draws (pure clock
        #: reads already taken at admission).
        self._heap: List[tuple] = []
        self._seq = 0
        #: Cross-shard trunk inbox: the fabric appends admitted items
        #: here; the pump drains the whole inbox as one batch at the top
        #: of its next pass (the "trunk batching" of the sharded fabric).
        self._trunk_in: List[tuple] = []
        self._lock = threading.Lock()
        self._pump_task: Optional[asyncio.Task] = None
        self._kick_evt: Optional[asyncio.Event] = None
        self._thread: Optional[threading.Thread] = None
        self._thread_evt = threading.Event()
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._closed = False
        # counters (event-loop-only; see class docstring)
        self.delivered = 0
        self.dropped = 0
        #: Drop split: partition-cut vs random-loss (dropped = their sum)
        self.dropped_partition = 0
        self.dropped_loss = 0
        self.enqueued = 0
        #: Non-empty delivery passes — the scheduling unit that replaced
        #: task-per-message; delivered/pump_passes is the batch factor.
        self.pump_passes = 0
        self.max_tick_batch = 0
        self.trunk_msgs = 0
        self.trunk_drains = 0
        self.handler_errors = 0
        self.wait_total_s = 0.0

    # -- registration ------------------------------------------------------

    def register(self, address: Address, handler: Handler) -> None:
        """The reference's register_network_msg_handler equivalent
        (src/main.rs:190-204)."""
        self._handlers[_addr(address)] = handler

    def unregister(self, address: Address) -> None:
        self._handlers.pop(_addr(address), None)

    def set_batch_sink(self, sink: Optional[BatchSink]) -> None:
        self._sink = sink

    def peers(self) -> List[Address]:
        """Currently registered addresses (adversary behaviors address
        peers individually to equivocate/replay point-to-point)."""
        return list(self._handlers)

    # -- partitions --------------------------------------------------------

    def set_partition(self, *groups: Set[Address]) -> None:
        """Partition the network into the given groups; nodes in different
        groups cannot reach each other.  Call with no args to heal."""
        self._partition.set(groups)

    @property
    def partition_active(self) -> bool:
        return self._partition.groups is not None

    @property
    def partition_flips(self) -> int:
        return self._partition.flips

    # -- stats -------------------------------------------------------------

    def stats(self) -> dict:
        """Delivery/drop counters + live partition state for the sim
        JSON summary and /statusz — adversarial message loss must be
        attributable per run, not inferred from silence."""
        passes = max(1, self.pump_passes)
        return {
            "delivered": self.delivered,
            "dropped": self.dropped,
            "dropped_partition": self.dropped_partition,
            "dropped_loss": self.dropped_loss,
            "partition_active": self.partition_active,
            "partition_flips": self.partition_flips,
            "partitions": self._partition.render(),
            "registered": len(self._handlers),
            "enqueued": self.enqueued,
            "pump_passes": self.pump_passes,
            "avg_tick_batch": round(self.delivered / passes, 2),
            "max_tick_batch": self.max_tick_batch,
            #: vs the flat fabric's one task per delivered message: the
            #: pump schedules one pass per batch, so this ratio IS the
            #: task-churn reduction factor.
            "task_churn_reduction": round(self.delivered / passes, 2),
            "avg_delivery_wait_ms": round(
                1000.0 * self.wait_total_s / max(1, self.delivered), 3),
            "trunk_msgs": self.trunk_msgs,
            "trunk_drains": self.trunk_drains,
            "handler_errors": self.handler_errors,
        }

    # -- send paths --------------------------------------------------------

    async def broadcast(self, sender: Address, msg_type: str,
                        payload: bytes) -> None:
        """Deliver to every *other* registered node (origin 0 semantics,
        reference src/consensus.rs:673-710)."""
        s = _addr(sender)
        for addr in list(self._handlers):
            if addr != s:
                self._admit(s, addr, msg_type, payload)

    async def send(self, sender: Address, target: Address, msg_type: str,
                   payload: bytes) -> None:
        """Point-to-point delivery (send_msg semantics, reference
        src/consensus.rs:721-762)."""
        self._admit(_addr(sender), _addr(target), msg_type, payload)

    # -- admission (decisions) ---------------------------------------------

    def _admit(self, sender: bytes, target: bytes, msg_type: str,
               payload: bytes, via_trunk: bool = False) -> None:
        """Decide drop/delay for one directed delivery and enqueue it on
        this shard (the target's home shard).  Decisions happen at
        admission on the caller's loop slice — never in a worker thread
        — so the EdgeDecider's append-only counters stay single-threaded
        and the decision stream is identical in every worker mode."""
        if target not in self._handlers:
            return
        if not self._partition.can_reach(sender, target):
            self.dropped += 1
            self.dropped_partition += 1
            return
        delay = 0.0
        if self.drop_rate or self.delay_range[1] > 0:
            u_drop, u_delay = self._decider.decide(sender, target)
            if self.drop_rate and u_drop < self.drop_rate:
                self.dropped += 1
                self.dropped_loss += 1
                return
            lo, hi = self.delay_range
            if hi > 0:
                delay = lo + u_delay * (hi - lo)
        now = time.monotonic()
        item = (now + delay, target, sender, msg_type, payload, now,
                via_trunk, 0.0)
        with self._lock:
            if via_trunk:
                self._trunk_in.append(item)
                self.trunk_msgs += 1
            else:
                self._seq += 1
                heapq.heappush(self._heap, (item[0], self._seq) + item[1:])
        self.enqueued += 1
        self._wake()

    # -- pump --------------------------------------------------------------

    def _wake(self) -> None:
        if self._closed:
            return
        if self.worker == "thread":
            if self._thread is None:
                self._loop = asyncio.get_running_loop()
                self._thread = threading.Thread(
                    target=self._thread_main, daemon=True,
                    name=f"sim-router-shard{self.shard_id}")
                self._thread.start()
            self._thread_evt.set()
            return
        if self._pump_task is None or self._pump_task.done():
            self._loop = asyncio.get_running_loop()
            self._kick_evt = asyncio.Event()
            self._pump_task = self._loop.create_task(self._pump_loop())
        self._kick_evt.set()

    def _drain_trunk_locked(self) -> None:
        if self._trunk_in:
            self.trunk_drains += 1
            drained_at = time.monotonic()
            for item in self._trunk_in:
                self._seq += 1
                # Stamp the trunk-hop completion (the causal tracer's
                # trunk_hop stage is drained_at - enqueued_at).
                heapq.heappush(self._heap, (item[0], self._seq)
                               + item[1:7] + (drained_at,))
            self._trunk_in = []

    def _collect(self, now: float) -> List[tuple]:
        """Drain the trunk inbox, then pop everything due — one pass."""
        with self._lock:
            self._drain_trunk_locked()
            batch: List[tuple] = []
            while self._heap and self._heap[0][0] <= now:
                batch.append(heapq.heappop(self._heap))
            return batch

    def _next_due(self) -> Optional[float]:
        with self._lock:
            if self._trunk_in:
                return 0.0
            return self._heap[0][0] if self._heap else None

    async def _pump_loop(self) -> None:
        try:
            while not self._closed:
                batch = self._collect(time.monotonic())
                if batch:
                    await self._dispatch(batch)
                    # Yield one tick so the next pass coalesces a full
                    # tick's worth of arrivals instead of chasing each
                    # loop slice's trickle.
                    await asyncio.sleep(self.tick_s)
                    continue
                nxt = self._next_due()
                if nxt is not None:
                    delta = nxt - time.monotonic()
                    if delta > 0:
                        await asyncio.sleep(min(delta, self.tick_s))
                    continue
                self._kick_evt.clear()
                if self._next_due() is None:
                    await self._kick_evt.wait()
        except asyncio.CancelledError:
            pass

    def _thread_main(self) -> None:
        """Thread-mode pump: tick timing, trunk drain, and due-pop run
        on this worker; the pass itself is marshalled back to the event
        loop (engines, frontier, and controller are single-loop asyncio,
        so handlers must run there — the worker owns the schedule, not
        the handlers)."""
        while not self._closed:
            batch = self._collect(time.monotonic())
            if batch:
                loop = self._loop
                if loop is None or loop.is_closed():
                    return
                try:
                    loop.call_soon_threadsafe(self._dispatch_soon, batch)
                except RuntimeError:
                    return  # loop shut down mid-run
                self._thread_evt.wait(self.tick_s)
                self._thread_evt.clear()
                continue
            nxt = self._next_due()
            if nxt is None:
                self._thread_evt.wait()
            else:
                self._thread_evt.wait(
                    max(0.0, min(nxt - time.monotonic(), self.tick_s)))
            self._thread_evt.clear()

    def _dispatch_soon(self, batch: List[tuple]) -> None:
        task = self._loop.create_task(self._dispatch(batch))
        task.add_done_callback(lambda t: t.cancelled() or t.exception())

    async def _dispatch(self, batch: List[tuple]) -> None:
        """One delivery pass: everything due this tick, as one batch."""
        now = time.monotonic()
        n = len(batch)
        self.pump_passes += 1
        self.max_tick_batch = max(self.max_tick_batch, n)
        live: List[tuple] = []
        waits: List[float] = []
        for (due, _seq, target, sender, msg_type, payload, enq,
             via_trunk, drained_at) in batch:
            # A node that crashed after admission is off the network:
            # its in-flight messages vanish (the flat fabric fired them
            # into the dead handler instead).
            if target in self._handlers:
                live.append((target, sender, msg_type, payload,
                             (enq, due, drained_at, now, via_trunk)))
                waits.append(now - enq)
                self.wait_total_s += now - enq
        self.delivered += len(live)
        m = self._metrics
        if m is not None:
            shard = str(self.shard_id)
            m.sim_router_tick_batch.labels(shard=shard).observe(n)
            wait_obs = m.sim_router_delivery_wait_seconds.labels(shard=shard)
            for w in waits:
                wait_obs.observe(w)
        if not live:
            return
        if self._sink is not None:
            try:
                await self._sink(live)
            except Exception:  # noqa: BLE001 — BFT drop, pump must live
                self.handler_errors += 1
                logger.exception("batch sink failed (shard %d, %d msgs)",
                                 self.shard_id, len(live))
            return
        loop = asyncio.get_running_loop()
        for target, sender, msg_type, payload, _env in live:
            handler = self._handlers.get(target)
            if handler is None:
                continue
            task = loop.create_task(handler(sender, msg_type, payload))
            # Swallow handler failures (BFT drop); cancelled() guard keeps
            # loop shutdown from logging CancelledError via this callback.
            task.add_done_callback(lambda t: t.cancelled() or t.exception())

    def close(self) -> None:
        self._closed = True
        if self._pump_task is not None:
            self._pump_task.cancel()
            self._pump_task = None
        if self._thread is not None:
            self._thread_evt.set()
            self._thread.join(timeout=1.0)
            self._thread = None


class ShardedRouter:
    """S per-shard ``Router``s behind the flat-router facade.

    Validators are homed on a shard sticky-round-robin at first sight
    (crash/restart re-registers on the same shard), broadcast fans out
    in global registration order, and cross-shard traffic batches
    through the target shard's trunk inbox.  Drop/delay decisions come
    from one shared EdgeDecider and one shared partition state, so the
    decision stream — and therefore the delivered/dropped counters — is
    identical at any shard count for the same seed and topology."""

    def __init__(self, seed: int = 0, drop_rate: float = 0.0,
                 delay_range: tuple[float, float] = (0.0, 0.0),
                 shards: int = 1, worker: str = "inline",
                 tick_s: float = DEFAULT_TICK_S, metrics=None):
        self.seed = seed
        self.n_shards = max(1, int(shards))
        self.worker = worker
        self._decider = EdgeDecider(seed)
        self._partition = _PartitionState()
        self.shards = [Router(seed=seed, drop_rate=drop_rate,
                              delay_range=delay_range, tick_s=tick_s,
                              shard_id=k, decider=self._decider,
                              partition=self._partition, worker=worker,
                              metrics=metrics)
                       for k in range(self.n_shards)]
        #: Sticky home shard per address — survives unregister so a
        #: crash/restart cycle lands the node back on its shard.
        self._home: Dict[bytes, int] = {}
        #: Global registration order (drives broadcast fan-out order,
        #: shard-count-independent).
        self._registered: Dict[bytes, None] = {}

    # -- registration ------------------------------------------------------

    def shard_of(self, address: Address) -> int:
        a = _addr(address)
        k = self._home.get(a)
        if k is None:
            k = len(self._home) % self.n_shards
            self._home[a] = k
        return k

    def register(self, address: Address, handler: Handler) -> None:
        a = _addr(address)
        self.shards[self.shard_of(a)].register(a, handler)
        self._registered[a] = None

    def unregister(self, address: Address) -> None:
        a = _addr(address)
        k = self._home.get(a)
        if k is not None:
            self.shards[k].unregister(a)
        self._registered.pop(a, None)

    def set_batch_sink(self, sink: Optional[BatchSink]) -> None:
        for r in self.shards:
            r.set_batch_sink(sink)

    def peers(self) -> List[Address]:
        return list(self._registered)

    # -- config passthrough (chaos events retune loss mid-run) -------------

    @property
    def drop_rate(self) -> float:
        return self.shards[0].drop_rate

    @drop_rate.setter
    def drop_rate(self, rate: float) -> None:
        for r in self.shards:
            r.drop_rate = rate

    @property
    def delay_range(self) -> tuple[float, float]:
        return self.shards[0].delay_range

    @delay_range.setter
    def delay_range(self, rng: tuple[float, float]) -> None:
        for r in self.shards:
            r.delay_range = rng

    # -- partitions --------------------------------------------------------

    def set_partition(self, *groups: Set[Address]) -> None:
        self._partition.set(groups)

    @property
    def partition_active(self) -> bool:
        return self._partition.groups is not None

    @property
    def partition_flips(self) -> int:
        return self._partition.flips

    # -- send paths --------------------------------------------------------

    async def broadcast(self, sender: Address, msg_type: str,
                        payload: bytes) -> None:
        s = _addr(sender)
        for target in list(self._registered):
            if target != s:
                self._route(s, target, msg_type, payload)

    async def send(self, sender: Address, target: Address, msg_type: str,
                   payload: bytes) -> None:
        self._route(_addr(sender), _addr(target), msg_type, payload)

    def _route(self, sender: bytes, target: bytes, msg_type: str,
               payload: bytes) -> None:
        kt = self._home.get(target)
        if kt is None:
            return
        ks = self._home.get(sender)
        self.shards[kt]._admit(sender, target, msg_type, payload,
                               via_trunk=(ks is not None and ks != kt))

    # -- stats -------------------------------------------------------------

    _SUM_KEYS = ("delivered", "dropped", "dropped_partition",
                 "dropped_loss", "enqueued", "pump_passes", "trunk_msgs",
                 "trunk_drains", "handler_errors")

    def stats(self) -> dict:
        per = [r.stats() for r in self.shards]
        agg: dict = {k: sum(p[k] for p in per) for k in self._SUM_KEYS}
        passes = max(1, agg["pump_passes"])
        wait_total = sum(r.wait_total_s for r in self.shards)
        agg.update({
            "partition_active": self.partition_active,
            "partition_flips": self.partition_flips,
            "partitions": self._partition.render(),
            "registered": len(self._registered),
            "shards": self.n_shards,
            "worker": self.worker,
            "avg_tick_batch": round(agg["delivered"] / passes, 2),
            "max_tick_batch": max(p["max_tick_batch"] for p in per),
            "task_churn_reduction": round(agg["delivered"] / passes, 2),
            "avg_delivery_wait_ms": round(
                1000.0 * wait_total / max(1, agg["delivered"]), 3),
            "per_shard": [{"shard": i,
                           "registered": p["registered"],
                           "delivered": p["delivered"],
                           "dropped": p["dropped"],
                           "pump_passes": p["pump_passes"],
                           "avg_tick_batch": p["avg_tick_batch"],
                           "max_tick_batch": p["max_tick_batch"],
                           "trunk_msgs": p["trunk_msgs"]}
                          for i, p in enumerate(per)],
        })
        return agg

    def close(self) -> None:
        for r in self.shards:
            r.close()
