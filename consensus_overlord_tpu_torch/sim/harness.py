"""Multi-validator simulation harness: N engines + router + fake controller
in one asyncio loop — the minimum end-to-end slice of SURVEY.md §7 and the
scaffold for the BASELINE.md fleet configs.

The port's own copy of consensus_overlord_tpu/sim/harness.py
(the port imports nothing of the JAX package).
"""

from __future__ import annotations

import asyncio
import logging
from typing import Dict, List, Optional, Sequence

from ..core.types import Address, Commit, Hash, Node, Status, decode_wire_message
from ..crypto.provider import CryptoProvider
from ..engine.smr import Engine
from ..engine.wal import MemoryWal
from ..ports import Wal
from .controller import SimController
from .router import DEFAULT_TICK_S, Router, ShardedRouter

logger = logging.getLogger("consensus_overlord_tpu_torch.sim")

#: Decode-dedup cache bound for the batch sink — cleared wholesale on
#: overflow (adversary floods are the only unique-payload firehose).
_DECODE_CACHE_MAX = 4096
_MISSING = object()


class SimAdapter:
    """ConsensusAdapter wired to the sim router + fake controller — the
    in-process Brain (reference src/consensus.rs:491-780)."""

    def __init__(self, name: Address, router: Router,
                 controller: SimController):
        self.name = bytes(name)
        self.router = router
        self.controller = controller
        self.view_changes: List[tuple[int, int, str]] = []
        self.errors: List[str] = []

    async def get_block(self, height: int):
        content, block_hash = await self.controller.get_proposal(height)
        return content, block_hash

    async def check_block(self, height: int, block_hash: Hash,
                          content: bytes) -> bool:
        return await self.controller.check_proposal(height, block_hash, content)

    async def commit(self, height: int, commit: Commit) -> Optional[Status]:
        return await self.controller.commit_block(self.name, height, commit)

    async def get_authority_list(self, height: int) -> List[Node]:
        return self.controller.authority_list()

    async def broadcast_to_other(self, msg_type: str, payload: bytes) -> None:
        await self.router.broadcast(self.name, msg_type, payload)

    async def transmit_to_relayer(self, relayer: Address, msg_type: str,
                                  payload: bytes) -> None:
        await self.router.send(self.name, relayer, msg_type, payload)

    def report_error(self, context: str) -> None:
        self.errors.append(context)
        logger.warning("[%s] error: %s", self.name[:4].hex(), context)

    def report_view_change(self, height: int, round: int, reason: str) -> None:
        self.view_changes.append((height, round, reason))
        logger.info("[%s] view change h=%d r=%d: %s",
                    self.name[:4].hex(), height, round, reason)


class SimNode:
    """One validator: crypto + WAL + adapter + engine + network registration.

    use_frontier: verify inbound signatures at a batching frontier
    (crypto/frontier.py) instead of one-at-a-time inside the engine — the
    device-shaped configuration (SURVEY.md §7 "batching frontier")."""

    def __init__(self, crypto: CryptoProvider, router: Router,
                 controller: SimController, wal: Optional[Wal] = None,
                 use_frontier: bool = False, frontier_max_batch: int = 1024,
                 frontier_linger_s: float = 0.002, metrics=None,
                 recorder=None, node_seed: int = 0, profiler=None,
                 frontier_factory=None, causal=None):
        from ..crypto.frontier import BatchingVerifier
        from .adversary import AdversaryShim

        self.crypto = crypto
        self.wal = wal if wal is not None else MemoryWal(metrics=metrics)
        self.adapter = SimAdapter(crypto.pub_key, router, controller)
        #: Every node carries the adversary shim — transparent until a
        #: chaos `byzantine` event (or SimNetwork.set_behavior) arms a
        #: behavior, so any validator can turn coat mid-run.
        self.adversary = AdversaryShim(self.adapter, crypto, router,
                                       seed=node_seed, recorder=recorder)
        #: frontier_factory(crypto) -> frontier-shaped object lets a
        #: fleet feed a SHARED multi-tenant core (crypto/tenancy.py
        #: TenantLane — one tenant per chain) instead of a private
        #: per-node BatchingVerifier.  A shared lane's close() is a
        #: no-op, so node teardown never tears the core out from under
        #: other tenants; the harness owner closes the core.
        if frontier_factory is not None:
            self.frontier = frontier_factory(crypto)
        else:
            self.frontier = (BatchingVerifier(crypto, frontier_max_batch,
                                              frontier_linger_s,
                                              metrics=metrics,
                                              recorder=recorder)
                             if use_frontier else None)
        self.recorder = recorder
        if metrics is not None:
            bind = getattr(crypto, "bind_metrics", None)
            if bind is not None:
                bind(metrics)
        if profiler is not None:
            bindp = getattr(crypto, "bind_profiler", None)
            if bindp is not None:
                bindp(profiler)
        self.profiler = profiler
        breaker = getattr(crypto, "breaker", None)
        if breaker is not None and recorder is not None:
            breaker.recorder = recorder
        self.engine = Engine(crypto.pub_key, self.adversary, crypto,
                             self.wal, frontier=self.frontier,
                             metrics=metrics, recorder=recorder,
                             causal=causal)
        self.adversary.engine = self.engine  # leader_of follows its rotation
        self.router = router
        self._task: Optional[asyncio.Task] = None
        router.register(crypto.pub_key, self._on_network_msg)

    @property
    def name(self) -> bytes:
        return self.crypto.pub_key

    async def _on_network_msg(self, sender: Address, msg_type: str,
                              payload: bytes) -> None:
        """Inbound path: decode-and-inject, logging-and-dropping garbage
        (the reference's proc_network_msg, src/consensus.rs:210-262)."""
        try:
            msg = decode_wire_message(msg_type, payload)
        except Exception:  # noqa: BLE001 — malformed input is never fatal
            logger.warning("[%s] dropped malformed %s", self.name[:4].hex(),
                           msg_type)
            return
        await self.engine.inject_inbound(msg)

    def start(self, init_height: int, interval_ms: int,
              authority_list: Sequence[Node]) -> None:
        self._task = asyncio.get_running_loop().create_task(
            self.engine.run(init_height, interval_ms, list(authority_list)))

    async def stop(self) -> None:
        self.engine.stop()
        self.router.unregister(self.name)
        if self._task is not None:
            try:
                await asyncio.wait_for(self._task, 5.0)
            except (asyncio.TimeoutError, asyncio.CancelledError):
                self._task.cancel()
            self._task = None
        if self.frontier is not None:
            self.frontier.close()  # don't leak the dispatch worker thread

    def crash(self) -> None:
        """Abrupt teardown — the kill -9 analog: cancel the engine task
        mid-flight (no graceful drain, no final WAL write beyond what
        write-ahead already persisted) and drop off the network.  The
        node can be rebuilt from its WAL via SimNetwork.restart_node."""
        self.router.unregister(self.name)
        if self._task is not None:
            self._task.cancel()
            self._task = None
        if self.frontier is not None:
            self.frontier.close()


class SimNetwork:
    """A fleet of N in-process validators running real consensus."""

    def __init__(self, n_validators: int = 4, block_interval_ms: int = 200,
                 seed: int = 0, drop_rate: float = 0.0,
                 delay_range: tuple[float, float] = (0.0, 0.0),
                 crypto_factory=None, use_frontier: bool = False,
                 frontier_linger_s: float = 0.002, metrics=None,
                 flight_recorder_capacity: int = 0, wal_factory=None,
                 sim_device_crypto: bool = False,
                 device_breaker_cooldown_s: float = 0.25,
                 profiler=None, frontier_factory=None,
                 shared_frontier=None, shards: int = 1,
                 shard_workers: str = "inline",
                 router_tick_s: float = DEFAULT_TICK_S, causal=None):
        """metrics: one shared obs.Metrics for the whole fleet (histograms
        aggregate across nodes — fine for sim-level batch/round shape).
        profiler: one shared obs.prof.DeviceProfiler — providers with a
        device path (CudaBlsCrypto, SimDeviceCrypto) then record staged
        per-call round profiles into it.
        flight_recorder_capacity > 0 gives every node its own event ring;
        dump_flight_recorders() renders them all for failure forensics.
        wal_factory(i) -> Wal gives node i a durable WAL (chaos runs pass
        a per-node FileWal so crash-restart exercises the disk recovery
        path); None = per-node MemoryWal.
        sim_device_crypto: wrap breaker-less providers in
        SimDeviceCrypto (crypto/provider.py) so chaos `device_fault`
        events have a circuit breaker + simulated device path to break
        even in CPU-only fleets; providers that already carry a breaker
        (CudaBlsCrypto) are left alone.
        shared_frontier: the SharedFrontier core behind frontier_factory
        lanes, when the fleet rides one — held for introspection (chaos
        tenant events, run summaries); the caller owns its lifecycle
        (SimNetwork.stop never closes it).
        shards / shard_workers / router_tick_s: the sharded fabric shape
        (sim/router.py ShardedRouter) — S per-shard pumps in "inline"
        (deterministic, CI) or "thread" (per-shard worker thread) mode,
        delivering per-tick batches through the decode-dedup sink.
        causal: one shared obs.causal.CommitTracer for the fleet —
        every engine records send/receive/quorum/commit events into it
        and the sink threads the router's delivery envelopes through,
        so per-height commit critical paths are attributable."""
        from ..obs.flightrec import FlightRecorder

        if crypto_factory is None:
            # Ed25519 when the `cryptography` package is present, else
            # the dependency-free sim-grade provider (crypto/provider.py
            # sim_crypto) — an environment without the optional package
            # loses signature realism, not the whole simulation.
            from ..crypto.provider import sim_crypto

            crypto_factory = lambda i: sim_crypto(  # noqa: E731
                i.to_bytes(4, "big") * 8)
        self.shards = max(1, int(shards))
        self.shard_workers = shard_workers
        self.router = ShardedRouter(seed=seed, drop_rate=drop_rate,
                                    delay_range=delay_range,
                                    shards=self.shards,
                                    worker=shard_workers,
                                    tick_s=router_tick_s, metrics=metrics)
        cryptos = [crypto_factory(i) for i in range(n_validators)]
        if sim_device_crypto:
            from ..crypto.breaker import CircuitBreaker
            from ..crypto.provider import SimDeviceCrypto

            cryptos = [c if getattr(c, "breaker", None) is not None
                       else SimDeviceCrypto(
                           c, breaker=CircuitBreaker(
                               failure_threshold=3,
                               cooldown_s=device_breaker_cooldown_s,
                               metrics=metrics),
                           metrics=metrics)
                       for c in cryptos]
        self.controller = SimController(
            [c.pub_key for c in cryptos], block_interval_ms)
        self.metrics = metrics
        self.profiler = profiler
        self._use_frontier = use_frontier
        self._frontier_linger_s = frontier_linger_s
        self._frontier_factory = frontier_factory
        self.shared_frontier = shared_frontier
        self._wal_factory = wal_factory
        self.causal = causal
        self.nodes = [SimNode(c, self.router, self.controller,
                              wal=(wal_factory(i) if wal_factory is not None
                                   else None),
                              use_frontier=use_frontier,
                              frontier_linger_s=frontier_linger_s,
                              metrics=metrics,
                              recorder=(FlightRecorder(
                                  flight_recorder_capacity)
                                  if flight_recorder_capacity > 0 else None),
                              node_seed=seed ^ (0x9E3779B9 * (i + 1)),
                              profiler=profiler,
                              frontier_factory=frontier_factory,
                              causal=causal)
                      for i, c in enumerate(cryptos)]
        self._by_addr: Dict[bytes, SimNode] = {n.name: n for n in self.nodes}
        self._decode_cache: Dict[tuple, object] = {}
        self.router.set_batch_sink(self._deliver_batch)
        self.controller.on_new_height.append(self._push_status)

    async def _deliver_batch(self, items) -> None:
        """Per-shard pump sink (sim/router.py BatchSink): decode each
        unique wire payload ONCE per fleet — a broadcast reaches n-1
        inboxes but is one cache entry (message types are frozen
        dataclasses, so sharing the decoded object is safe) — then
        inject per target engine as one batch, so a single frontier
        linger window covers the whole delivery pass.

        Decoded messages are SHARED across targets (frozen dataclasses),
        so per-delivery provenance cannot ride the message objects: the
        router's delivery envelopes travel as a parallel list into
        inject_inbound_batch instead, keyed positionally."""
        cache = self._decode_cache
        by_node: Dict[bytes, list] = {}
        env_by_node: Dict[bytes, list] = {}
        for target, sender, msg_type, payload, env in items:
            key = (msg_type, payload)
            msg = cache.get(key, _MISSING)
            if msg is _MISSING:
                try:
                    msg = decode_wire_message(msg_type, payload)
                except Exception:  # noqa: BLE001 — malformed is never fatal
                    msg = None
                    logger.warning("dropped malformed %s", msg_type)
                if len(cache) >= _DECODE_CACHE_MAX:
                    cache.clear()
                cache[key] = msg
            if msg is None:
                continue
            by_node.setdefault(target, []).append(msg)
            env_by_node.setdefault(target, []).append(env)
        coros = []
        for target, msgs in by_node.items():
            node = self._by_addr.get(target)
            # The router only delivers to registered addresses, so a
            # stale or missing cache entry (tests may swap net.nodes[i]
            # directly after a crash, bypassing restart_node) means a
            # fresh SimNode re-registered under this name: re-resolve
            # from the live roster rather than feeding a dead engine.
            if node is None or not node.engine.running:
                for cand in self.nodes:
                    if cand.name == target:
                        node = cand
                        if cand.engine.running:
                            break
                if node is not None:
                    self._by_addr[target] = node
            if node is not None:
                coros.append(node.engine.inject_inbound_batch(
                    msgs, envelopes=env_by_node.get(target)))
        if not coros:
            return
        for res in await asyncio.gather(*coros, return_exceptions=True):
            if isinstance(res, BaseException) \
                    and not isinstance(res, asyncio.CancelledError):
                logger.warning("batch inject failed: %r", res)

    def dump_flight_recorders(self, n: Optional[int] = None) -> str:
        """Every node's flight-recorder tail, labeled — attach to test
        failures so a wedged Byzantine schedule is diagnosable post-hoc."""
        out = []
        for node in self.nodes:
            if node.recorder is not None:
                out.append(f"--- node {node.name[:4].hex()} "
                           f"(last {n or len(node.recorder)} events) ---\n"
                           f"{node.recorder.dump(n)}")
        return "\n".join(out)

    def _push_status(self, height: int) -> None:
        """Reconfigure-push: hand every engine the next-height Status, as the
        CITA-Cloud controller does after each committed block; engines ignore
        stale heights, lagging engines jump forward (resync)."""
        status = self.controller.next_status(height)
        for node in self.nodes:
            if node._task is not None and not node._task.done():
                node.engine.handler.send_msg(status)

    def crash_node(self, i: int) -> None:
        """Abruptly kill validator i (engine task cancelled, off the
        network).  Its WAL survives — restart_node resumes from it."""
        self.nodes[i].crash()

    def set_behavior(self, i: int, behavior: Optional[str]) -> None:
        """Arm (or, with None, disarm) an adversary behavior on
        validator i — sim/adversary.py names them; chaos `byzantine`
        events toggle this on the height timeline."""
        self.nodes[i].adversary.arm(behavior)

    def restart_node(self, i: int) -> SimNode:
        """Rebuild validator i from its WAL on the same keys/address —
        the crash-recovery path (WAL apply + controller-height init, the
        ping_controller resume, reference src/consensus.rs:264-292).
        A fresh FileWal re-reads the disk state the crashed life wrote;
        without a wal_factory the old in-memory WAL object (the node's
        'disk') carries over.  The flight recorder carries over too, so
        post-mortems span the crash."""
        old = self.nodes[i]
        wal = (self._wal_factory(i) if self._wal_factory is not None
               else old.wal)
        node = SimNode(old.crypto, self.router, self.controller, wal=wal,
                       use_frontier=self._use_frontier,
                       frontier_linger_s=self._frontier_linger_s,
                       metrics=self.metrics, recorder=old.recorder,
                       node_seed=old.adversary.seed,
                       profiler=self.profiler,
                       frontier_factory=self._frontier_factory,
                       causal=self.causal)
        # Adversary tallies span the crash like the flight recorder does
        # (run assertions read them after the schedule has played out);
        # so does the observed view-change window the adaptive behavior
        # reads its storm signal from.
        node.adversary.behavior_stats = old.adversary.behavior_stats
        node.adversary.observed_view_changes = \
            old.adversary.observed_view_changes
        # The capture session (if sim/run.py attached one to this
        # node's engine) survives the restart too — a crashed node 0
        # must not silently end profiling for the rest of the run.
        node.engine.profile = old.engine.profile
        self.nodes[i] = node
        # Same address, new object: the batch sink routes by address
        # (and ShardedRouter re-homes it on its sticky shard).
        self._by_addr[node.name] = node
        node.start(self.controller.latest_height + 1,
                   self.controller.block_interval_ms,
                   self.controller.authority_list())
        return node

    def start(self, init_height: int = 0) -> None:
        authority = self.controller.authority_list()
        for node in self.nodes:
            node.start(init_height, self.controller.block_interval_ms,
                       authority)

    def device_fault(self) -> Optional[BaseException]:
        """The first device fault a node's frontier kept (crypto/tenancy.py
        SharedFrontier.fault), or None."""
        for node in self.nodes:
            fault = getattr(node.frontier, "fault", None)
            if fault is not None:
                return fault
        return None

    async def run_until_height(self, height: int, timeout: float = 30.0) -> None:
        """Wait until some node commits `height`: asyncio.TimeoutError
        after `timeout` s, RuntimeError as soon as a node's frontier
        holds a device fault (the engines drop what it failed, so the
        fleet would only stall)."""
        wait = asyncio.ensure_future(
            self.controller.wait_for_height(height, timeout))
        try:
            while True:
                await asyncio.wait({wait}, timeout=0.05)
                fault = self.device_fault()
                if fault is not None:
                    raise RuntimeError(
                        f"device fault: {type(fault).__name__}: "
                        f"{fault}") from fault
                if wait.done():
                    return wait.result()
        finally:
            wait.cancel()

    async def stop(self) -> None:
        await asyncio.gather(*(n.stop() for n in self.nodes))
        self.router.close()
