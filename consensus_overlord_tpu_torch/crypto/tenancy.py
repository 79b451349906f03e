"""Multi-tenant crypto-as-a-service: one shared device frontier serving
many chains.

The reference runs one consensus process per chain (PAPER.md §0), so one
chain = one crypto backend.  The TPU inverts those economics: a single
chip at ~20.8k verifies/s (BENCH_r05) can carry dozens of chains' vote
traffic — but until this module, each engine built its own private
``BatchingVerifier`` and chains "shared" the device only by accident of
serialization: no fairness, no priority, and an unbounded pending queue
under saturation.

``SharedFrontier`` makes sharing the chip a first-class subsystem.  N
tenants (chains/engines, in-process) ``register()`` lanes that feed one
batching core:

  fairness    each flush is composed by deficit-weighted round-robin
              across tenants (``tenant_weight`` entries per cycle, the
              deficit carrying over when a batch cap cuts a turn short,
              the rotation start advancing every flush) — a tenant
              flooding its lane cannot push other tenants' requests out
              of a batch, only fill the slack they don't use
  priority    two classes per tenant: *critical* (proposal-path
              verifies — a late proposal stalls the whole round) and
              *gossip* (vote/choke verifies — late ones cost one vote's
              latency).  Within a tenant's turn the critical queue
              always drains first
  admission   per-tenant queues are bounded (``queue_bound``).  Arrivals
              over the bound are not dropped and not queued: they are
              **shed to the host-oracle verify path** —
              ``provider.verify_signature``, the exact same host twin
              the circuit breaker falls back to — so correctness
              is never traded for flow control, only device batching.
              Sheds count into ``frontier_admission_sheds_total{tenant}``

plus per-tenant observability: queue-wait histograms split by class
(``frontier_tenant_queue_wait_ms{tenant,lane}``), batch occupancy share
(``frontier_tenant_lanes_total`` / ``frontier_tenant_share``), and a
``tenants_status()`` snapshot for the /statusz "tenants" section.

``BatchingVerifier`` (crypto/frontier.py) is now a single-tenant lane
over a core it owns, so the existing service/sim/bench paths ride this
code — and inherit the bounded-queue shed (the stalled-device fix):
before, a wedged device let pending verifies grow without limit.

The dispatch machinery is unchanged from the proven single-tenant
frontier: one dedicated dispatch worker keeps device dispatch order
FIFO across flushes (a cold jit compile or remote-PJRT H2D never stalls
the event loop), and readback blocks only a resolver thread.  A batch
whose provider call raised is re-verified lane by lane on the host
oracle only when the provider has no circuit breaker of its own.  A
provider with one (CudaBlsCrypto, SimDeviceCrypto) has already fallen
back on the faults it was built to survive, so an exception that still
escapes it is a device fault: the batch's waiters get the exception,
the frontier keeps it as ``fault`` and counts it in
``stats.device_faults``, and nothing moves the work to the host.

The port's own copy of consensus_overlord_tpu/crypto/tenancy.py
(the port imports nothing of the JAX package).
"""

from __future__ import annotations

import asyncio
import logging
import time
from collections import Counter as _Counter
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Deque, Dict, List, Optional, Tuple

from ..core.sm3 import sm3_hash
from ..core.types import SignedChoke, SignedProposal, SignedVote
from ..obs.fleet import next_round_id, tag_round
from ..obs.prof import annotate
from .provider import CryptoError

logger = logging.getLogger("consensus_overlord_tpu_torch.tenancy")

__all__ = [
    "DEFAULT_QUEUE_BOUND",
    "FrontierStats",
    "SharedFrontier",
    "TenantLane",
    "TenantStats",
    "signature_claims",
]

#: Default per-tenant pending bound: 8× the default max_batch — deep
#: enough that a healthy device never sheds (it drains max_batch per
#: flush), shallow enough that a stalled device sheds to the host
#: oracle instead of accumulating unbounded futures.
DEFAULT_QUEUE_BOUND = 8192

#: Recent queue-wait samples kept per tenant for the /statusz p50 (the
#: full distributions live in the Prometheus histograms).
WAIT_WINDOW = 512


def signature_claims(msg) -> Optional[Tuple[bytes, bytes, bytes]]:
    """(signature, hash32, voter) claimed by an inbound consensus message,
    or None for message types verified elsewhere (QCs carry aggregated
    signatures checked in the engine against the voter bitmap)."""
    if isinstance(msg, SignedProposal):
        return (msg.signature, sm3_hash(msg.proposal.encode()),
                msg.proposal.proposer)
    if isinstance(msg, SignedVote):
        return msg.signature, sm3_hash(msg.vote.encode()), msg.voter
    if isinstance(msg, SignedChoke):
        return msg.signature, sm3_hash(msg.choke.encode()), msg.address
    return None


def is_critical(msg) -> bool:
    """Proposal-path verifies are critical: one late proposal stalls the
    whole round for every honest node, while a late vote costs only that
    vote's latency (the QC needs 2f+1 of n anyway)."""
    return isinstance(msg, SignedProposal)


@dataclass
class FrontierStats:
    """Whole-core counters (the single-tenant frontier's legacy shape —
    /statusz "frontier" and the bench scripts read these).  `requests`
    counts only batched-path requests so `mean_batch` keeps its meaning
    under shedding; shed requests count in `sheds` (total arrivals =
    requests + sheds).  `reverified` counts the batches of a
    breaker-less provider whose call raised and that were re-verified
    on the host oracle; `device_faults` counts the calls of a provider
    with a breaker that raised (see SharedFrontier.fault).  A run can
    fail on either."""

    requests: int = 0
    batches: int = 0
    max_batch: int = 0
    failures: int = 0
    sheds: int = 0
    reverified: int = 0
    device_faults: int = 0

    @property
    def mean_batch(self) -> float:
        return self.requests / self.batches if self.batches else 0.0


@dataclass
class TenantStats:
    """One tenant's counters + a bounded queue-wait window."""

    requests: int = 0
    critical_requests: int = 0
    sheds: int = 0
    failures: int = 0
    #: Device-batch lanes this tenant's requests filled (its share of
    #: the chip; compare across tenants for occupancy fairness).
    lanes_contributed: int = 0
    waits: Deque[Tuple[float, bool]] = field(
        default_factory=lambda: deque(maxlen=WAIT_WINDOW))

    def record_wait(self, wait_s: float, critical: bool) -> None:
        self.waits.append((wait_s, critical))

    def p50_wait_ms(self, critical: Optional[bool] = None) -> Optional[float]:
        """Median recent queue wait in ms (critical=True/False filters to
        one class; None spans both), or None with no samples yet."""
        samples = sorted(w for w, c in self.waits
                         if critical is None or c == critical)
        if not samples:
            return None
        return samples[len(samples) // 2] * 1000.0


class TenantLane:
    """One tenant's handle onto a SharedFrontier: the frontier interface
    the engine consumes (verify / verify_msg / verify_aggregated /
    aggregate), scoped to this tenant's queues, weight, and bound.

    A lane may be shared by every validator of one chain (the tenant =
    the chain): queues, stats, and fairness are per-tenant, not
    per-caller.  ``close()`` is a no-op — the shared core outlives any
    one lane; the core's owner closes it (``BatchingVerifier``, which
    owns its core, overrides this)."""

    def __init__(self, core: "SharedFrontier", tenant_id: str,
                 weight: int = 1, queue_bound: int = DEFAULT_QUEUE_BOUND,
                 priority_lanes: bool = True):
        if weight < 1:
            raise ValueError(f"tenant weight must be >= 1, got {weight}")
        if queue_bound < 1:
            raise ValueError(
                f"tenant queue bound must be >= 1, got {queue_bound}")
        self._core = core
        self.tenant_id = str(tenant_id)
        self.weight = int(weight)
        self.queue_bound = int(queue_bound)
        self.priority_lanes = bool(priority_lanes)
        self.tenant_stats = TenantStats()
        #: DWRR deficit: carries over when a batch cap cuts this
        #: tenant's turn short, so the shortfall is repaid next flush.
        self._deficit = 0.0
        #: Pending entries by class; composed into device batches by the
        #: core's DWRR pass (critical always pops first).
        self._critical: Deque[tuple] = deque()
        self._gossip: Deque[tuple] = deque()
        #: Entries composed into a device batch whose futures have not
        #: resolved yet.  They count toward the admission bound: a
        #: stalled device drains the WAITING queue at every flush but
        #: leaves these accumulating — without them in the bound, the
        #: unbounded-growth failure just moves from pending to in-flight.
        self._in_flight = 0

    # -- queue plumbing (called by the core under the event loop) ----------

    def pending_count(self) -> int:
        return len(self._critical) + len(self._gossip)

    def outstanding_count(self) -> int:
        """Waiting + composed-but-unresolved — what the admission bound
        actually limits (the tenant's total unresolved futures)."""
        return self.pending_count() + self._in_flight

    def _pop_next(self) -> tuple:
        return self._critical.popleft() if self._critical \
            else self._gossip.popleft()

    # -- stats -------------------------------------------------------------

    @property
    def stats(self) -> TenantStats:
        return self.tenant_stats

    def status(self) -> dict:
        """JSON-encodable snapshot for /statusz "tenants"."""
        s = self.tenant_stats
        return {
            "weight": self.weight,
            "queue_bound": self.queue_bound,
            "priority_lanes": self.priority_lanes,
            "queued": self.pending_count(),
            "queued_critical": len(self._critical),
            "in_flight": self._in_flight,
            "requests": s.requests,
            "critical_requests": s.critical_requests,
            "sheds": s.sheds,
            "failures": s.failures,
            "lanes_contributed": s.lanes_contributed,
            "p50_wait_ms": s.p50_wait_ms(),
            "p50_critical_wait_ms": s.p50_wait_ms(critical=True),
        }

    # -- the frontier interface (what the engine consumes) -----------------

    async def verify(self, signature: bytes, hash32: bytes, voter: bytes,
                     msg_type: str = "raw", critical: bool = False) -> bool:
        if critical and not self.priority_lanes:
            critical = False
        return await self._core.submit(self, bytes(signature), bytes(hash32),
                                       bytes(voter), msg_type, critical)

    async def verify_msg(self, msg) -> bool:
        """Verify a decoded consensus message's signature claim; True for
        message types with no frontier-checkable signature.  Proposals
        ride the critical class (see is_critical)."""
        claims = signature_claims(msg)
        if claims is None:
            return True
        return await self.verify(*claims, msg_type=type(msg).__name__,
                                 critical=is_critical(msg))

    def verify_msg_nowait(self, msg):
        """Sync-admission twin of verify_msg: ``True`` when the message
        carries no frontier-checkable claim, else an awaitable verdict
        whose claim is ALREADY enqueued at the core (see
        SharedFrontier.submit_nowait).  The sim fabric's per-tick batch
        injection submits every claim in a delivery pass before awaiting
        any, so one linger window covers the whole pass."""
        claims = signature_claims(msg)
        if claims is None:
            return True
        signature, hash32, voter = claims
        critical = is_critical(msg) and self.priority_lanes
        return self._core.submit_nowait(
            self, bytes(signature), bytes(hash32), bytes(voter),
            type(msg).__name__, critical)

    async def verify_aggregated(self, agg_sig: bytes, hash32: bytes,
                                voters) -> bool:
        return await self._core.verify_aggregated(agg_sig, hash32, voters)

    async def aggregate(self, signatures, voters) -> bytes:
        return await self._core.aggregate(signatures, voters)

    @property
    def last_agg_round_id(self) -> Optional[int]:
        """Round id of the core's most recent aggregate-path dispatch
        (the engine reads it through its lane handle right after a QC
        verify/aggregate await to link the commit trace — see
        SharedFrontier.last_agg_round_id)."""
        return self._core.last_agg_round_id

    @property
    def fault(self) -> Optional[BaseException]:
        """The core's first device fault (SharedFrontier.fault)."""
        return self._core.fault

    def close(self) -> None:
        """Lanes don't own the core (see class docstring)."""

    def tenants_status(self) -> dict:
        """Mirror the core's tenant snapshot (so a lane handle can serve
        the /statusz "tenants" section directly)."""
        return self._core.tenants_status()


class SharedFrontier:
    """The shared device batching core N tenant lanes feed.

    provider: the crypto backend every composed batch dispatches
    through (``verify_batch`` / ``verify_batch_async``); its
    ``verify_signature`` host oracle serves the shed and batch-error
    fallbacks (for CudaBlsCrypto that is the CPU pairing backend — the
    circuit breaker's fallback).
    max_batch: flush immediately at this many pending entries across
    all tenants (the device pad-ladder cap).
    linger_s: how long the first pending request waits for company.
    metrics: optional obs.Metrics — per-tenant families carry the
    tenant label; None = zero overhead.
    """

    def __init__(self, provider, max_batch: int = 1024,
                 linger_s: float = 0.002, metrics=None, recorder=None):
        self._provider = provider
        self._max_batch = int(max_batch)
        self._linger = linger_s
        self._metrics = metrics
        #: Optional obs.FlightRecorder: each flush records a
        #: `round_flush` event carrying the round id the dispatch is
        #: tagged with (obs/fleet.py) — the waterfall's anchor event.
        self._recorder = recorder
        self._lanes: Dict[str, TenantLane] = {}
        #: Registration order = DWRR rotation order; the start position
        #: advances every flush so no tenant owns the batch head.
        self._order: List[TenantLane] = []
        self._rr_cursor = 0
        self._total_pending = 0
        self._flush_task: Optional[asyncio.Task] = None
        # asyncio holds only weak refs to tasks; in-flight batch tasks
        # must be pinned or GC can collect one mid-verify, hanging every
        # waiter.
        self._inflight: set = set()
        # One dedicated dispatch worker: device dispatches (which may
        # block on a cold jit compile — minutes for a new batch shape —
        # or on H2D transfers over a remote PJRT link) run OFF the event
        # loop, and the single worker keeps dispatch order FIFO across
        # flushes so pipelining stays deterministic.
        self._dispatcher = ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="frontier-dispatch")
        #: Chaos stall window (sim/chaos.py `tenant_stall`): monotonic
        #: deadline before which composed batches sleep instead of
        #: dispatching — the wedged-shared-chip failure mode.  Only the
        #: batch path stalls; QC aggregate verifies have no bounded
        #: shed alternative and stalling them would wedge consensus
        #: outright rather than exercise flow control.
        self._stall_until = 0.0
        #: A provider with its own circuit breaker degrades on its own;
        #: what still raises out of it is a device fault (module doc).
        self._owns_fallback = getattr(provider, "breaker", None) is not None
        #: The first device fault, for the run to fail on.
        self.fault: Optional[BaseException] = None
        #: Round id (obs/fleet.py) of the most recent QC aggregate-path
        #: dispatch (verify_aggregated / aggregate): the causal commit
        #: tracer reads it right after its await resolves, linking the
        #: commit trace's qc_verify stage to the device-profile ring
        #: records the dispatch produced.  Best-effort under
        #: concurrency — provenance, not accounting.
        self.last_agg_round_id: Optional[int] = None
        self.stats = FrontierStats()

    # -- tenancy -----------------------------------------------------------

    def register(self, tenant_id: str, weight: int = 1,
                 queue_bound: int = DEFAULT_QUEUE_BOUND,
                 priority_lanes: bool = True) -> TenantLane:
        """Register a tenant; returns its lane.  Registering an existing
        id returns the existing lane unchanged (a chain's validators all
        feed one tenant)."""
        lane = self._lanes.get(str(tenant_id))
        if lane is not None:
            return lane
        return self.adopt(TenantLane(self, tenant_id, weight=weight,
                                     queue_bound=queue_bound,
                                     priority_lanes=priority_lanes))

    def adopt(self, lane: TenantLane) -> TenantLane:
        """Attach an externally-constructed lane (register()'s
        bookkeeping twin — BatchingVerifier adopts ITSELF, being both
        the lane subclass and the core's owner).  One registration site
        for all lane kinds, so future register-side bookkeeping can't
        silently skip the single-tenant path."""
        if lane.tenant_id in self._lanes:
            raise ValueError(f"tenant {lane.tenant_id!r} already "
                             "registered")
        self._lanes[lane.tenant_id] = lane
        self._order.append(lane)
        return lane

    @property
    def tenants(self) -> Dict[str, TenantLane]:
        return dict(self._lanes)

    def tenants_status(self) -> dict:
        """Per-tenant snapshot for the /statusz "tenants" section."""
        return {tid: lane.status() for tid, lane in self._lanes.items()}

    def inject_stall(self, duration_s: float) -> None:
        """Arm a device-stall window (chaos `tenant_stall`): for
        `duration_s` from now every composed batch sleeps before
        dispatching, so queues back up and the bounded admission path
        must shed to the host oracle — correctness survives a wedged
        shared chip through flow control, not luck.  Overlapping
        windows extend, never shorten."""
        self._stall_until = max(self._stall_until,
                                time.monotonic() + float(duration_s))
        logger.warning("frontier: chaos stall armed for %.2fs",
                       duration_s)

    @property
    def stall_injected(self) -> bool:
        return time.monotonic() < self._stall_until

    # -- admission + enqueue -----------------------------------------------

    async def submit(self, lane: TenantLane, signature: bytes, hash32: bytes,
                     voter: bytes, msg_type: str, critical: bool) -> bool:
        """One tenant verify: enqueue under the bound, shed over it."""
        return await self.submit_nowait(lane, signature, hash32, voter,
                                        msg_type, critical)

    def submit_nowait(self, lane: TenantLane, signature: bytes,
                      hash32: bytes, voter: bytes, msg_type: str,
                      critical: bool):
        """Sync-admission submit: bookkeeping and enqueue happen on the
        caller's loop slice; the verdict comes back as an awaitable (the
        entry future — or the shed coroutine on bound overflow).  Batch
        callers submit every claim first, then await, so one linger
        window covers them all instead of one per message.

        The bound counts OUTSTANDING work (waiting + composed-but-
        unresolved): composition drains the waiting queue at every
        flush whatever the device is doing, so a pending-only bound
        would never engage under the stalled device it exists for."""
        lane.tenant_stats.requests += 1
        if critical:
            lane.tenant_stats.critical_requests += 1
        if lane.outstanding_count() >= lane.queue_bound:
            self.stats.sheds += 1
            return self._shed(lane, signature, hash32, voter, msg_type)
        self.stats.requests += 1
        fut = asyncio.get_running_loop().create_future()
        entry = (signature, hash32, voter, fut, msg_type,
                 time.perf_counter(), lane, critical)
        (lane._critical if critical else lane._gossip).append(entry)
        self._total_pending += 1
        if self._total_pending >= self._max_batch:
            self._flush_now("max_batch")
        elif self._flush_task is None or self._flush_task.done():
            self._flush_task = asyncio.get_running_loop().create_task(
                self._linger_then_flush())
        return fut

    async def _shed(self, lane: TenantLane, signature: bytes, hash32: bytes,
                    voter: bytes, msg_type: str) -> bool:
        """Admission-control overflow: verify on the host oracle instead
        of queueing for the device.  The verdict is exact (the oracle is
        the breaker's fallback twin), so shedding costs device batching
        efficiency, never correctness."""
        lane.tenant_stats.sheds += 1
        m = self._metrics
        if m is not None:
            m.frontier_admission_sheds.labels(
                tenant=lane.tenant_id).inc()
        errored = False
        try:
            ok = bool(await asyncio.to_thread(
                self._provider.verify_signature, signature, hash32, voter))
        except Exception:  # noqa: BLE001 — malformed input is never fatal
            logger.exception("shed host verify errored (tenant %s)",
                             lane.tenant_id)
            ok = False
            errored = True
            if m is not None:
                # Same posture as the batch path's "batch_error": an
                # oracle infra error must not masquerade as a
                # per-message signature attack.
                m.frontier_verify_failures.labels(
                    msg_type="shed_error").inc()
        if not ok:
            self.stats.failures += 1
            lane.tenant_stats.failures += 1
            if m is not None and not errored:
                m.frontier_verify_failures.labels(msg_type=msg_type).inc()
        return ok

    # -- aggregate paths (shared ordered dispatcher) -----------------------

    async def verify_aggregated(self, agg_sig: bytes, hash32: bytes,
                                voters) -> bool:
        """QC aggregate verification off the event loop: dispatch through
        the same single ordered worker as batch flushes (device FIFO
        stays intact), block only in a resolver thread.  Like _run_batch
        the dispatch is round-tagged, so the device-profile ring records
        it produces join the commit trace's qc_verify stage on the id."""
        dispatch = getattr(self._provider, "verify_aggregated_async", None)
        round_id = next_round_id()
        self.last_agg_round_id = round_id
        try:
            if dispatch is None:
                def _host():
                    with tag_round(round_id):
                        return self._provider.verify_aggregated_signature(
                            agg_sig, hash32, voters)
                return await asyncio.to_thread(_host)
            return await self._via_dispatcher(dispatch, agg_sig, hash32,
                                              voters, round_id=round_id)
        except Exception as exc:  # noqa: BLE001 — malformed input is never fatal
            if self._owns_fallback:
                self._record_fault("verify_aggregated", exc)
                raise
            logger.exception("frontier QC verification errored")
            return False

    async def aggregate(self, signatures, voters) -> bytes:
        """QC signature aggregation off the event loop (leader path).
        Raises CryptoError on invalid input, like the sync form."""
        dispatch = getattr(self._provider, "aggregate_signatures_async",
                           None)
        round_id = next_round_id()
        self.last_agg_round_id = round_id
        try:
            if dispatch is None:
                def _host():
                    with tag_round(round_id):
                        return self._provider.aggregate_signatures(
                            signatures, voters)
                return await asyncio.to_thread(_host)
            return await self._via_dispatcher(dispatch, signatures, voters,
                                              round_id=round_id)
        except CryptoError:
            raise
        except Exception as exc:
            if self._owns_fallback:
                self._record_fault("aggregate", exc)
            raise

    def _record_fault(self, path: str, exc: BaseException) -> None:
        """A device fault out of a provider with its own breaker: count
        it and keep the first, for the run to fail on."""
        logger.error("frontier %s: device fault %s: %s", path,
                     type(exc).__name__, exc)
        self.stats.device_faults += 1
        if self.fault is None:
            self.fault = exc

    async def _via_dispatcher(self, dispatch, *args, round_id=None):
        """dispatch(*args) on the ordered worker → resolve() in a second
        thread (overlaps the dispatch→readback round-trip with device
        compute, same pipeline as _run_batch).  round_id tags both
        threads (thread-local, like _run_batch) so profiler records
        land under it."""
        loop = asyncio.get_running_loop()

        def _dispatch():
            with tag_round(round_id):
                return dispatch(*args)

        resolver = await loop.run_in_executor(self._dispatcher, _dispatch)

        def _resolve():
            with tag_round(round_id):
                return resolver()

        return await asyncio.to_thread(_resolve)

    # -- lifecycle ---------------------------------------------------------

    def close(self) -> None:
        """Release the dispatch worker thread (engine/sim teardown).
        Still-pending requests are flushed first (reason="shutdown") so
        their futures resolve instead of hanging their awaiters — only
        possible from a running event loop (the normal teardown path).
        The worker shuts down only after in-flight batch tasks (incl. a
        shutdown flush) have dispatched through it — shutting it down
        eagerly would bounce those batches onto the per-signature host
        re-verify fallback (RuntimeError from run_in_executor)."""
        try:
            loop = asyncio.get_running_loop()
        except RuntimeError:  # no loop: nothing can await those futures
            loop = None
            for lane in self._order:
                lane._critical.clear()
                lane._gossip.clear()
            self._total_pending = 0
        if self._total_pending:
            self._flush_now("shutdown")
        if loop is not None and self._inflight:
            dispatcher = self._dispatcher

            async def _drain_then_release(tasks):
                try:
                    await asyncio.gather(*tasks, return_exceptions=True)
                finally:
                    # Loop teardown can cancel this task mid-gather; the
                    # worker thread must be released regardless or each
                    # closed frontier leaks one non-daemon thread.
                    dispatcher.shutdown(wait=False)

            # Pinned in _inflight: asyncio holds only weak task refs
            # (see __init__) — an unpinned drain task can be GC'd
            # mid-await, leaking the worker thread.
            task = loop.create_task(_drain_then_release(
                list(self._inflight)))
            self._inflight.add(task)
            task.add_done_callback(self._inflight.discard)
        else:
            self._dispatcher.shutdown(wait=False)

    # -- flush machinery ---------------------------------------------------

    async def _linger_then_flush(self) -> None:
        await asyncio.sleep(self._linger)
        self._flush_now("linger")

    def _compose_batch(self) -> List[tuple]:
        """Deficit-weighted round robin across tenants with pending work,
        up to max_batch entries.  Each cycle a tenant earns `weight`
        slots; within its turn the critical queue drains first.  The
        deficit persists across flushes (a turn cut short by the batch
        cap is repaid next flush) and the rotation start advances every
        compose, so no tenant systematically owns the batch head."""
        n = len(self._order)
        if n == 0:
            return []
        start = self._rr_cursor % n
        self._rr_cursor += 1
        active = deque(lane for lane in
                       (self._order[start:] + self._order[:start])
                       if lane.pending_count() > 0)
        batch: List[tuple] = []
        while active and len(batch) < self._max_batch:
            lane = active.popleft()
            lane._deficit += lane.weight
            while (lane._deficit >= 1 and lane.pending_count() > 0
                   and len(batch) < self._max_batch):
                batch.append(lane._pop_next())
                lane._in_flight += 1
                lane._deficit -= 1
            if lane.pending_count() == 0:
                # Standard DWRR: an emptied queue forfeits its credit
                # (or an idle tenant would bank unbounded burst rights).
                lane._deficit = 0.0
            elif len(batch) < self._max_batch:
                active.append(lane)
            # Batch full with this lane still pending: its deficit
            # carries over — the next flush repays the cut-short turn.
        self._total_pending -= len(batch)
        return batch

    def _flush_now(self, reason: str) -> None:
        if self._flush_task is not None and not self._flush_task.done():
            self._flush_task.cancel()
        self._flush_task = None
        while self._total_pending > 0:
            batch = self._compose_batch()
            if not batch:
                break
            if self._metrics is not None:
                # Why the batch left the frontier: linger-expired vs
                # max-batch vs shutdown drain — without this the
                # queue-wait histogram is uninterpretable (a long wait
                # is EXPECTED under linger flushes, a red flag under
                # max-batch ones).
                self._metrics.frontier_flush_reason.labels(
                    reason=reason).inc()
            task = asyncio.get_running_loop().create_task(
                self._run_batch(batch))
            self._inflight.add(task)
            task.add_done_callback(self._inflight.discard)
            # Shutdown drains everything; normal flushes leave a
            # sub-max_batch remainder to the next linger window.
            if reason != "shutdown" and self._total_pending < self._max_batch:
                break
        if self._total_pending > 0 and reason != "shutdown":
            self._flush_task = asyncio.get_running_loop().create_task(
                self._linger_then_flush())

    def _account_batch(self, batch: List[tuple]) -> None:
        """Per-tenant occupancy share of one composed batch."""
        counts = _Counter(e[6] for e in batch)
        m = self._metrics
        for lane, c in counts.items():
            lane.tenant_stats.lanes_contributed += c
            if m is not None:
                m.frontier_tenant_lanes.labels(tenant=lane.tenant_id).inc(c)
        if m is not None:
            # Every registered tenant gets a share of THIS batch (absent
            # tenants explicitly 0) — a stale gauge from a batch a
            # tenant last rode would make the shares sum past 1 exactly
            # when load is skewed, the moment the gauge exists for.
            for lane in self._order:
                m.frontier_tenant_share.labels(tenant=lane.tenant_id).set(
                    counts.get(lane, 0) / len(batch))

    async def _run_batch(self, batch: List[tuple]) -> None:
        stall = self._stall_until - time.monotonic()
        if stall > 0:
            # Chaos tenant_stall: the "device" is wedged — hold the
            # composed batch (waiters included) until the window ends.
            await asyncio.sleep(stall)
        sigs = [b[0] for b in batch]
        hashes = [b[1] for b in batch]
        voters = [b[2] for b in batch]
        m = self._metrics
        # One round id per flush: the dispatcher thread is tagged with
        # it (a thread-local — run_in_executor does not carry
        # contextvars), so every StagedCall / per-device sample /
        # flightrec event this flush produces joins on it
        # (scripts/waterfall.py).
        round_id = next_round_id()
        if self._recorder is not None:
            now = time.perf_counter()
            oldest = min((b[5] for b in batch), default=now)
            self._recorder.record(
                "round_flush", round_id=round_id, batch=len(batch),
                queue_wait_s=round(max(now - oldest, 0.0), 6))
        self._account_batch(batch)
        if m is not None:
            # Batch size only; padded-rung occupancy is observed by the
            # provider at host-prep time (crypto/cuda_provider.py), where
            # the pad sizes are actually computed — one source of truth
            # across the fused/split dispatch plans.
            m.frontier_batch_size.observe(len(batch))
        try:
            verify_async = getattr(self._provider, "verify_batch_async",
                                   None)
            if verify_async is not None:
                # Dispatch through the single ordered worker (off-loop:
                # a cold compile or H2D transfer never stalls consensus
                # timers), then block only for the readback in a second
                # thread — consecutive flushes overlap the ~200 ms
                # dispatch→readback round-trip of a remote PJRT link
                # with device compute.
                loop = asyncio.get_running_loop()

                def _dispatch():
                    with tag_round(round_id):
                        return verify_async(sigs, hashes, voters)

                t0 = time.perf_counter()
                with annotate("frontier.flush"):
                    resolver = await loop.run_in_executor(
                        self._dispatcher, _dispatch)
                t1 = time.perf_counter()

                def _resolve():
                    # Readback/pairing (and the throttled per-device
                    # skew sample) run here — same round tag.
                    with tag_round(round_id):
                        return resolver()

                results = await asyncio.to_thread(_resolve)
                if m is not None:
                    # frontier_* phases are wrappers AROUND the provider's
                    # prep/dispatch/readback/pairing phases (they include
                    # executor queueing), distinct labels so the series
                    # compose instead of double-counting.
                    t2 = time.perf_counter()
                    m.crypto_dispatch_ms.labels(
                        phase="frontier_dispatch").observe(
                        (t1 - t0) * 1000.0)
                    m.crypto_dispatch_ms.labels(
                        phase="frontier_resolve").observe(
                        (t2 - t1) * 1000.0)
            else:
                # Device dispatch blocks; keep the event loop live.
                def _verify():
                    with tag_round(round_id):
                        return self._provider.verify_batch(sigs, hashes,
                                                           voters)

                t0 = time.perf_counter()
                results = await asyncio.to_thread(_verify)
                if m is not None:
                    m.crypto_dispatch_ms.labels(
                        phase="frontier_resolve").observe(
                        (time.perf_counter() - t0) * 1000.0)
            errored = False
        except Exception as exc:  # noqa: BLE001 — malformed input is never fatal
            if self._owns_fallback:
                # A device fault (module doc): every waiter of the batch
                # gets it; nothing is verified on the host.
                self._record_fault("verify_batch", exc)
                for _, _, _, fut, _, _, lane, _ in batch:
                    lane._in_flight -= 1
                    if not fut.done():
                        fut.set_exception(exc)
                return
            # A provider whose device path died mid-batch (and that has
            # no internal breaker/fallback of its own): re-verify every
            # lane on the host oracle — consensus keeps making progress
            # on exact verdicts instead of dropping a whole batch of
            # honest votes as if they were forged.
            logger.exception(
                "frontier batch verification errored; host re-verify")
            self.stats.reverified += 1
            if m is not None:
                m.host_fallbacks.labels(path="frontier_reverify").inc()
            try:
                results = await asyncio.to_thread(
                    lambda: [self._provider.verify_signature(s, h, v)
                             for s, h, v in zip(sigs, hashes, voters)])
                errored = False
            except Exception:  # noqa: BLE001 — even the oracle failed
                logger.exception("frontier host re-verify errored")
                results = [False] * len(batch)
                errored = True
                if m is not None:
                    # One event under its own label: an infra error must
                    # not masquerade as a per-message signature attack.
                    m.frontier_verify_failures.labels(
                        msg_type="batch_error").inc()
        self.stats.batches += 1
        self.stats.max_batch = max(self.stats.max_batch, len(batch))
        now = time.perf_counter()
        for (_, _, _, fut, msg_type, t_enq, lane, crit), ok in zip(batch,
                                                                   results):
            lane._in_flight -= 1
            wait_s = now - t_enq
            if not ok:
                self.stats.failures += 1
                lane.tenant_stats.failures += 1
                if m is not None and not errored:
                    m.frontier_verify_failures.labels(
                        msg_type=msg_type).inc()
            lane.tenant_stats.record_wait(wait_s, crit)
            if m is not None:
                m.frontier_queue_wait_ms.observe(wait_s * 1000.0)
                m.frontier_tenant_queue_wait_ms.labels(
                    tenant=lane.tenant_id,
                    lane="critical" if crit else "gossip").observe(
                    wait_s * 1000.0)
            if not fut.done():
                fut.set_result(bool(ok))
