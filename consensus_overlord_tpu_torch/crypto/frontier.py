"""The batching frontier: coalesce concurrent signature verifications into
device-sized batches.

The reference verifies each inbound vote synchronously inside the engine's
message loop, one native blst call at a time (src/consensus.rs:397-416).
On TPU a single verification can't pay for a device dispatch — but a
consensus round delivers N votes near-simultaneously.  The frontier sits
at the inbound-network edge (the proc_network_msg path,
src/consensus.rs:210-262): each message's signature check becomes an
awaitable; requests that arrive within one linger window (or up to a max
batch) flush together through the provider's ``verify_batch`` — which for
CudaBlsCrypto is two MSMs and the pairing on the card (SURVEY.md §7
"batching frontier" / hard part (c)).

Messages whose signatures fail are dropped at the frontier (the engine
then runs with ``inbound_verified=True`` and skips per-message verifies);
malformed input degrades to a False result, never an exception — the
log-and-drop posture of src/consensus.rs:220-260.

Since the multi-tenant refactor (crypto/tenancy.py) the batching core is
``SharedFrontier`` and ``BatchingVerifier`` is its single-tenant shape: a
``TenantLane`` over a core it owns.  Two consequences for the classic
single-engine path:

  * outstanding work is now BOUNDED (``max_pending`` counts queued AND
    composed-but-unresolved requests): a stalled device no longer
    accumulates verifies without limit — overflow sheds to the
    provider's host-oracle ``verify_signature`` (the circuit
    breaker's fallback twin) with exact verdicts, counted in
    ``frontier_admission_sheds_total{tenant="default"}``;
  * proposal verifies ride the critical priority class and drain before
    gossip within each flush (``priority_lanes=False`` restores strict
    FIFO).

``signature_claims`` and ``FrontierStats`` live in crypto/tenancy.py now
and are re-exported here for compatibility.

The port's own copy of consensus_overlord_tpu/crypto/frontier.py
(the port imports nothing of the JAX package).
"""

from __future__ import annotations

from .tenancy import (  # noqa: F401 — compatibility re-exports
    DEFAULT_QUEUE_BOUND,
    FrontierStats,
    SharedFrontier,
    TenantLane,
    TenantStats,
    signature_claims,
)

__all__ = [
    "BatchingVerifier",
    "DEFAULT_QUEUE_BOUND",
    "FrontierStats",
    "SharedFrontier",
    "TenantLane",
    "TenantStats",
    "signature_claims",
]


class BatchingVerifier(TenantLane):
    """Coalesces `verify(sig, hash, voter)` awaitables into provider
    `verify_batch` calls — the single-tenant lane over a SharedFrontier
    core this instance owns (and closes).

    linger_s: how long the first request of a batch waits for company.
    max_batch: flush immediately at this size (matches the provider's
    padded batch ladder so device kernels stay shape-stable).
    max_pending: outstanding-work bound (queued + composed-but-
    unresolved); arrivals over it shed to the provider's host-oracle
    verify with exact verdicts (a stalled device degrades throughput,
    never correctness or memory).
    metrics: optional obs.Metrics — every flush observes batch size,
    per-request queue wait, padded-batch occupancy, and dispatch/resolve
    phase latency; failures count by message type.  None = no overhead.
    """

    def __init__(self, provider, max_batch: int = 1024,
                 linger_s: float = 0.002, metrics=None,
                 max_pending: int = DEFAULT_QUEUE_BOUND,
                 tenant_id: str = "default", weight: int = 1,
                 priority_lanes: bool = True, recorder=None):
        if max_pending < max_batch:
            # The config layer rejects this too; direct constructions
            # (bench scripts, sim harness) must hit the same wall.  A
            # multi-tenant lane MAY be bounded below the shared
            # max_batch (batches compose across tenants), but this
            # lane is the core's only tenant: a bound below one batch
            # sheds traffic a single flush could have carried, and the
            # size-flush trigger could never fire.
            raise ValueError(
                f"max_pending ({max_pending}) must be >= max_batch "
                f"({max_batch}) for a single-tenant frontier")
        core = SharedFrontier(provider, max_batch=max_batch,
                              linger_s=linger_s, metrics=metrics,
                              recorder=recorder)
        super().__init__(core, tenant_id, weight=weight,
                         queue_bound=max_pending,
                         priority_lanes=priority_lanes)
        core.adopt(self)

    @property
    def stats(self) -> FrontierStats:
        """The legacy whole-frontier counters (requests / batches /
        mean_batch / max_batch / failures) — what /statusz "frontier"
        and the bench scripts read.  Per-tenant counters (sheds, queue
        waits) live on ``tenant_stats``."""
        return self._core.stats

    @property
    def core(self) -> SharedFrontier:
        return self._core

    def close(self) -> None:
        """This lane owns its core: release the dispatch worker thread
        (engine/sim teardown), draining pending requests first."""
        self._core.close()
