"""The BFT SMR engine — the Overlord-equivalent consensus state machine.

The reference delegates this entirely to the external `overlord` crate
(reference Cargo.toml:9; instantiated src/consensus.rs:64-71, driven via
OverlordHandler::send_msg and Overlord::run).  SURVEY.md §2.2 names it the
largest single rebuild item.  This is a from-scratch implementation of the
same protocol shape, reconstructed from the reference's use of the engine:

  * height/round SMR with deterministic weighted-round-robin leader rotation
  * SignedProposal broadcast by the round leader (src/consensus.rs:673-681)
  * prevote / precommit phases; votes relayed point-to-point to the round
    leader (transmit_to_relayer, src/consensus.rs:721-771), which aggregates
    them into one BLS signature + voter bitmap and broadcasts an
    AggregatedVote QC (src/consensus.rs:693-700)
  * Tendermint-style lock/polka safety rules for proposals carrying a lock QC
  * liveness via SignedChoke broadcast + brake timeouts -> view change
    (src/consensus.rs:684-691, 777-779)
  * WAL save/load at state transitions for crash recovery
    (src/consensus.rs:314-332)
  * runtime authority-set change via RichStatus injection and the Status
    returned from commit (src/consensus.rs:114-121, 631-636)
  * round timers scaled by DurationConfig ratios over the block interval
    (src/util.rs:89-91: propose/prevote/precommit/brake = 15/10/10/7 tenths)

Everything the engine needs from the outside world comes through the four
ports (ConsensusAdapter, CryptoProvider, Wal, and the inbound mailbox) — the
mailbox-injection + callback shape SURVEY.md §1 identifies as the key
architectural pattern.

Async design: one asyncio task owns all state; inbound messages, timer
expiries, and completions of adapter calls (get_block / check_block / commit
run as sub-tasks) all arrive through the same mailbox, so there is no shared
mutable state and no locking.  The signature hot path is delegated to the
crypto port, where the TPU-batched providers live.

The port's own copy of consensus_overlord_tpu/engine/smr.py
(the port imports nothing of the JAX package).
"""

from __future__ import annotations

import asyncio
import enum
import logging
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Deque, Dict, List, Optional

from ..core import rlp
from ..core.bitmap import build_bitmap, extract_voters, sorted_authorities
from ..core.sm3 import sm3_hash
from ..core.types import (
    Address,
    AggregatedSignature,
    AggregatedVote,
    Choke,
    Commit,
    DurationConfig,
    Hash,
    Node,
    Proof,
    Proposal,
    SignedChoke,
    SignedProposal,
    SignedVote,
    Status,
    Vote,
    VoteType,
    MSG_TYPE_AGGREGATED_VOTE,
    MSG_TYPE_SIGNED_CHOKE,
    MSG_TYPE_SIGNED_PROPOSAL,
    MSG_TYPE_SIGNED_VOTE,
)
from ..crypto.provider import CryptoProvider
from ..obs.prof import annotate as _annotate
from ..ports import ConsensusAdapter, Wal

logger = logging.getLogger("consensus_overlord_tpu_torch.engine")

#: Nil vote marker — voting "no block this round" (empty hash).
NIL_HASH: Hash = b""


class Step(enum.IntEnum):
    PROPOSE = 0
    PREVOTE = 1
    PRECOMMIT = 2
    BRAKE = 3


def quorum_weight(total_weight: int) -> int:
    """BFT quorum: > 2/3 of total weight."""
    return total_weight * 2 // 3 + 1


# ---------------------------------------------------------------------------
# Mailbox messages (OverlordMsg equivalent)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class _Timeout:
    step: Step
    height: int
    round: int


@dataclass(frozen=True)
class _BlockChecked:
    height: int
    round: int
    block_hash: Hash
    ok: bool


@dataclass(frozen=True)
class _BlockFetched:
    height: int
    round: int
    content: bytes
    block_hash: Hash


@dataclass(frozen=True)
class _Committed:
    height: int
    status: Optional[Status]


@dataclass(frozen=True)
class _CommitRetry:
    """Timer-driven re-drive of a failed adapter.commit (the reference
    Brain::commit posture, src/consensus.rs:594-657: a commit that errors
    must eventually land, not wait for an external duplicate QC or the
    ping_controller resync)."""
    height: int


class _Stop:
    pass


class EngineHandler:
    """The OverlordHandler equivalent (reference src/consensus.rs:71, 114,
    216, 228, 240, 252): the only way the outside injects messages."""

    def __init__(self, mailbox: "asyncio.Queue"):
        self._mailbox = mailbox

    def send_msg(self, msg) -> None:
        """Accepts SignedProposal / SignedVote / AggregatedVote / SignedChoke
        wire objects or a Status (RichStatus reconfiguration)."""
        self._mailbox.put_nowait(msg)


# ---------------------------------------------------------------------------
# Engine
# ---------------------------------------------------------------------------

@dataclass
class _WalState:
    """Decoded WAL payload (applied by run() only when not stale)."""

    height: int
    round: int
    my_prevote_round: Optional[int] = None
    my_precommit_round: Optional[int] = None
    lock_round: Optional[int] = None
    lock_proposal: Optional[Proposal] = None
    lock_qc: Optional[AggregatedVote] = None


@dataclass
class _VoteSet:
    """Votes collected by the round leader, bucketed by block hash.

    Weight accumulates as votes arrive: the quorum test runs once PER
    VOTE in the O(N) leader stream, so a recomputed sum there is O(N²)
    across a round — 10k validators would spend whole seconds summing
    weights (measured by scripts/bench_round.py's 10k flood)."""

    by_hash: Dict[Hash, Dict[Address, bytes]] = field(default_factory=dict)
    weight_by_hash: Dict[Hash, int] = field(default_factory=dict)
    qc_sent: bool = False

    def add(self, block_hash: Hash, voter: Address, sig: bytes,
            weight: int) -> None:
        self.by_hash.setdefault(block_hash, {})[voter] = sig
        self.weight_by_hash[block_hash] = (
            self.weight_by_hash.get(block_hash, 0) + weight)


class Engine:
    """One validator's consensus engine instance.

    name: this node's address (its serialized public key,
    reference src/consensus.rs:352-357)."""

    MAX_PENDING = 4096  # future-message buffer bound
    #: Failed duplicate-proposal signature checks allowed per round
    #: before the equivocation detector stops paying for host verifies.
    EQUIV_SIG_BUDGET = 4
    #: Live vote/choke state is kept only for rounds within this window
    #: of the current round.  Without it a single valid validator could
    #: spray votes/chokes for millions of distinct future rounds and
    #: grow the per-round maps without bound (each costs a _VoteSet /
    #: dict); honest peers are never this far ahead — anyone legitimately
    #: beyond the window advances us via f+1 round-skip chokes or a QC
    #: first.  (tests/test_byzantine.py::test_round_flood_memory_bounded)
    ROUND_WINDOW = 64
    #: Replay-detection memory: signatures of the last this-many
    #: accepted votes/proposals (see _remember_sig).
    SEEN_SIGS_CAP = 4096

    def __init__(self, name: Address, adapter: ConsensusAdapter,
                 crypto: CryptoProvider, wal: Wal,
                 frontier=None, tracer=None, metrics=None, recorder=None,
                 causal=None):
        self.name = bytes(name)
        self.adapter = adapter
        self.crypto = crypto
        self.wal = wal
        #: Optional obs.Metrics: round durations, view-change/choke
        #: counters, committed heights.  None = zero hot-path overhead.
        self.metrics = metrics
        #: Optional obs.FlightRecorder: structured event ring (state
        #: transitions, QC formation, frontier drops) dumped by the sim
        #: harness / Byzantine tests on failure and served by /statusz.
        self.recorder = recorder
        #: Optional batching frontier (crypto/frontier.py).  When present,
        #: inbound messages entering through inject_inbound() have their
        #: signatures verified there in device-sized batches, and the
        #: engine skips its per-message verifies (QC aggregate checks
        #: remain — they bind signatures to the voter bitmap).  The engine
        #: holds the frontier itself so the skip can never be enabled
        #: without a verifier actually guarding the injection path.
        self.frontier = frontier
        self.inbound_verified = frontier is not None
        #: Optional obs.prof.ProfileSession: torch.profiler capture over
        #: whole consensus rounds.  The engine only pings it at round
        #: boundaries (on_round decides when a capture opens/closes —
        #: profile_every_n_rounds cadence or a /debug/profile request);
        #: None = zero hot-path overhead.  Assigned by the service /
        #: sim wiring, one per process (the profiler is process-wide).
        self.profile = None
        #: Optional span exporter (obs/tracing.JaegerExporter).  The
        #: reference #[instrument]s its consensus entry points
        #: (src/main.rs:91,106,132; src/consensus.rs:96,143,209); here the
        #: engine itself emits the round lifecycle: one trace per height,
        #: a span per round, and QC-verify spans carrying batch size — so
        #: a Jaeger trace shows consensus progress, not just RPC
        #: envelopes.  Lossy/no-op when unset; never blocks the loop.
        self.tracer = tracer
        #: Optional obs.causal.CommitTracer: the causal commit tracer.
        #: The engine stamps receive/verify/quorum/commit events into it
        #: (keyed by message identity, on the shared monotonic clock the
        #: sim router's delivery envelopes use) so per-height commit
        #: latency decomposes into an attributed critical path.  None =
        #: zero hot-path overhead — every hook is one attribute check.
        self.causal = causal
        self._trace_id = 0
        self._height_span_id = 0
        self._height_start_us = 0
        self._round_span_id = 0
        self._round_start_us = 0
        self._mailbox: asyncio.Queue = asyncio.Queue()
        self.handler = EngineHandler(self._mailbox)

        # Consensus state (owned exclusively by the run() task).
        self.height = 0
        self.round = 0
        self.step = Step.PROPOSE
        self.authorities: List[Node] = []
        self.interval_ms = 3000
        self.timer_config = DurationConfig()
        self.lock_round: Optional[int] = None
        self.lock_proposal: Optional[Proposal] = None
        self.lock_qc: Optional[AggregatedVote] = None

        # Per-height transient state.
        self._contents: Dict[Hash, bytes] = {}
        self._proposals: Dict[int, SignedProposal] = {}
        #: Rounds where equivocation was already counted (one count per
        #: round — the counter must not be inflatable), and per-round
        #: failed-verify budget: junk spamming distinct spoofed-proposer
        #: payloads buys at most EQUIV_SIG_BUDGET host verifies per
        #: round before detection goes quiet for that round (safety is
        #: never budgeted — the second proposal is simply not adopted);
        #: pre-verified inbound paths skip the budget entirely.
        self._equiv_checked: set = set()
        self._equiv_verifies: Dict[int, int] = {}
        self._prevotes: Dict[int, _VoteSet] = {}
        self._precommits: Dict[int, _VoteSet] = {}
        self._prevote_qcs: Dict[int, AggregatedVote] = {}
        self._chokes: Dict[int, Dict[Address, bytes]] = {}
        self._choke_weight: Dict[int, int] = {}  # accumulated, per round
        self._choke_rounds: Dict[Address, int] = {}  # highest choke round seen
        #: Weight histogram over each validator's HIGHEST choke round —
        #: the round-skip test sums it suffix-wise over ≤ROUND_WINDOW
        #: buckets instead of scanning all N _choke_rounds entries per
        #: inbound choke (O(N²) under a choke storm otherwise).
        self._choke_round_hist: Dict[int, int] = {}
        self._my_prevote_round: Optional[int] = None
        self._my_precommit_round: Optional[int] = None
        self._committing = False
        #: The commit being driven for this height, kept so a failed
        #: adapter.commit re-drives from a timer instead of waiting for a
        #: duplicate QC broadcast or the ping_controller resync.
        self._pending_commit: Optional[Commit] = None
        self._commit_retry_timer: Optional[asyncio.TimerHandle] = None

        #: Signatures of accepted votes/proposals (FIFO-bounded): a
        #: stale message counts as a Byzantine "replay" ONLY when it is
        #: a byte-exact duplicate of one this node already processed —
        #: an honest straggler for a just-committed height arrives here
        #: once, misses the set, and is dropped silently (no false
        #: alarms in honest fleets).  Keyed by signature bytes: a replay
        #: is byte-identical, and the signature alone pins voter +
        #: message without hashing on the hot loop.
        self._seen_sigs: Deque[bytes] = deque()
        self._seen_sig_set: set = set()

        self._pending: List[object] = []  # future-height/round buffer
        self._timers: Dict[Step, asyncio.TimerHandle] = {}
        self._tasks: set = set()
        self._running = False
        #: wall-clock of the last commit, for block-interval pacing
        self._last_commit_ts: float = 0.0
        #: perf_counter at the current round's entry (0 = no round yet);
        #: the next round/height transition observes the duration.
        self._round_t0: float = 0.0

    # -- public API --------------------------------------------------------

    async def run(self, init_height: int, interval_ms: int,
                  authority_list: List[Node],
                  timer_config: Optional[DurationConfig] = None) -> None:
        """Start the SMR loop (reference Overlord::run, src/consensus.rs:85-93).
        Runs until stop() is called."""
        self.interval_ms = max(int(interval_ms), 1)
        if timer_config is not None:
            self.timer_config = timer_config
        self._set_authorities(authority_list)
        self._running = True
        start_height = init_height
        start_round = 0
        recovered = await self._load_wal()
        self.height = start_height
        self._reset_height_state()
        if recovered is not None and recovered.height >= init_height:
            # Apply the recovered state (incl. our own votes already cast this
            # round — voting again after restart would be equivocation — and
            # any lock) only when the recovery isn't stale.
            start_height, start_round = recovered.height, recovered.round
            self.height = start_height
            self._my_prevote_round = recovered.my_prevote_round
            self._my_precommit_round = recovered.my_precommit_round
            self.lock_round = recovered.lock_round
            self.lock_proposal = recovered.lock_proposal
            self.lock_qc = recovered.lock_qc
            if start_height > init_height:
                # The caller's authority list describes init_height; a
                # WAL ahead of it may span a reconfiguration — refresh
                # through the chain port (the reference engine's
                # get_authority_list callback, src/consensus.rs:659-666).
                try:
                    fresh = await self.adapter.get_authority_list(
                        start_height)
                    if fresh:
                        self._set_authorities(fresh)
                except Exception:  # noqa: BLE001 — keep the caller's list
                    logger.exception(
                        "%s: get_authority_list failed on recovery",
                        self._tag())
            if self.lock_proposal is not None:
                self._contents[self.lock_proposal.block_hash] = \
                    self.lock_proposal.content
            logger.info("%s: WAL recovery to height=%d round=%d",
                        self._tag(), start_height, start_round)
            if self.recorder is not None:
                self.recorder.record("wal_recovery", height=start_height,
                                     round=start_round)
        self._trace_begin_height()
        if self.causal is not None:
            self.causal.on_enter_height(self.name, self.height,
                                        time.monotonic())
        await self._enter_round(start_round)
        try:
            while self._running:
                msg = await self._mailbox.get()
                if isinstance(msg, _Stop):
                    break
                try:
                    await self._dispatch(msg)
                except Exception:  # noqa: BLE001 — BFT: log and drop
                    logger.exception("%s: error handling %s", self._tag(),
                                     type(msg).__name__)
        finally:
            self._running = False
            self._trace_end_round()
            self._trace_end_height(committed=False)
            self._cancel_timers()
            if self._commit_retry_timer is not None:
                self._commit_retry_timer.cancel()
                self._commit_retry_timer = None
            for t in list(self._tasks):
                t.cancel()

    def stop(self) -> None:
        self._running = False
        self._mailbox.put_nowait(_Stop())

    @property
    def running(self) -> bool:
        """Is the SMR loop live?  Read by the health service: a stopped
        or not-yet-started engine is not a liveness stall."""
        return self._running

    async def inject_inbound(self, msg) -> bool:
        """The inbound-network injection point (the reference's
        proc_network_msg tail, src/consensus.rs:214-252).  With a frontier,
        the message's signature claim is batch-verified first and bad
        signatures are dropped here; without one, the engine's per-message
        verifies in the handlers apply.  Returns False iff dropped."""
        if self.causal is not None:
            self.causal.on_recv(self.name, msg, time.monotonic(), None)
        if self.frontier is not None:
            span_id, parent, start_us = self._child_span_begin()
            ok = await self.frontier.verify_msg(msg)
            self._emit_span("consensus.frontier_verify", span_id, parent,
                            start_us, {"msg_type": type(msg).__name__,
                                       "ok": str(ok).lower()})
            if not ok:
                logger.warning("%s: frontier dropped %s (bad signature)",
                               self._tag(), type(msg).__name__)
                # Count the drop as an adversarial rejection under its
                # own reason: with the frontier on, forged-signature
                # traffic never reaches the per-message guards (bad_sig
                # / non_validator), so fleet-scale Byzantine floods
                # would otherwise be invisible in the rejection
                # counters exactly when they ride the batched pipeline.
                self._reject_byzantine("bad_sig_frontier",
                                       msg=type(msg).__name__)
                if self.recorder is not None:
                    self.recorder.record("frontier_drop",
                                         msg_type=type(msg).__name__,
                                         height=self.height,
                                         round=self.round)
                return False
        self.handler.send_msg(msg)
        return True

    async def inject_inbound_batch(self, msgs, envelopes=None) -> int:
        """Batched twin of inject_inbound for the sharded sim fabric's
        per-tick delivery passes (sim/router.py): every frontier claim
        in the batch is submitted synchronously before any verdict is
        awaited, so ONE linger window covers the whole pass — and the
        await is a gather over already-enqueued futures, not a task per
        message.  Mailbox order preserves arrival order.  Returns the
        number of messages accepted.

        envelopes: optional parallel list of router delivery envelopes
        (enq, due, trunk_drain, delivered, via_trunk) — decoded messages
        are shared across targets so per-delivery provenance rides this
        side channel into the causal tracer, never the message object."""
        if self.causal is not None:
            now = time.monotonic()
            for i, msg in enumerate(msgs):
                self.causal.on_recv(
                    self.name, msg, now,
                    envelopes[i] if envelopes is not None else None)
        if self.frontier is None:
            for msg in msgs:
                self.handler.send_msg(msg)
            return len(msgs)
        nowait = getattr(self.frontier, "verify_msg_nowait", None)
        if nowait is None:
            accepted = 0
            for msg in msgs:
                if await self.inject_inbound(msg):
                    accepted += 1
            return accepted
        span_id, parent, start_us = self._child_span_begin()
        entries = []  # (msg, sync verdict or None, awaitable index)
        pending = []
        for msg in msgs:
            # Choke-storm collapse: a fleet-scale storm pass is almost
            # entirely chokes the handler would drop unread (stale
            # height/round, or a re-broadcast from an already-counted
            # sender — explicitly NOT replay-counted, see
            # _on_signed_choke).  Dropping them BEFORE the frontier
            # claim skips their signature verification, which is what
            # turns a 1000-validator storm round from ~n^2 verifies
            # into <= n.
            if isinstance(msg, SignedChoke) and self._choke_predrop(msg):
                continue
            verdict = nowait(msg)
            if verdict is True or verdict is False:
                entries.append((msg, verdict, -1))
            else:
                entries.append((msg, None, len(pending)))
                pending.append(verdict)
        results = (await asyncio.gather(*pending, return_exceptions=True)
                   if pending else [])
        accepted = 0
        for msg, verdict, idx in entries:
            ok = verdict if idx < 0 else results[idx]
            if isinstance(ok, BaseException):
                # Frontier contract is degrade-to-False, never raise; a
                # raise here is infra breakage — drop the message, keep
                # the batch.
                logger.warning("%s: frontier verify errored for %s: %r",
                               self._tag(), type(msg).__name__, ok)
                ok = False
            if ok:
                self.handler.send_msg(msg)
                accepted += 1
            else:
                logger.warning("%s: frontier dropped %s (bad signature)",
                               self._tag(), type(msg).__name__)
                self._reject_byzantine("bad_sig_frontier",
                                       msg=type(msg).__name__)
                if self.recorder is not None:
                    self.recorder.record("frontier_drop",
                                         msg_type=type(msg).__name__,
                                         height=self.height,
                                         round=self.round)
        self._emit_span("consensus.frontier_verify_batch", span_id, parent,
                        start_us, {"n": str(len(msgs)),
                                   "accepted": str(accepted)})
        return accepted

    def _choke_predrop(self, sc: SignedChoke) -> bool:
        """Would _on_signed_choke drop this choke before even verifying
        it?  Mirrors its pre-verify early-outs against CURRENT engine
        state.  Future-height chokes are kept (the mailbox may drain
        after a commit advances us), so the only behavioral delta vs
        the sequential path is skipped work for dead messages."""
        c = sc.choke
        if c.height != self.height:
            return c.height < self.height
        if c.round < self.round:
            return True
        if c.round - self.round > self.ROUND_WINDOW:
            return True
        return sc.address in self._chokes.get(c.round, ())

    # -- internals ---------------------------------------------------------

    def _tag(self) -> str:
        return f"[{self.name[:4].hex()} h={self.height} r={self.round}]"

    def _set_authorities(self, authority_list: List[Node]) -> None:
        # Precompute the per-message lookups: votes arrive O(N) per round, so
        # these must be O(1), not O(N) rebuilds (10k-validator fleets).
        self.authorities = sorted_authorities(authority_list)
        self._weight_map = {n.address: n.vote_weight for n in self.authorities}
        self._total = sum(self._weight_map.values())
        self._leader_slots: List[Address] = []
        for n in self.authorities:
            self._leader_slots.extend([n.address] * max(n.propose_weight, 1))

    def _total_weight(self) -> int:
        return self._total

    def _weight_of(self, voters: List[Address]) -> int:
        return sum(self._weight_map.get(v, 0) for v in voters)

    def _is_validator(self, addr: Address) -> bool:
        return addr in self._weight_map

    def leader(self, height: int, round_: int) -> Address:
        """Deterministic weighted-round-robin proposer: the (height + round)-th
        slot in the propose-weight-expanded sorted authority list.  With the
        reference's all-equal weights (src/util.rs:74-76) this is plain
        round-robin."""
        return self._leader_slots[(height + round_) % len(self._leader_slots)]

    # -- WAL ---------------------------------------------------------------

    async def _save_wal(self) -> None:
        """Persist everything a restart must not forget: position, our own
        votes this round (re-voting after a crash is equivocation), and the
        lock.  Optional rounds encode as value+1 with 0 = None."""
        lock_item: list = []
        if (self.lock_round is not None and self.lock_proposal is not None
                and self.lock_qc is not None):
            lock_item = [self.lock_round, self.lock_proposal.to_rlp(),
                         self.lock_qc.to_rlp()]
        pv = 0 if self._my_prevote_round is None else self._my_prevote_round + 1
        pc = (0 if self._my_precommit_round is None
              else self._my_precommit_round + 1)
        data = rlp.encode([self.height, self.round, pv, pc, lock_item])
        if self.causal is None:
            await self.wal.save(data)
        else:
            t0 = time.monotonic()
            await self.wal.save(data)
            self.causal.on_wal_save(self.name, self.height,
                                    time.monotonic() - t0)

    async def _load_wal(self) -> Optional["_WalState"]:
        """Parse (never apply — run() decides) the persisted state."""
        data = await self.wal.load()
        if not data:
            return None
        try:
            item = rlp.decode(data)
            pv = rlp.decode_int(item[2])
            pc = rlp.decode_int(item[3])
            state = _WalState(
                height=rlp.decode_int(item[0]),
                round=rlp.decode_int(item[1]),
                my_prevote_round=None if pv == 0 else pv - 1,
                my_precommit_round=None if pc == 0 else pc - 1,
            )
            if item[4]:
                state.lock_round = rlp.decode_int(item[4][0])
                state.lock_proposal = Proposal.from_rlp(item[4][1])
                state.lock_qc = AggregatedVote.from_rlp(item[4][2])
            return state
        except Exception:  # noqa: BLE001
            logger.warning("%s: corrupt WAL ignored", self._tag())
            return None

    # -- height / round transitions ---------------------------------------

    def _reset_height_state(self) -> None:
        self._contents.clear()
        self._proposals.clear()
        self._equiv_checked.clear()
        self._equiv_verifies.clear()
        self._prevotes.clear()
        self._precommits.clear()
        self._prevote_qcs.clear()
        self._chokes.clear()
        self._choke_weight.clear()
        self._choke_rounds.clear()
        self._choke_round_hist.clear()
        self._my_prevote_round = None
        self._my_precommit_round = None
        self._committing = False
        self._pending_commit = None
        if self._commit_retry_timer is not None:
            self._commit_retry_timer.cancel()
            self._commit_retry_timer = None
        # Note: the lock (lock_round/lock_proposal/lock_qc) is deliberately
        # NOT cleared here — it survives rounds and is cleared only on a
        # height change (_enter_new_height) or stale-recovery reset (run()).

    async def _enter_new_height(self, status: Status,
                                committed: bool = True) -> None:
        """committed=False: a RichStatus resync pulled us forward without
        this node having committed the abandoned height (the span tag
        must distinguish the two — the stuck-commit-pulled-forward case
        is exactly when the trace matters)."""
        logger.info("%s: commit/status -> height %d", self._tag(), status.height)
        self._trace_end_round()
        self._trace_end_height(committed=committed)
        if self.recorder is not None:
            self.recorder.record("enter_height", height=status.height,
                                 committed=committed)
        if self.causal is not None and status.height == self.height + 1:
            # A single-step advance means this node watched the height
            # settle in real time (its own adapter commit, or the first
            # committer's status push) — finalize the open commit trace.
            # Multi-height resync jumps abandoned the height instead;
            # their open traces are pruned, never sampled as latency.
            self.causal.on_height_settled(self.name, self.height,
                                          time.monotonic())
        self._last_commit_ts = asyncio.get_running_loop().time()
        self.height = status.height
        self._trace_begin_height()
        if self.causal is not None:
            self.causal.on_enter_height(self.name, self.height,
                                        time.monotonic())
        self.round = 0
        if status.interval:
            self.interval_ms = status.interval
        if status.timer_config is not None:
            self.timer_config = status.timer_config
        if status.authority_list:
            self._set_authorities(status.authority_list)
        self.lock_round = None
        self.lock_proposal = None
        self.lock_qc = None
        self._reset_height_state()
        await self._enter_round(0)
        self._drain_pending()

    async def _enter_round(self, round_: int) -> None:
        now = time.perf_counter()
        if self.metrics is not None and self._round_t0 > 0:
            self.metrics.round_duration_ms.observe(
                (now - self._round_t0) * 1000.0)
        self._round_t0 = now
        self._trace_end_round()
        self.round = round_
        self.step = Step.PROPOSE
        self._trace_begin_round()
        if self.profile is not None:
            self.profile.on_round(self.height, round_)
        self._cancel_timers()
        if self.recorder is not None:
            self.recorder.record("enter_round", height=self.height,
                                 round=round_)
        # Drop per-round state that fell out of the live-round window
        # (memory stays O(ROUND_WINDOW) regardless of round spray).
        # _choke_round_hist is included: its per-validator decrement in
        # _on_signed_choke tolerates pruned buckets via .get().
        floor = round_ - self.ROUND_WINDOW
        for rounds_map in (self._prevotes, self._precommits, self._chokes,
                           self._choke_weight, self._prevote_qcs,
                           self._proposals, self._choke_round_hist):
            for r in [r for r in rounds_map if r < floor]:
                del rounds_map[r]
        await self._save_wal()
        logger.debug("%s: enter round %d (leader=%s)", self._tag(), round_,
                     self.leader(self.height, round_)[:4].hex())
        if self.leader(self.height, round_) == self.name:
            # Pass the position explicitly: the task body may start only
            # after a choke QC has already advanced the round, and reading
            # self.round then would propose at a round we don't lead.
            self._spawn(self._propose(self.height, round_))
        self._set_timer(Step.PROPOSE, self.timer_config.propose_ratio)
        self._drain_pending()

    # -- timers ------------------------------------------------------------

    def _set_timer(self, step: Step, ratio: int) -> None:
        # Tendermint liveness: timeouts must eventually exceed the real
        # network delay, or every round nil-precommits before the polka
        # lands.  Grow linearly with the round, capped so late rounds stay
        # responsive (timeout(r) = base * (1 + r/2), cap 16x).
        backoff = min(1.0 + 0.5 * self.round, 16.0)
        delay = self.interval_ms * ratio / 10 / 1000.0 * backoff
        prev = self._timers.pop(step, None)
        if prev is not None:
            prev.cancel()
        loop = asyncio.get_running_loop()
        h, r = self.height, self.round
        self._timers[step] = loop.call_later(
            delay, lambda: self._mailbox.put_nowait(_Timeout(step, h, r)))

    def _cancel_timers(self) -> None:
        for t in self._timers.values():
            t.cancel()
        self._timers.clear()

    def _spawn(self, coro) -> None:
        task = asyncio.get_running_loop().create_task(coro)
        self._tasks.add(task)
        task.add_done_callback(self._tasks.discard)

    # -- tracing -----------------------------------------------------------

    def _emit_span(self, operation: str, span_id: int, parent: int,
                   start_us: int, tags: Dict[str, str]) -> None:
        if self.tracer is None or start_us == 0:
            return
        from ..obs.tracing import Span
        # Every engine span names its node: multi-node traces land in
        # one Jaeger UI, and without the tag the spans of N validators
        # for the same height are indistinguishable.
        self.tracer.report(Span(
            trace_id=self._trace_id, span_id=span_id, parent_span_id=parent,
            operation=operation, start_us=start_us,
            duration_us=max(int(time.time() * 1e6) - start_us, 1),
            tags={"node": self.name.hex(), **tags}))

    def _trace_begin_height(self) -> None:
        if self.tracer is None:
            return
        from ..obs.tracing import new_span_id, new_trace_id
        self._trace_id = new_trace_id()
        self._height_span_id = new_span_id()
        self._height_start_us = int(time.time() * 1e6)

    def _trace_end_height(self, committed: bool) -> None:
        self._emit_span("consensus.height", self._height_span_id, 0,
                        self._height_start_us,
                        {"height": str(self.height),
                         "committed": str(committed).lower()})
        self._height_start_us = 0

    def _trace_begin_round(self) -> None:
        if self.tracer is None:
            return
        from ..obs.tracing import new_span_id
        self._round_span_id = new_span_id()
        self._round_start_us = int(time.time() * 1e6)

    def _trace_end_round(self) -> None:
        self._emit_span("consensus.round", self._round_span_id,
                        self._height_span_id, self._round_start_us,
                        {"height": str(self.height), "round": str(self.round),
                         "step": Step(self.step).name.lower()})
        self._round_start_us = 0

    def _child_span_begin(self, parent: Optional[int] = None):
        """(span_id, parent_span_id, start_us) for a new child of the
        current round span (or an explicit parent); zeros — which make
        _emit_span a no-op — when untraced."""
        if self.tracer is None:
            return 0, 0, 0
        from ..obs.tracing import new_span_id
        return (new_span_id(),
                self._round_span_id if parent is None else parent,
                int(time.time() * 1e6))

    def _bind_span_ctx(self, span_id: int) -> None:
        """Make `span_id` the calling task's outbound trace context:
        Brain gRPC calls stamp it into `traceparent` (service/rpc.py
        RetryClient.call), so the controller's server span nests under
        this engine child span.  Call only from _spawn'd sub-tasks —
        each task owns a contextvar copy, so no reset is needed."""
        if self.tracer is None or span_id == 0:
            return
        from ..obs.logctx import span_context, trace_context
        trace_context.set(f"{self._trace_id:032x}")
        span_context.set(f"{span_id:016x}")

    # -- statusz -----------------------------------------------------------

    def status(self) -> dict:
        """Live engine state for /statusz (read from the exporter's HTTP
        thread: plain attribute reads, no locking needed beyond the GIL)."""
        try:
            leader = self.leader(self.height, self.round).hex()
        except Exception:  # noqa: BLE001 — pre-run: no authorities yet
            leader = ""
        return {
            "name": self.name.hex(),
            "height": self.height,
            "round": self.round,
            "step": Step(self.step).name,
            "leader": leader,
            "validators": len(self.authorities),
            "lock_round": self.lock_round,
            "committing": self._committing,
        }

    # -- proposing ---------------------------------------------------------

    async def _propose(self, height: int, round_: int) -> None:
        """Leader path: fetch (or re-propose locked) content, then broadcast."""
        if height != self.height or round_ != self.round:
            return
        if round_ == 0 and self._last_commit_ts > 0:
            # Pace block production by the configured interval (the engine's
            # `interval` semantics, reference src/consensus.rs:110, 117, 633).
            elapsed = asyncio.get_running_loop().time() - self._last_commit_ts
            wait = self.interval_ms / 1000.0 - elapsed
            if wait > 0:
                await asyncio.sleep(wait)
            if height != self.height or round_ != self.round:
                return
        if self.lock_proposal is not None:
            self._mailbox.put_nowait(_BlockFetched(
                height, round_, self.lock_proposal.content,
                self.lock_proposal.block_hash))
            return
        try:
            content, block_hash = await self.adapter.get_block(height)
        except Exception:  # noqa: BLE001
            logger.exception("%s: get_block failed", self._tag())
            return
        self._mailbox.put_nowait(_BlockFetched(height, round_, content,
                                               block_hash))

    async def _on_block_fetched(self, msg: _BlockFetched) -> None:
        if msg.height != self.height or msg.round != self.round:
            return
        if self.step != Step.PROPOSE:
            return
        lock_qc = self.lock_qc if self.lock_round is not None else None
        proposal = Proposal(
            height=msg.height, round=msg.round, content=msg.content,
            block_hash=msg.block_hash, lock=lock_qc, proposer=self.name)
        sig = self.crypto.sign(sm3_hash(proposal.encode()))
        sp = SignedProposal(proposal, sig)
        self._contents[msg.block_hash] = msg.content
        if self.causal is not None:
            self.causal.on_proposal_sent(self.name, msg.height, msg.round,
                                         self.name, time.monotonic())
        await self.adapter.broadcast_to_other(
            MSG_TYPE_SIGNED_PROPOSAL, sp.encode())
        await self._on_signed_proposal(sp)  # self-delivery

    # -- dispatch ----------------------------------------------------------

    async def _dispatch(self, msg) -> None:
        if isinstance(msg, Status):
            await self._on_rich_status(msg)
        elif isinstance(msg, SignedProposal):
            await self._on_signed_proposal(msg)
        elif isinstance(msg, SignedVote):
            await self._on_signed_vote(msg)
        elif isinstance(msg, AggregatedVote):
            await self._on_aggregated_vote(msg)
        elif isinstance(msg, SignedChoke):
            await self._on_signed_choke(msg)
        elif isinstance(msg, _Timeout):
            await self._on_timeout(msg)
        elif isinstance(msg, _BlockFetched):
            await self._on_block_fetched(msg)
        elif isinstance(msg, _BlockChecked):
            await self._on_block_checked(msg)
        elif isinstance(msg, _Committed):
            await self._on_committed(msg)
        elif isinstance(msg, _CommitRetry):
            await self._on_commit_retry(msg)
        else:
            logger.warning("%s: unknown mailbox message %r", self._tag(), msg)

    def _buffer_future(self, msg, height: int, round_: Optional[int]) -> bool:
        """Buffer messages for the next height or a future round of the
        current height; drop anything older or too far ahead."""
        if height == self.height and (round_ is None or round_ <= self.round):
            return False  # current — process now
        if height in (self.height, self.height + 1) and \
                len(self._pending) < self.MAX_PENDING:
            self._pending.append(msg)
        return True

    def _drain_pending(self) -> None:
        pending, self._pending = self._pending, []
        for msg in pending:
            self._mailbox.put_nowait(msg)

    # -- reconfiguration (RichStatus) --------------------------------------

    async def _on_rich_status(self, status: Status) -> None:
        """Reference src/consensus.rs:114-121: controller-driven jump to a new
        height (startup, reconfiguration, or resync after falling behind)."""
        if status.height <= self.height and self.height != 0:
            logger.debug("%s: stale RichStatus(%d) ignored", self._tag(),
                         status.height)
            return
        await self._enter_new_height(status, committed=False)

    # -- proposal handling -------------------------------------------------

    async def _on_signed_proposal(self, sp: SignedProposal) -> None:
        p = sp.proposal
        if p.height < self.height or p.height > self.height + 1:
            # Stale height: count as a replay only when byte-identical
            # to a proposal this node already accepted — an honest
            # straggler for a just-committed height is dropped silently.
            if p.height < self.height and self._is_replay(sp.signature):
                self._reject_byzantine("replay", msg="proposal",
                                       at_height=p.height)
            return
        if self._buffer_future(sp, p.height, p.round):
            return
        prev = self._proposals.get(p.round)
        if prev is not None:
            # A second, byte-distinct proposal for a round we already
            # hold one for.  If it names the same proposer and carries a
            # valid signature, this is cryptographic evidence of an
            # equivocating leader (the counter must not be inflatable by
            # unsigned junk); an identical re-send is a replay.  Host
            # verify spend is bounded: only a FAILED check spends
            # budget, so spoofed-proposer junk buys at most
            # EQUIV_SIG_BUDGET verifies per round — after which
            # detection (never safety) goes quiet for that round; a
            # pre-verified inbound path (frontier) costs nothing and is
            # never budget-gated, so there junk can't mask anything.
            if (p.block_hash != prev.proposal.block_hash
                    and p.proposer == prev.proposal.proposer
                    and p.round not in self._equiv_checked):
                if self.inbound_verified:
                    verified = True
                elif (self._equiv_verifies.get(p.round, 0)
                      < self.EQUIV_SIG_BUDGET):
                    verified = self.crypto.verify_signature(
                        sp.signature, sm3_hash(p.encode()), p.proposer)
                    if not verified:
                        self._equiv_verifies[p.round] = \
                            self._equiv_verifies.get(p.round, 0) + 1
                        # Same forensic weight as junk arriving BEFORE
                        # the real proposal (which hits the direct
                        # signature check): counting must not depend on
                        # message arrival order.
                        self._reject_byzantine("bad_sig", msg="proposal",
                                               at_round=p.round)
                else:
                    verified = False
                if verified:
                    self._equiv_checked.add(p.round)
                    logger.warning("%s: equivocating proposal at round %d",
                                   self._tag(), p.round)
                    self._reject_byzantine(
                        "equivocation", proposer=p.proposer[:4].hex(),
                        at_round=p.round)
            elif (p.block_hash == prev.proposal.block_hash
                  and self._is_replay(sp.signature)):
                self._reject_byzantine("replay", msg="proposal",
                                       at_round=p.round)
            return
        if p.round != self.round:
            if p.round < self.round and self._is_replay(sp.signature):
                self._reject_byzantine("replay", msg="proposal",
                                       at_round=p.round)
            return
        expected_leader = self.leader(p.height, p.round)
        if not self._is_validator(p.proposer):
            self._reject_byzantine("non_validator", msg="proposal")
            return
        if p.proposer != expected_leader:
            logger.warning("%s: proposal from non-leader", self._tag())
            return
        if not self.inbound_verified and not self.crypto.verify_signature(
                sp.signature, sm3_hash(p.encode()), p.proposer):
            logger.warning("%s: bad proposal signature", self._tag())
            self._reject_byzantine("bad_sig", msg="proposal")
            return
        if p.lock is not None and not await self._verify_lock_qc(p):
            logger.warning("%s: bad lock QC on proposal", self._tag())
            return
        self._proposals[p.round] = sp
        self._remember_sig(sp.signature)
        self._contents[p.block_hash] = p.content
        # Lock rule (Tendermint safety): locked nodes prevote their lock
        # unless the proposal carries a polka from a later round.
        if self.lock_round is not None and self.lock_proposal is not None:
            proposal_lock_round = p.lock.round if p.lock is not None else -1
            if (p.block_hash != self.lock_proposal.block_hash
                    and proposal_lock_round <= self.lock_round):
                await self._cast_prevote(p.round, NIL_HASH)
                return
        # Validate content through the chain port, then prevote.
        self._spawn(self._check_block(p.height, p.round, p.block_hash,
                                      p.content))

    async def _verify_lock_qc(self, p: Proposal) -> bool:
        qc = p.lock
        if qc is None:
            return True
        if qc.height != p.height or qc.vote_type != VoteType.PREVOTE:
            return False
        if qc.round >= p.round or qc.block_hash != p.block_hash:
            return False
        return await self._verify_qc(qc)

    async def _verify_qc(self, qc: AggregatedVote) -> bool:
        """Aggregated-signature + quorum check for a QC (the reference's
        check_block audit shape, src/consensus.rs:144-207).  With a
        frontier, the device-path aggregate check runs through its
        ordered off-loop dispatch worker — the mailbox handler awaits the
        result, but the event loop (timers, peers, the gRPC server)
        never stalls on the device round-trip."""
        try:
            voters = extract_voters(self.authorities, qc.signature.address_bitmap)
        except ValueError:
            self._reject_byzantine("bad_bitmap", qc_height=qc.height,
                                   qc_round=qc.round)
            return False
        if self._weight_of(voters) < quorum_weight(self._total_weight()):
            self._reject_byzantine("subquorum", qc_height=qc.height,
                                   qc_round=qc.round, voters=len(voters))
            return False
        vote_hash = sm3_hash(qc.to_vote().encode())
        start_us = int(time.time() * 1e6)
        t0 = time.monotonic()
        if self.frontier is not None:
            ok = await self.frontier.verify_aggregated(
                qc.signature.signature, vote_hash, voters)
        else:
            ok = self.crypto.verify_aggregated_signature(
                qc.signature.signature, vote_hash, voters)
        if self.causal is not None:
            # The frontier round-tags its aggregate dispatch; reading
            # the id right after the await links this trace's qc_verify
            # stage to the device-profile ring records the dispatch
            # produced (host path: no frontier, no ring to join).
            self.causal.on_qc_verify(
                self.name, qc.height, time.monotonic() - t0,
                round_id=getattr(self.frontier, "last_agg_round_id", None))
        if not ok:
            self._reject_byzantine("bad_qc_sig", qc_height=qc.height,
                                   qc_round=qc.round, voters=len(voters))
        if self.tracer is not None:
            from ..obs.tracing import new_span_id
            self._emit_span("consensus.qc_verify", new_span_id(),
                            self._round_span_id, start_us,
                            {"height": str(qc.height),
                             "round": str(qc.round),
                             "vote_type": VoteType(qc.vote_type).name.lower(),
                             "batch": str(len(voters)),
                             "ok": str(ok).lower()})
        return ok

    async def _check_block(self, height: int, round_: int, block_hash: Hash,
                           content: bytes) -> None:
        span_id, parent, start_us = self._child_span_begin()
        self._bind_span_ctx(span_id)  # runs as its own _spawn'd task
        if block_hash == NIL_HASH:
            ok = False
        else:
            try:
                ok = await self.adapter.check_block(height, block_hash, content)
            except Exception:  # noqa: BLE001
                logger.exception("%s: check_block failed", self._tag())
                ok = False
        self._emit_span("consensus.check_block", span_id, parent, start_us,
                        {"height": str(height), "round": str(round_),
                         "ok": str(ok).lower()})
        self._mailbox.put_nowait(_BlockChecked(height, round_, block_hash, ok))

    async def _on_block_checked(self, msg: _BlockChecked) -> None:
        if msg.height != self.height or msg.round != self.round:
            return
        if self.step != Step.PROPOSE:
            return
        await self._cast_prevote(msg.round, msg.block_hash if msg.ok
                                 else NIL_HASH)

    # -- voting ------------------------------------------------------------

    async def _cast_prevote(self, round_: int, block_hash: Hash) -> None:
        if self._my_prevote_round == round_:
            return
        self._my_prevote_round = round_
        self.step = Step.PREVOTE
        self._set_timer(Step.PREVOTE, self.timer_config.prevote_ratio)
        await self._save_wal()  # write-ahead: never re-vote after a crash
        await self._send_vote(VoteType.PREVOTE, round_, block_hash)

    async def _cast_precommit(self, round_: int, block_hash: Hash) -> None:
        if self._my_precommit_round == round_:
            return
        self._my_precommit_round = round_
        self.step = Step.PRECOMMIT
        self._set_timer(Step.PRECOMMIT, self.timer_config.precommit_ratio)
        await self._save_wal()  # write-ahead: never re-vote after a crash
        await self._send_vote(VoteType.PRECOMMIT, round_, block_hash)

    async def _send_vote(self, vote_type: VoteType, round_: int,
                         block_hash: Hash) -> None:
        vote = Vote(self.height, round_, vote_type, block_hash)
        sig = self.crypto.sign(sm3_hash(vote.encode()))
        sv = SignedVote(self.name, sig, vote)
        if self.causal is not None:
            self.causal.on_vote_sent(self.name, self.height, round_,
                                     vote_type, self.name, time.monotonic())
        relayer = self.leader(self.height, round_)
        if relayer == self.name:
            await self._on_signed_vote(sv)
        else:
            await self.adapter.transmit_to_relayer(
                relayer, MSG_TYPE_SIGNED_VOTE, sv.encode())

    async def _on_signed_vote(self, sv: SignedVote) -> None:
        """Leader path: collect, verify, aggregate on quorum.  This per-vote
        verify stream is the O(N) hot loop the TPU crypto batches
        (reference src/consensus.rs:397-416; SURVEY.md §3.5)."""
        v = sv.vote
        if v.height < self.height or v.height > self.height + 1:
            # Stale height: replay only if byte-identical to a vote this
            # node (as that round's leader) already counted — the honest
            # 4th precommit racing a commit must not light the counter.
            if v.height < self.height and self._is_replay(sv.signature):
                self._reject_byzantine("replay", msg="vote",
                                       at_height=v.height)
            return
        if self._buffer_future(sv, v.height, None):
            return
        if self.leader(v.height, v.round) != self.name:
            return  # not the relayer for this round
        if abs(v.round - self.round) > self.ROUND_WINDOW:
            return  # outside the live-round window (memory bound)
        if not self._is_validator(sv.voter):
            self._reject_byzantine("non_validator", msg="vote",
                                   voter=sv.voter[:4].hex())
            return
        vote_set = (self._prevotes if v.vote_type == VoteType.PREVOTE
                    else self._precommits).setdefault(v.round, _VoteSet())
        if vote_set.qc_sent:
            return
        if sv.voter in vote_set.by_hash.get(v.block_hash, {}):
            # Already counted for this round: a replay only if
            # byte-identical to the accepted (verified) original —
            # unsigned junk naming an honest voter must not inflate a
            # counter attributed to that voter.
            if self._is_replay(sv.signature):
                self._reject_byzantine("replay", msg="vote",
                                       voter=sv.voter[:4].hex(),
                                       at_round=v.round)
            return
        if not self.inbound_verified and not self.crypto.verify_signature(
                sv.signature, sm3_hash(v.encode()), sv.voter):
            logger.warning("%s: bad vote signature from %s", self._tag(),
                           sv.voter[:4].hex())
            self._reject_byzantine("bad_sig", msg="vote",
                                   voter=sv.voter[:4].hex())
            return
        vote_set.add(v.block_hash, sv.voter, sv.signature,
                     self._weight_map.get(sv.voter, 0))
        self._remember_sig(sv.signature)
        await self._try_aggregate(v.vote_type, v.round, v.block_hash, vote_set)

    async def _try_aggregate(self, vote_type: VoteType, round_: int,
                             block_hash: Hash, vote_set: _VoteSet) -> None:
        votes = vote_set.by_hash.get(block_hash, {})
        # O(1) accumulated weight — this test runs per inbound vote.
        if (vote_set.weight_by_hash.get(block_hash, 0)
                < quorum_weight(self._total_weight())):
            return
        t_quorum = time.monotonic()
        if self.causal is not None:
            # The (2f+1)-th vote just landed at the relayer: the quorum
            # tail for this height ends here on the leader's clock.
            self.causal.on_quorum(self.name, vote_type, self.height, round_,
                                  t_quorum, len(votes))
        # Aggregate in sorted-voter order so the signature matches the
        # bitmap extraction order at every verifier.
        pairs = sorted(votes.items())
        if self.frontier is not None:
            # Device path off the event loop, through the frontier's
            # ordered dispatch worker (same pipeline as batch verifies).
            agg_sig = await self.frontier.aggregate(
                [sig for _, sig in pairs], [voter for voter, _ in pairs])
        else:
            agg_sig = self.crypto.aggregate_signatures(
                [sig for _, sig in pairs], [voter for voter, _ in pairs])
        if self.causal is not None:
            self.causal.on_aggregate(
                self.name, self.height, time.monotonic() - t_quorum,
                round_id=getattr(self.frontier, "last_agg_round_id", None))
        qc = AggregatedVote(
            signature=AggregatedSignature(
                agg_sig, build_bitmap(self.authorities, [v for v, _ in pairs])),
            vote_type=vote_type, height=self.height, round=round_,
            block_hash=block_hash, leader=self.name)
        vote_set.qc_sent = True
        if self.recorder is not None:
            self.recorder.record(
                "qc_formed", height=self.height, round=round_,
                vote_type=VoteType(vote_type).name, voters=len(pairs))
        await self.adapter.broadcast_to_other(
            MSG_TYPE_AGGREGATED_VOTE, qc.encode())
        await self._on_aggregated_vote(qc)  # self-delivery

    # -- QC handling -------------------------------------------------------

    async def _on_aggregated_vote(self, qc: AggregatedVote) -> None:
        if qc.height < self.height or qc.height > self.height + 1:
            return
        if self._buffer_future(qc, qc.height, qc.round):
            return
        if qc.round != self.round:
            # Precommit QCs from earlier rounds of this height still commit.
            if not (qc.vote_type == VoteType.PRECOMMIT
                    and qc.block_hash != NIL_HASH):
                return
        if not await self._verify_qc(qc):
            logger.warning("%s: bad QC", self._tag())
            if self.recorder is not None:
                self.recorder.record(
                    "qc_rejected", height=qc.height, round=qc.round,
                    vote_type=VoteType(qc.vote_type).name)
            return
        if qc.vote_type == VoteType.PREVOTE:
            await self._on_prevote_qc(qc)
        else:
            await self._on_precommit_qc(qc)

    async def _on_prevote_qc(self, qc: AggregatedVote) -> None:
        if qc.round in self._prevote_qcs:
            return
        self._prevote_qcs[qc.round] = qc
        if qc.block_hash != NIL_HASH:
            # Polka: adopt the lock (newest polka wins).
            if self.lock_round is None or qc.round > self.lock_round:
                sp = self._proposals.get(qc.round)
                content = self._contents.get(qc.block_hash)
                if sp is not None and sp.proposal.block_hash == qc.block_hash:
                    self.lock_round = qc.round
                    self.lock_proposal = sp.proposal
                    self.lock_qc = qc
                    await self._save_wal()
                elif content is not None:
                    self.lock_round = qc.round
                    self.lock_proposal = Proposal(
                        qc.height, qc.round, content, qc.block_hash, None,
                        self.leader(qc.height, qc.round))
                    self.lock_qc = qc
                    await self._save_wal()
            await self._cast_precommit(qc.round, qc.block_hash)
        else:
            await self._cast_precommit(qc.round, NIL_HASH)

    async def _on_precommit_qc(self, qc: AggregatedVote) -> None:
        if qc.block_hash == NIL_HASH:
            if qc.round == self.round:
                await self._enter_round(self.round + 1)
            return
        if self._committing:
            return
        content = self._contents.get(qc.block_hash)
        if content is None:
            # We never saw the proposal; the controller resync path
            # (ping_controller -> RichStatus) will pull us forward.
            self.adapter.report_error(
                f"precommit QC for unknown block at height {qc.height}")
            return
        self._committing = True
        proof = Proof(qc.height, qc.round, qc.block_hash, qc.signature)
        self._pending_commit = Commit(qc.height, content, proof)
        self._spawn(self._commit(qc.height, self._pending_commit))

    async def _commit(self, height: int, commit: Commit) -> None:
        # Parent the commit span on the HEIGHT span: the commit ends the
        # height, and a round transition mid-commit must not reparent it.
        span_id, parent, start_us = self._child_span_begin(
            parent=self._height_span_id)
        self._bind_span_ctx(span_id)  # runs as its own _spawn'd task
        ok = True
        try:
            with _annotate("consensus.commit"):
                status = await self.adapter.commit(height, commit)
        except Exception:  # noqa: BLE001
            logger.exception("%s: commit failed", self._tag())
            ok = False
            status = None
        if ok and status is not None and self.metrics is not None:
            # Counted where the adapter accepted the commit, not at the
            # height transition: a RichStatus resync can pull the node
            # forward before its own _Committed message is processed,
            # and the commit this node drove must still count.
            self.metrics.committed_heights.inc()
        if ok and status is not None and self.causal is not None:
            self.causal.on_commit(self.name, height, time.monotonic())
        self._emit_span("consensus.commit", span_id, parent, start_us,
                        {"height": str(height), "ok": str(ok).lower()})
        self._mailbox.put_nowait(_Committed(height, status))

    async def _on_committed(self, msg: _Committed) -> None:
        if msg.height != self.height:
            return
        if msg.status is None:
            # Commit failed — keep the QC'd commit and re-drive it from a
            # timer (reference Brain::commit retry posture,
            # src/consensus.rs:594-657).  _committing stays True so a
            # duplicate QC can't double-spawn; the height transition on
            # success (or a resync RichStatus) clears the retry state.
            delay = max(0.05, self.interval_ms / 1000.0 / 2)
            loop = asyncio.get_running_loop()
            self._commit_retry_timer = loop.call_later(
                delay,
                lambda: self._mailbox.put_nowait(_CommitRetry(msg.height)))
            return
        await self._enter_new_height(msg.status)

    async def _on_commit_retry(self, msg: _CommitRetry) -> None:
        if (msg.height != self.height or not self._committing
                or self._pending_commit is None):
            return
        logger.info("%s: retrying commit at height %d", self._tag(),
                    msg.height)
        if self.recorder is not None:
            self.recorder.record("commit_retry", height=msg.height)
        self._spawn(self._commit(msg.height, self._pending_commit))

    # -- choke / view change ----------------------------------------------

    async def _on_signed_choke(self, sc: SignedChoke) -> None:
        c = sc.choke
        if c.height != self.height:
            return
        if c.round < self.round:
            return
        if c.round - self.round > self.ROUND_WINDOW:
            return  # outside the live-round window (memory bound)
        if not self._is_validator(sc.address):
            self._reject_byzantine("non_validator", msg="choke",
                                   voter=sc.address[:4].hex())
            return
        chokes = self._chokes.setdefault(c.round, {})
        if sc.address in chokes:
            # NOT counted as replay: honest nodes legitimately
            # re-broadcast their choke on every brake timeout.
            return
        if not self.inbound_verified and not self.crypto.verify_signature(
                sc.signature, sm3_hash(c.encode()), sc.address):
            logger.warning("%s: bad choke signature", self._tag())
            self._reject_byzantine("bad_sig", msg="choke")
            return
        chokes[sc.address] = sc.signature
        # O(1) accumulated choke weight per round (the quorum test runs
        # per inbound choke; a recomputed sum is O(N²) under choke storms).
        w = self._weight_map.get(sc.address, 0)
        self._choke_weight[c.round] = self._choke_weight.get(c.round, 0) + w
        prev = self._choke_rounds.get(sc.address)
        if prev is None or c.round > prev:
            if prev is not None:
                # .get: the prev bucket may have been GC'd by
                # _enter_round's live-window pruning.
                remaining = self._choke_round_hist.get(prev, 0) - w
                if remaining <= 0:
                    self._choke_round_hist.pop(prev, None)
                else:
                    self._choke_round_hist[prev] = remaining
            self._choke_round_hist[c.round] = (
                self._choke_round_hist.get(c.round, 0) + w)
            self._choke_rounds[sc.address] = c.round
        if self._choke_weight[c.round] >= quorum_weight(self._total_weight()) \
                and c.round >= self.round:
            self.adapter.report_view_change(
                self.height, self.round, "TIMEOUT_BRAKE quorum")
            self._note_view_change("choke_quorum", c.round + 1)
            await self._enter_round(c.round + 1)
            return
        # Round skip (liveness after partition heal): if f+1 weight is choking
        # in rounds above ours, the network has moved on — jump to the lowest
        # such round and help choke it to quorum.  Weight-at-or-above is a
        # suffix sum over the choke-round histogram: O(ROUND_WINDOW) per
        # choke, independent of validator count (a per-choke scan of all N
        # _choke_rounds entries is O(N²) under a 10k-validator storm).
        higher = sorted((r for r in self._choke_round_hist
                         if r > self.round), reverse=True)
        f_plus_1 = self._total_weight() // 3 + 1
        suffix = 0
        skip_to = None
        for r in higher:  # descending: suffix accumulates weight ≥ r
            suffix += self._choke_round_hist[r]
            if suffix >= f_plus_1:
                skip_to = r  # keep descending: the LOWEST qualifying round
        if skip_to is not None:
            self.adapter.report_view_change(
                self.height, self.round, f"round skip to {skip_to}")
            self._note_view_change("round_skip", skip_to)
            await self._enter_round(skip_to)

    def _remember_sig(self, sig: bytes) -> None:
        """Record an accepted vote/proposal signature for replay
        detection (bounded FIFO)."""
        sig = bytes(sig)
        if sig in self._seen_sig_set:
            return
        if len(self._seen_sigs) >= self.SEEN_SIGS_CAP:
            self._seen_sig_set.discard(self._seen_sigs.popleft())
        self._seen_sigs.append(sig)
        self._seen_sig_set.add(sig)

    def _is_replay(self, sig: bytes) -> bool:
        """Was this exact signed message already processed?  Only a
        byte-exact duplicate counts as a replay — a late-but-fresh
        honest message never trips this."""
        return bytes(sig) in self._seen_sig_set

    def _reject_byzantine(self, reason: str, **fields) -> None:
        """One adversarial (or adversarial-looking) message turned away
        by a guard: count it by reason so a live adversary is visible in
        /metrics, and drop a flight-recorder event so a wedged
        adversarial run is diagnosable post-hoc via /statusz.  Reasons:
        bad_qc_sig, bad_bitmap, subquorum, equivocation, replay,
        non_validator, bad_sig, bad_sig_frontier (an invalid signature
        dropped at the batching frontier before the per-message guards
        could see it)."""
        if self.metrics is not None:
            self.metrics.byzantine_rejections.labels(reason=reason).inc()
        if self.recorder is not None:
            self.recorder.record("byzantine_reject", reason=reason,
                                 height=self.height, round=self.round,
                                 **fields)

    def _note_view_change(self, reason: str, to_round: int) -> None:
        if self.metrics is not None:
            self.metrics.view_changes.labels(reason=reason).inc()
        if self.recorder is not None:
            self.recorder.record("view_change", reason=reason,
                                 height=self.height, round=self.round,
                                 to_round=to_round)

    async def _broadcast_choke(self) -> None:
        if self.metrics is not None:
            self.metrics.chokes_sent.inc()
        if self.recorder is not None:
            self.recorder.record("choke_sent", height=self.height,
                                 round=self.round)
        choke = Choke(self.height, self.round)
        sig = self.crypto.sign(sm3_hash(choke.encode()))
        sc = SignedChoke(sig, self.name, choke)
        await self.adapter.broadcast_to_other(
            MSG_TYPE_SIGNED_CHOKE, sc.encode())
        await self._on_signed_choke(sc)  # count our own choke

    # -- timeouts ----------------------------------------------------------

    async def _on_timeout(self, t: _Timeout) -> None:
        if t.height != self.height or t.round != self.round:
            return
        if t.step == Step.PROPOSE and self.step == Step.PROPOSE:
            # No (valid) proposal in time: prevote nil.
            await self._cast_prevote(self.round, NIL_HASH)
        elif t.step == Step.PREVOTE and self.step == Step.PREVOTE:
            # No polka in time: precommit nil.
            await self._cast_precommit(self.round, NIL_HASH)
        elif t.step == Step.PRECOMMIT and self.step == Step.PRECOMMIT:
            # No commit QC: brake — broadcast choke until the round moves.
            self.step = Step.BRAKE
            await self._broadcast_choke()
            self._set_timer(Step.BRAKE, self.timer_config.brake_ratio)
        elif t.step == Step.BRAKE and self.step == Step.BRAKE:
            await self._broadcast_choke()
            self._set_timer(Step.BRAKE, self.timer_config.brake_ratio)
