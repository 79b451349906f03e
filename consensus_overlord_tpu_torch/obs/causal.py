"""Causal commit tracing — cross-validator provenance and critical-path
attribution for every committed height.

Every observability layer before this one stops at a process boundary:
device profiles (obs/prof.py) explain a chip, waterfalls
(scripts/waterfall.py) explain one node's round, the fleet section
explains dispatch skew.  None of them answers the question a perf PR
starts from: *where did the milliseconds of this commit go, across the
fleet?*  This module assembles that answer.

Sources, all zero-RNG (pure clock reads; the sim seed contract and the
golden router/chaos fixtures are untouched):

  * the sim fabric stamps a delivery envelope on every message —
    ``(enq, due, trunk_drain, delivered, via_trunk)`` monotonic
    timestamps threaded through sim/router.py's heap and trunk and
    handed to ``Engine.inject_inbound_batch(msgs, envelopes=...)`` as a
    positional side channel (decoded messages are shared across
    targets, so provenance never rides the message object);
  * engine/smr.py reports receive / quorum-crossing / aggregate /
    QC-verify / WAL-fsync / commit events through the ``causal=`` port
    (one shared CommitTracer per sim fleet; per process in the
    service).  Aggregate-path events carry the frontier's round id
    (crypto/tenancy.py tags its dispatch like every flush), so the
    trace's qc_verify stage joins the device-profile ring records the
    dispatch produced — the commit trace and the round waterfall
    (scripts/waterfall.py) are one causal graph, keyed on the id.

Per (node, height) the tracer keeps an open trace from
``on_enter_height`` to ``on_commit`` (this node's own adapter commit)
or ``on_height_settled`` (the first committer's status push advanced
it — the trace's ``path`` field says which), then runs an exact-partition
critical-path solve: the commit interval is split into the STAGES
below with no gap and no overlap, so stage shares always sum to 1.0
by construction.

  proposal_propagation  enter-height -> proposal receipt, minus the
                        router components below (includes chaos delay)
  router_queue_wait     dispatch-batch wait past the due time
  trunk_hop             inter-shard trunk handoff (via_trunk only)
  quorum_tail           proposal receipt -> (2f+1)-th precommit on the
                        leader's clock, or precommit-QC receipt here
  qc_verify             BLS aggregate + aggregated-signature verify
                        (device or host path), measured in the engine
  wal_fsync             WAL save latency inside the interval
  commit                everything after the QC that is not crypto or
                        WAL: adapter commit, exec, status turnaround

Exports, three ways:

  * ``to_perfetto()`` — Chrome-trace/Perfetto JSON; the same dict
    doubles as the ``--critpath-out`` file (Perfetto ignores the extra
    top-level "critpath" key scripts/waterfall.py consumes);
  * Jaeger spans through obs/tracing.py when an exporter is attached —
    the trace id is derived from the height with a keyed hash every
    validator computes identically, which propagates the trace context
    across nodes without widening the gossip wire format; every span
    is tagged with the node address;
  * ``consensus_commit_latency_seconds{stage}`` observations plus the
    /statusz "commits" section (``statusz()``) and the sim summary
    block (``summary()``).

The port's own copy of consensus_overlord_tpu/obs/causal.py.  The
service builds one per process (service/main.py); the sim's
`--critpath-out` is not ported yet (ROADMAP item 8c).
"""

from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Deque, Dict, List, Optional, Tuple

from ..core.sm3 import sm3_hash
from ..core.types import AggregatedVote, SignedProposal, VoteType

#: Commit critical-path stages, in causal order.  An exact partition of
#: [enter_height, commit]: per trace the stage seconds sum to the commit
#: latency and the shares sum to 1.0 by construction.
STAGES: Tuple[str, ...] = (
    "proposal_propagation",
    "router_queue_wait",
    "trunk_hop",
    "quorum_tail",
    "qc_verify",
    "wal_fsync",
    "commit",
)


def height_trace_id(height: int) -> int:
    """Deterministic 128-bit Jaeger trace id for a height.  Every
    validator derives the same id from the same keyed hash, so spans
    from different nodes join one cross-validator trace without any
    context bytes on the gossip wire."""
    digest = sm3_hash(b"causal-commit-height:%d" % height)
    return int.from_bytes(digest[:16], "big") or 1


@dataclass
class CommitTrace:
    """One solved commit: a node's view of a height, partitioned."""

    node: str                 # address hex
    height: int
    round: int
    start: float              # monotonic, enter-height
    total_s: float
    stages: Dict[str, float]  # stage -> seconds (sums to total_s)
    shares: Dict[str, float]  # stage -> fraction (sums to 1.0)
    via_trunk: bool
    quorum_votes: int         # votes at quorum crossing (leader only)
    #: How the height settled on this node: "commit" (this node's own
    #: adapter commit — the relayer that aggregated the QC) or "status"
    #: (the first committer's status push advanced it).  Follower
    #: traces are where cross-shard proposal provenance shows up — the
    #: relayer's own proposal never rides the trunk.
    path: str = "commit"
    #: Frontier round ids of the aggregate-path device dispatches
    #: inside the qc_verify stage — joins the commit trace to the
    #: device-profile ring records those dispatches produced.
    verify_round_ids: Tuple[int, ...] = ()

    def as_dict(self) -> Dict[str, Any]:
        return {
            "node": self.node,
            "height": self.height,
            "round": self.round,
            "start_s": self.start,
            "total_s": self.total_s,
            "stages": dict(self.stages),
            "shares": dict(self.shares),
            "via_trunk": self.via_trunk,
            "quorum_votes": self.quorum_votes,
            "path": self.path,
            "verify_round_ids": list(self.verify_round_ids),
        }


@dataclass
class _Pending:
    """An open (node, height) trace accumulating engine events."""

    t_enter: float
    round: int = 0
    # proposal receipt per round: round -> (t, envelope or None)
    prop_recv: Dict[int, Tuple[float, Optional[tuple]]] = \
        field(default_factory=dict)
    t_quorum: Optional[float] = None   # (2f+1)-th precommit / QC receipt
    quorum_round: Optional[int] = None
    quorum_votes: int = 0
    agg_s: float = 0.0                 # BLS aggregate (leader)
    qc_verify_s: float = 0.0           # aggregated-signature verifies
    wal_s: float = 0.0                 # WAL saves inside the interval
    last_vote_sent: Optional[float] = None
    #: Frontier round ids of the aggregate-path dispatches that
    #: served this height's qc_verify stage — the join key into the
    #: device-profile ring (scripts/waterfall.py round mode).
    verify_round_ids: List[int] = field(default_factory=list)


class CommitTracer:
    """Fleet-wide causal commit tracer.

    One instance is shared by every SimNode in a sim fleet (the shared
    instance IS the cross-node trace-context channel); the service runs
    one per process.  All hooks are synchronous, allocation-light, and
    RNG-free — safe on the engine hot path, and a ``causal=None``
    engine skips them entirely.
    """

    def __init__(self, metrics=None, exporter=None, capacity: int = 256,
                 window: int = 4096):
        #: Optional obs.metrics.Metrics — commit_latency_seconds sink.
        self.metrics = metrics
        #: Optional obs.tracing.JaegerExporter — per-stage span sink.
        self.exporter = exporter
        self._pending: Dict[Tuple[bytes, int], _Pending] = {}
        self.completed: Deque[CommitTrace] = deque(maxlen=capacity)
        # Rolling aggregates over a bounded window (soak-safe memory).
        self._totals: Deque[float] = deque(maxlen=window)
        self._stage_sums: Dict[str, float] = {s: 0.0 for s in STAGES}
        self._sum_total = 0.0
        self._count = 0
        self._last_height = 0
        # monotonic -> wall-clock offset for Jaeger (µs since epoch).
        self._wall_offset = time.time() - time.monotonic()

    # -- engine hooks ------------------------------------------------------

    def on_enter_height(self, node: bytes, height: int, t: float) -> None:
        self._pending[(node, height)] = _Pending(t_enter=t)
        # Bound the open set: a node that resynced past a height never
        # commits it locally; drop its stale open traces.
        for key in [k for k in self._pending
                    if k[0] == node and k[1] < height - 2]:
            del self._pending[key]

    def on_recv(self, node: bytes, msg, t: float,
                env: Optional[tuple]) -> None:
        if isinstance(msg, SignedProposal):
            p = msg.proposal
            tr = self._pending.get((node, p.height))
            if tr is not None and p.round not in tr.prop_recv:
                tr.prop_recv[p.round] = (t, env)
        elif isinstance(msg, AggregatedVote):
            if msg.vote_type != VoteType.PRECOMMIT or not msg.block_hash:
                return
            tr = self._pending.get((node, msg.height))
            if tr is not None and tr.t_quorum is None:
                # Non-leader: the precommit QC's arrival ends the
                # quorum tail on this node's clock.
                tr.t_quorum = t
                tr.quorum_round = msg.round

    def on_proposal_sent(self, node: bytes, height: int, round_: int,
                         proposer: bytes, t: float) -> None:
        # Leader self-path: no router envelope; the proposal "arrives"
        # the moment it is signed and broadcast.
        tr = self._pending.get((node, height))
        if tr is not None and round_ not in tr.prop_recv:
            tr.prop_recv[round_] = (t, None)

    def on_vote_sent(self, node: bytes, height: int, round_: int,
                     vote_type, voter: bytes, t: float) -> None:
        tr = self._pending.get((node, height))
        if tr is not None:
            tr.last_vote_sent = t

    def on_quorum(self, node: bytes, vote_type, height: int, round_: int,
                  t: float, votes: int) -> None:
        if vote_type != VoteType.PRECOMMIT:
            return
        tr = self._pending.get((node, height))
        if tr is not None and tr.t_quorum is None:
            tr.t_quorum = t
            tr.quorum_round = round_
            tr.quorum_votes = votes

    def on_aggregate(self, node: bytes, height: int, dt: float,
                     round_id: Optional[int] = None) -> None:
        tr = self._pending.get((node, height))
        if tr is not None:
            tr.agg_s += max(dt, 0.0)
            if round_id is not None:
                tr.verify_round_ids.append(round_id)

    def on_qc_verify(self, node: bytes, height: int, dt: float,
                     round_id: Optional[int] = None) -> None:
        tr = self._pending.get((node, height))
        if tr is not None:
            tr.qc_verify_s += max(dt, 0.0)
            if round_id is not None:
                tr.verify_round_ids.append(round_id)

    def on_wal_save(self, node: bytes, height: int, dt: float) -> None:
        tr = self._pending.get((node, height))
        if tr is not None:
            tr.wal_s += max(dt, 0.0)

    def on_commit(self, node: bytes, height: int, t: float) -> None:
        tr = self._pending.pop((node, height), None)
        if tr is None:
            return
        self._finalize(node, height, tr, t, path="commit")

    def on_height_settled(self, node: bytes, height: int, t: float) -> None:
        """The height settled on this node WITHOUT its own adapter
        commit — the first committer's status push advanced it (the sim
        controller fans the next-height Status to every engine, which
        beats the QC broadcast's router tick).  Finalizes the open
        trace; a no-op when on_commit already did (first-pop wins), so
        engines call it unconditionally on every single-step height
        transition."""
        tr = self._pending.pop((node, height), None)
        if tr is None:
            return
        self._finalize(node, height, tr, t, path="status")

    # -- critical-path solve -----------------------------------------------

    def _finalize(self, node: bytes, height: int, tr: _Pending,
                  t_commit: float, path: str = "commit") -> None:
        total = max(t_commit - tr.t_enter, 0.0)
        # Proposal receipt for the committing round, else the latest.
        round_ = tr.quorum_round
        if round_ is not None and round_ in tr.prop_recv:
            prop_t, env = tr.prop_recv[round_]
        elif tr.prop_recv:
            round_ = max(tr.prop_recv)
            prop_t, env = tr.prop_recv[round_]
        else:
            round_, prop_t, env = 0, tr.t_enter, None
        # Monotone clamp: enter <= prop_recv <= quorum <= commit.
        prop_t = min(max(prop_t, tr.t_enter), t_commit)
        t_q = tr.t_quorum if tr.t_quorum is not None else prop_t
        t_q = min(max(t_q, prop_t), t_commit)

        # [enter, prop_recv]: trunk hop and dispatch-queue wait are
        # measured from the router envelope; the remainder (including
        # any injected chaos delay) is propagation.
        head = prop_t - tr.t_enter
        trunk = queue = 0.0
        via_trunk = False
        if env is not None:
            enq, due, drained, delivered, via_trunk = env
            if via_trunk and drained > 0.0:
                trunk = min(max(drained - enq, 0.0), head)
            queue = min(max(delivered - due, 0.0), head - trunk)
        prop = head - trunk - queue

        # [prop_recv, quorum]: the quorum tail, whole.
        tail_q = t_q - prop_t

        # [quorum, commit]: measured crypto and WAL first, remainder is
        # the commit stage — each clamped so the partition stays exact.
        tail = t_commit - t_q
        qc = min(tr.agg_s + tr.qc_verify_s, tail)
        wal = min(tr.wal_s, tail - qc)
        commit = tail - qc - wal

        stages = {
            "proposal_propagation": prop,
            "router_queue_wait": queue,
            "trunk_hop": trunk,
            "quorum_tail": tail_q,
            "qc_verify": qc,
            "wal_fsync": wal,
            "commit": commit,
        }
        shares = ({s: stages[s] / total for s in STAGES} if total > 0
                  else {s: (1.0 if s == "commit" else 0.0) for s in STAGES})
        trace = CommitTrace(
            node=node.hex(), height=height, round=round_,
            start=tr.t_enter, total_s=total, stages=stages, shares=shares,
            via_trunk=via_trunk, quorum_votes=tr.quorum_votes, path=path,
            verify_round_ids=tuple(tr.verify_round_ids))
        self.completed.append(trace)
        self._totals.append(total)
        self._sum_total += total
        self._count += 1
        self._last_height = max(self._last_height, height)
        for s in STAGES:
            self._stage_sums[s] += stages[s]
        if self.metrics is not None:
            fam = self.metrics.commit_latency_seconds
            fam.labels(stage="total").observe(total)
            for s in STAGES:
                fam.labels(stage=s).observe(stages[s])
        if self.exporter is not None:
            self._export_spans(trace)

    # -- exports -----------------------------------------------------------

    def _export_spans(self, trace: CommitTrace) -> None:
        from .tracing import Span, new_span_id

        trace_id = height_trace_id(trace.height)
        base_us = int((trace.start + self._wall_offset) * 1e6)
        root_id = new_span_id()
        tags = {"node": trace.node, "height": str(trace.height),
                "round": str(trace.round), "path": trace.path}
        spans = [Span(trace_id=trace_id, span_id=root_id, parent_span_id=0,
                      operation="commit.height", start_us=base_us,
                      duration_us=int(trace.total_s * 1e6), tags=tags)]
        cursor = base_us
        for s in STAGES:
            dur = int(trace.stages[s] * 1e6)
            stage_tags = {**tags, "stage": s,
                          "share": f"{trace.shares[s]:.4f}"}
            if s == "qc_verify" and trace.verify_round_ids:
                # The round-waterfall join key: the frontier round ids whose
                # device-profile ring records this stage covers.
                stage_tags["round_ids"] = ",".join(
                    str(r) for r in trace.verify_round_ids)
            spans.append(Span(
                trace_id=trace_id, span_id=new_span_id(),
                parent_span_id=root_id, operation=f"commit.{s}",
                start_us=cursor, duration_us=dur,
                tags=stage_tags))
            cursor += dur
        for sp in spans:
            self.exporter.report(sp)

    def to_perfetto(self) -> Dict[str, Any]:
        """Chrome-trace JSON with the critpath payload riding along.
        Perfetto ignores unknown top-level keys, so one file serves
        both the trace viewer and scripts/waterfall.py."""
        events: List[Dict[str, Any]] = []
        pids: Dict[str, int] = {}
        base = min((t.start for t in self.completed), default=0.0)
        for t in self.completed:
            pid = pids.setdefault(t.node, len(pids) + 1)
            ts = (t.start - base) * 1e6
            events.append({"name": f"commit h={t.height}", "ph": "X",
                           "cat": "commit", "pid": pid, "tid": t.height,
                           "ts": ts, "dur": t.total_s * 1e6,
                           "args": {"round": t.round, "path": t.path,
                                    "via_trunk": t.via_trunk}})
            cursor = ts
            for s in STAGES:
                dur = t.stages[s] * 1e6
                events.append({"name": s, "ph": "X", "cat": "critpath",
                               "pid": pid, "tid": t.height,
                               "ts": cursor, "dur": dur,
                               "args": {"share": round(t.shares[s], 4)}})
                cursor += dur
        for node, pid in pids.items():
            events.append({"name": "process_name", "ph": "M", "pid": pid,
                           "args": {"name": f"validator {node[:8]}"}})
        return {
            "traceEvents": events,
            "critpath": {
                "traces": [t.as_dict() for t in self.completed],
                "summary": self.summary(),
            },
        }

    # -- aggregates --------------------------------------------------------

    @staticmethod
    def _pct(sorted_vals: List[float], q: float) -> float:
        if not sorted_vals:
            return 0.0
        idx = min(int(q * (len(sorted_vals) - 1) + 0.5),
                  len(sorted_vals) - 1)
        return sorted_vals[idx]

    def summary(self) -> Dict[str, Any]:
        """The sim's "critpath" summary block: rolling latency quantiles
        and mean stage shares over the retained window."""
        vals = sorted(self._totals)
        shares = ({s: self._stage_sums[s] / self._sum_total for s in STAGES}
                  if self._sum_total > 0
                  else {s: 0.0 for s in STAGES})
        return {
            "commits": self._count,
            "open": len(self._pending),
            "last_height": self._last_height,
            "p50_ms": self._pct(vals, 0.50) * 1e3,
            "p99_ms": self._pct(vals, 0.99) * 1e3,
            "stage_shares": {s: round(shares[s], 6) for s in STAGES},
        }

    def statusz(self) -> Dict[str, Any]:
        """The /statusz "commits" section (service + sim, OBS001)."""
        return self.summary()

    def drift_ratio(self, min_samples: int = 8) -> Optional[float]:
        """Second-half / first-half p50 commit latency over the retained
        window — the soak lanes gate this like RSS and WAL growth.
        None until both halves have min_samples commits."""
        vals = list(self._totals)
        half = len(vals) // 2
        if half < min_samples:
            return None
        first = sorted(vals[:half])
        second = sorted(vals[half:])
        p50_first = self._pct(first, 0.50)
        p50_second = self._pct(second, 0.50)
        if p50_first <= 0.0:
            return None
        return p50_second / p50_first
