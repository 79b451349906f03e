"""Byzantine adversary behaviors for the sim fleet.

The chaos harness proves the fleet survives its own infrastructure
failing; the Byzantine tests before this module injected single forged
messages at the engine boundary (tests/test_byzantine.py).  This module
closes the gap ROADMAP names: *live adversarial validators* — a real
`Engine` whose OUTBOUND traffic is mutated by a pluggable behavior, run
against honest peers on the chaos timeline (sim/chaos.py `byzantine`
events), never more than f = ⌊(n−1)/3⌋ faulty (crashed + adversarial)
at once.

The wrapper sits at the ConsensusAdapter boundary (`AdversaryShim`):
the adversary's engine stays byte-for-byte the honest implementation —
exactly the threat model of a compromised validator running doctored
networking — and the behavior rewrites what leaves the node:

  equivocator  when leader: signs a second, conflicting proposal and
               interleaves delivery so each half of the network sees a
               different proposal FIRST (the classic split attempt);
               every honest node eventually sees both, so the engine's
               equivocation guard must both hold safety AND count it
  forger       broadcasts precommit QCs with garbage aggregate
               signatures under a full voter bitmap (bad_qc_sig), QCs
               with tampered padding bits in the bitmap (bad_bitmap),
               and votes from a fabricated non-validator identity
               (non_validator) — one volley per (height, round)
  withholder   silent on proposals, votes, and QC broadcasts (chokes
               still flow): when it leads a round the fleet must choke
               through TIMEOUT_BRAKE into a view change to stay live
  replayer     records its own signed traffic and re-sends stale
               copies later — delayed, reordered, to single peers —
               so receivers exercise the duplicate/stale-height guards
               (replay counter)
  adaptive     switches between the static tactics on OBSERVED engine
               state (the shim's hooks: leader rotation, the wrapped
               engine's lock, reported view changes): withholds only
               when it leads (or is about to lead) a round, equivocates
               only while holding a lock QC as leader, replays hardest
               during view-change storms, and stays honest otherwise —
               the worst case the static behaviors approximate, because
               every mutation lands exactly where the protocol is
               tender.  Tactic switches are tallied shim-side
               (`adaptive_switch`) so runs can assert the adversary
               actually adapted rather than camping on one play.

Determinism contract: a behavior draws only from its own seeded RNG
(node seed = fleet seed ⊕ node index), so a given (seed, schedule)
replays the same adversarial traffic modulo asyncio interleaving.
The adaptive behavior adds no RNG draws of its own on the decision
path — tactic choice is a pure function of observed engine state.

Safety expectations are asserted by the runs that use this module:
zero `SafetyViolation` from the SimController, target height reached,
and nonzero `consensus_byzantine_rejections_total{reason}` for every
active behavior's signature reasons (`REJECTION_REASONS`).

The port's own copy of consensus_overlord_tpu/sim/adversary.py
(the port imports nothing of the JAX package).
"""

from __future__ import annotations

import asyncio
import logging
import random
from collections import deque
from typing import Deque, Dict, List, Optional, Tuple

from ..core.bitmap import build_bitmap
from ..core.sm3 import sm3_hash
from ..core.types import (
    Address,
    AggregatedSignature,
    AggregatedVote,
    Hash,
    Proposal,
    SignedChoke,
    SignedProposal,
    SignedVote,
    Vote,
    VoteType,
    MSG_TYPE_AGGREGATED_VOTE,
    MSG_TYPE_SIGNED_CHOKE,
    MSG_TYPE_SIGNED_PROPOSAL,
    MSG_TYPE_SIGNED_VOTE,
)

logger = logging.getLogger("consensus_overlord_tpu_torch.adversary")

__all__ = ["AdversaryShim", "BEHAVIORS", "REJECTION_REASONS",
           "make_behavior"]

#: Activation order for round-robin assignment (sim/run.py
#: --chaos-byzantine N picks the first N): the rejection-producing
#: behaviors come first so small counts still light up the counters.
#: "adaptive" is appended LAST so legacy round-robin assignments
#: (byzantine <= 4) keep the exact behaviors they had before it
#: existed — seed stability across PRs.
BEHAVIORS = ("equivocator", "forger", "replayer", "withholder",
             "adaptive")

#: reason labels in consensus_byzantine_rejections_total each behavior
#: is expected to trip at honest receivers (acceptance asserts these
#: are nonzero when the behavior was active; withholder produces
#: silence, asserted via its own adversary_withhold tally instead, and
#: adaptive is asserted on its shim-side adaptive_switch tally — which
#: tactics fire depends on observed state, so no single rejection
#: reason is guaranteed).
#: Caveat: non_validator needs the ENGINE to see the fabricated vote —
#: with the batching frontier on, the invalid signature is dropped
#: upstream (and counted as bad_sig_frontier), so sim/run.py checks
#: that counter instead under --frontier/--tpu.
REJECTION_REASONS: Dict[str, Tuple[str, ...]] = {
    "equivocator": ("equivocation",),
    "forger": ("bad_qc_sig", "bad_bitmap", "non_validator"),
    "replayer": ("replay",),
    "withholder": (),
    "adaptive": (),
}


def _wire_position(msg_type: str, payload: bytes
                   ) -> Optional[Tuple[int, int]]:
    """(height, round) of an outbound wire message, for rate-limiting
    injection volleys; None on anything unparsable."""
    try:
        if msg_type == MSG_TYPE_SIGNED_VOTE:
            v = SignedVote.decode(payload).vote
            return v.height, v.round
        if msg_type == MSG_TYPE_SIGNED_PROPOSAL:
            p = SignedProposal.decode(payload).proposal
            return p.height, p.round
        if msg_type == MSG_TYPE_AGGREGATED_VOTE:
            qc = AggregatedVote.decode(payload)
            return qc.height, qc.round
        if msg_type == MSG_TYPE_SIGNED_CHOKE:
            c = SignedChoke.decode(payload).choke
            return c.height, c.round
    except Exception:  # noqa: BLE001 — introspection only
        return None
    return None


class Behavior:
    """Base adversarial behavior: passthrough.  Subclasses override the
    outbound hooks; everything they need (router, crypto, authority
    list, seeded RNG, flight recorder) hangs off the shim."""

    name = "passthrough"

    def __init__(self, shim: "AdversaryShim"):
        self.shim = shim
        self.rng = random.Random(shim.seed)
        #: volley rate-limit: positions already acted on
        self._acted: set = set()

    def record(self, kind: str, **fields) -> None:
        # Shim-side tally survives disarm (the behavior object doesn't):
        # run assertions lean on it, e.g. "the withholder actually
        # withheld something" — chokes alone can come from other chaos.
        stats = self.shim.behavior_stats
        stats[kind] = stats.get(kind, 0) + 1
        if self.shim.recorder is not None:
            self.shim.recorder.record(kind, behavior=self.name, **fields)

    async def on_broadcast(self, msg_type: str, payload: bytes) -> None:
        await self.shim.inner.broadcast_to_other(msg_type, payload)

    async def on_transmit(self, relayer: Address, msg_type: str,
                          payload: bytes) -> None:
        await self.shim.inner.transmit_to_relayer(relayer, msg_type,
                                                  payload)


class Equivocator(Behavior):
    """Distinct proposals to different peers when leader.  Both copies
    eventually reach every peer (interleaved per-half, opposite order),
    modeling the gossip leak that makes real equivocation detectable:
    halves adopt different proposals first (the split attempt), then
    the second copy trips the engine's equivocation guard."""

    name = "equivocator"

    async def on_broadcast(self, msg_type: str, payload: bytes) -> None:
        if msg_type != MSG_TYPE_SIGNED_PROPOSAL:
            await self.shim.inner.broadcast_to_other(msg_type, payload)
            return
        try:
            sp = SignedProposal.decode(payload)
        except Exception:  # noqa: BLE001 — ship the original unmodified
            await self.shim.inner.broadcast_to_other(msg_type, payload)
            return
        p = sp.proposal
        alt_content = p.content + b"<equivocation>"
        # No lock on the forgery: a lock QC binds to the block hash, and
        # a mismatched one would be rejected as bad_lock, not counted as
        # the equivocation this behavior is exercising.
        alt = Proposal(height=p.height, round=p.round, content=alt_content,
                       block_hash=sm3_hash(alt_content), lock=None,
                       proposer=p.proposer)
        alt_payload = SignedProposal(
            alt, self.shim.crypto.sign(sm3_hash(alt.encode()))).encode()
        peers = sorted(a for a in self.shim.router.peers()
                       if a != self.shim.name)
        half = set(peers[:len(peers) // 2])
        for addr in peers:
            first, second = ((payload, alt_payload) if addr in half
                             else (alt_payload, payload))
            await self.shim.router.send(self.shim.name, addr, msg_type,
                                        first)
            await self.shim.router.send(self.shim.name, addr, msg_type,
                                        second)
        self.record("adversary_equivocate", height=p.height, round=p.round)


class Forger(Behavior):
    """Forged QCs + fabricated identities.  Piggybacks on the engine's
    own outbound cadence (every round produces at least a vote), one
    volley per (height, round)."""

    name = "forger"

    def _forged_qcs(self, height: int, round_: int
                    ) -> List[Tuple[str, bytes]]:
        authorities = self.shim.authorities()
        addrs = [n.address for n in authorities]
        fake_hash: Hash = sm3_hash(b"forged block %d/%d"
                                   % (height, round_))
        full_bitmap = build_bitmap(authorities, addrs)
        garbage_sig = sm3_hash(b"forged aggregate %d"
                               % self.rng.getrandbits(32))
        out: List[Tuple[str, bytes]] = []
        # 1. full quorum bitmap, garbage aggregate -> bad_qc_sig
        out.append((MSG_TYPE_AGGREGATED_VOTE, AggregatedVote(
            signature=AggregatedSignature(garbage_sig, full_bitmap),
            vote_type=VoteType.PRECOMMIT, height=height, round=round_,
            block_hash=fake_hash, leader=self.shim.name).encode()))
        # 2. padding bit set beyond the authority count -> bad_bitmap
        tampered = bytearray(full_bitmap)
        tampered[-1] |= 1  # lowest bit of the last byte is padding
        # unless n % 8 == 0
        if len(addrs) % 8 != 0:
            out.append((MSG_TYPE_AGGREGATED_VOTE, AggregatedVote(
                signature=AggregatedSignature(garbage_sig,
                                              bytes(tampered)),
                vote_type=VoteType.PRECOMMIT, height=height, round=round_,
                block_hash=fake_hash, leader=self.shim.name).encode()))
        else:  # wrong-length bitmap is the length-family twin
            out.append((MSG_TYPE_AGGREGATED_VOTE, AggregatedVote(
                signature=AggregatedSignature(garbage_sig,
                                              full_bitmap + b"\x00"),
                vote_type=VoteType.PRECOMMIT, height=height, round=round_,
                block_hash=fake_hash, leader=self.shim.name).encode()))
        return out

    def _outsider_vote(self, height: int, round_: int) -> bytes:
        """A prevote from an identity outside the validator set."""
        v = Vote(height, round_, VoteType.PREVOTE,
                 sm3_hash(b"outsider block"))
        outsider = sm3_hash(b"outsider identity %d"
                            % self.rng.getrandbits(32))
        return SignedVote(outsider, sm3_hash(outsider + sm3_hash(
            v.encode())), v).encode()

    async def _inject(self, msg_type: str, payload: bytes) -> None:
        pos = _wire_position(msg_type, payload)
        if pos is None or pos in self._acted:
            return
        self._acted.add(pos)
        height, round_ = pos
        for mt, forged in self._forged_qcs(height, round_):
            await self.shim.router.broadcast(self.shim.name, mt, forged)
        # the round leader is the vote sink: send the outsider vote there
        leader = self.shim.leader_of(height, round_)
        if leader is not None and leader != self.shim.name:
            await self.shim.router.send(
                self.shim.name, leader, MSG_TYPE_SIGNED_VOTE,
                self._outsider_vote(height, round_))
        self.record("adversary_forge", height=height, round=round_)

    async def on_broadcast(self, msg_type: str, payload: bytes) -> None:
        await self.shim.inner.broadcast_to_other(msg_type, payload)
        await self._inject(msg_type, payload)

    async def on_transmit(self, relayer: Address, msg_type: str,
                          payload: bytes) -> None:
        await self.shim.inner.transmit_to_relayer(relayer, msg_type,
                                                  payload)
        await self._inject(msg_type, payload)


class Withholder(Behavior):
    """Silent on proposals, votes, and QCs: when this node leads a
    round nothing it aggregates leaves the box, so honest peers must
    brake, choke, and view-change past it (liveness under silence).
    Chokes still flow — a totally dark node would just look crashed."""

    name = "withholder"

    WITHHELD = (MSG_TYPE_SIGNED_PROPOSAL, MSG_TYPE_SIGNED_VOTE,
                MSG_TYPE_AGGREGATED_VOTE)

    async def on_broadcast(self, msg_type: str, payload: bytes) -> None:
        if msg_type in self.WITHHELD:
            pos = _wire_position(msg_type, payload)
            self.record("adversary_withhold", msg_type=msg_type,
                        height=pos[0] if pos else -1)
            return
        await self.shim.inner.broadcast_to_other(msg_type, payload)

    async def on_transmit(self, relayer: Address, msg_type: str,
                          payload: bytes) -> None:
        if msg_type in self.WITHHELD:
            pos = _wire_position(msg_type, payload)
            self.record("adversary_withhold", msg_type=msg_type,
                        height=pos[0] if pos else -1)
            return
        await self.shim.inner.transmit_to_relayer(relayer, msg_type,
                                                  payload)


class Replayer(Behavior):
    """Re-sends stale signed traffic.  Every outbound vote/proposal is
    recorded; each new send triggers a few replays of older recordings
    — immediately (same-round duplicate → the leader's dedup guard)
    and delayed via the event loop (stale height/round by the time it
    lands → the staleness guards), to randomly chosen single peers
    (reordering relative to broadcast order)."""

    name = "replayer"

    MEMORY = 64      # recorded messages kept
    PER_SEND = 2     # replays triggered per genuine outbound message
    MAX_DELAY_S = 0.25

    def __init__(self, shim: "AdversaryShim"):
        super().__init__(shim)
        self._log: List[Tuple[str, bytes]] = []

    def _remember(self, msg_type: str, payload: bytes) -> None:
        if msg_type in (MSG_TYPE_SIGNED_VOTE, MSG_TYPE_SIGNED_PROPOSAL):
            self._log.append((msg_type, payload))
            if len(self._log) > self.MEMORY:
                self._log.pop(0)

    def _replay_some(self) -> None:
        if not self._log:
            return
        loop = asyncio.get_running_loop()
        peers = sorted(a for a in self.shim.router.peers()
                       if a != self.shim.name)
        if not peers:
            return
        immediate: List[Tuple[str, bytes, Address]] = []
        for _ in range(self.PER_SEND):
            msg_type, payload = self._log[
                self.rng.randrange(len(self._log))]
            target = peers[self.rng.randrange(len(peers))]
            if msg_type == MSG_TYPE_SIGNED_VOTE:
                # Aim vote replays at the round's leader: the original
                # was transmitted there and counted, so the duplicate is
                # detectable (replay counters only tick at a node that
                # has byte-exact-seen the message before).  Proposals
                # were broadcast, so any peer detects those.
                pos = _wire_position(msg_type, payload)
                leader = (self.shim.leader_of(*pos)
                          if pos is not None else None)
                if leader is not None and leader != self.shim.name:
                    target = leader
            delay = self.rng.uniform(0.0, self.MAX_DELAY_S)

            def _fire(mt=msg_type, pl=payload, tgt=target) -> None:
                task = loop.create_task(
                    self.shim.router.send(self.shim.name, tgt, mt, pl))
                task.add_done_callback(
                    lambda t: t.cancelled() or t.exception())

            if delay > 0:
                loop.call_later(delay, _fire)
            else:
                immediate.append((msg_type, payload, target))
        if immediate:
            # One task for the whole zero-delay burst: router admission
            # is synchronous, so task-per-replay is pure scheduler
            # churn — at fleet scale a flood behavior fires thousands
            # of these per height (same batching story as the sharded
            # fabric's pump passes, sim/router.py).
            async def _burst(items=immediate):
                for mt, pl, tgt in items:
                    await self.shim.router.send(self.shim.name, tgt,
                                                mt, pl)
            task = loop.create_task(_burst())
            task.add_done_callback(
                lambda t: t.cancelled() or t.exception())
        self.record("adversary_replay", count=self.PER_SEND)

    async def on_broadcast(self, msg_type: str, payload: bytes) -> None:
        await self.shim.inner.broadcast_to_other(msg_type, payload)
        self._remember(msg_type, payload)
        self._replay_some()

    async def on_transmit(self, relayer: Address, msg_type: str,
                          payload: bytes) -> None:
        await self.shim.inner.transmit_to_relayer(relayer, msg_type,
                                                  payload)
        self._remember(msg_type, payload)
        self._replay_some()


class Adaptive(Behavior):
    """State-observing tactic switcher — the compromised validator that
    watches its own honest engine and strikes where the protocol is
    tender *right now* instead of camping on one play:

      withhold    only when this node leads the current round or is
                  about to lead (current round + 1, or round 0 of the
                  next height) — silence from a leader costs the fleet
                  a full choke/view-change cycle; silence from a
                  follower costs one vote
      equivocate  only while leading WITH a lock QC held — the lock
                  path is where a conflicting proposal can actually
                  split honest prevotes
      replay      hardest during view-change storms (>= STORM_THRESHOLD
                  view changes reported within the last
                  STORM_WINDOW_HEIGHTS heights): duplicate stale votes
                  land among genuine re-sends, where the dedup guards
                  earn their keep
      honest      otherwise — an adaptive adversary that is always
                  attacking is just a noisy static one

    Observed signals come exclusively through the shim's existing
    surface: `leader_of` (the wrapped engine's rotation), the engine's
    lock state, and the view changes the engine reported through
    `report_view_change` (the shim records them before delegating).
    Tactic choice draws no RNG, so a given engine trajectory picks the
    same tactics; every switch is tallied (`adaptive_switch`, plus a
    per-tactic `adaptive_<tactic>` count) for run assertions."""

    name = "adaptive"

    STORM_WINDOW_HEIGHTS = 4
    STORM_THRESHOLD = 2
    #: replay volleys per outbound message while the storm tactic is
    #: active — "hardest" relative to the static Replayer's PER_SEND.
    STORM_PER_SEND = 4

    def __init__(self, shim: "AdversaryShim"):
        super().__init__(shim)
        self._tactics: Dict[str, Behavior] = {
            "withhold": Withholder(shim),
            "equivocate": Equivocator(shim),
            "replay": Replayer(shim),
        }
        self._tactics["replay"].PER_SEND = self.STORM_PER_SEND
        self._active: Optional[str] = None

    # -- state observation -------------------------------------------------

    def _leads_or_about_to(self) -> bool:
        eng = self.shim.engine
        if eng is None:
            return False
        me = self.shim.name
        h, r = eng.height, eng.round
        return (self.shim.leader_of(h, r) == me
                or self.shim.leader_of(h, r + 1) == me
                or self.shim.leader_of(h + 1, 0) == me)

    def _holds_lock(self) -> bool:
        eng = self.shim.engine
        return eng is not None and getattr(eng, "lock_round", None) is not None

    def _storming(self) -> bool:
        eng = self.shim.engine
        if eng is None:
            return False
        since = eng.height - self.STORM_WINDOW_HEIGHTS
        return (self.shim.view_changes_since(since)
                >= self.STORM_THRESHOLD)

    def _pick_tactic(self) -> Optional[str]:
        leading = self._leads_or_about_to()
        if leading and self._holds_lock():
            return "equivocate"
        if leading:
            return "withhold"
        if self._storming():
            return "replay"
        return None

    def _tick(self) -> Optional[Behavior]:
        tactic = self._pick_tactic()
        if tactic != self._active:
            self.record("adaptive_switch",
                        frm=self._active or "honest",
                        to=tactic or "honest",
                        height=(self.shim.engine.height
                                if self.shim.engine is not None else -1))
            if tactic is not None:
                self.record(f"adaptive_{tactic}")
            self._active = tactic
        return self._tactics[tactic] if tactic is not None else None

    # -- outbound hooks ----------------------------------------------------

    async def on_broadcast(self, msg_type: str, payload: bytes) -> None:
        tactic = self._tick()
        if tactic is None:
            await self.shim.inner.broadcast_to_other(msg_type, payload)
        else:
            await tactic.on_broadcast(msg_type, payload)

    async def on_transmit(self, relayer: Address, msg_type: str,
                          payload: bytes) -> None:
        tactic = self._tick()
        if tactic is None:
            await self.shim.inner.transmit_to_relayer(relayer, msg_type,
                                                      payload)
        else:
            await tactic.on_transmit(relayer, msg_type, payload)


_BEHAVIOR_CLASSES = {
    "equivocator": Equivocator,
    "forger": Forger,
    "withholder": Withholder,
    "replayer": Replayer,
    "adaptive": Adaptive,
}


def make_behavior(name: str, shim: "AdversaryShim") -> Behavior:
    try:
        return _BEHAVIOR_CLASSES[name](shim)
    except KeyError:
        raise ValueError(f"unknown adversary behavior {name!r}; "
                         f"known: {sorted(_BEHAVIOR_CLASSES)}") from None


class AdversaryShim:
    """ConsensusAdapter wrapper every SimNode carries: transparent
    passthrough until `arm()` activates a behavior (chaos `byzantine`
    events toggle it on a height window), then outbound traffic is
    routed through the behavior's hooks.  Inbound paths, Brain
    callbacks, and the engine itself are untouched — the adversary is
    a doctored network stack on an honest engine, which is exactly the
    compromised-validator threat model."""

    def __init__(self, inner, crypto, router, seed: int = 0,
                 recorder=None):
        self.inner = inner
        self.crypto = crypto
        self.router = router
        self.seed = seed
        self.recorder = recorder
        self.behavior: Optional[Behavior] = None
        #: The wrapped node's Engine (SimNode sets it right after
        #: construction) — leader_of delegates to its rotation.
        self.engine = None
        #: history of (behavior name, armed) toggles, for run summaries
        self.toggles: List[Tuple[str, bool]] = []
        #: event-kind -> count across every behavior ever armed here
        #: (outlives disarm)
        self.behavior_stats: Dict[str, int] = {}
        #: view changes the wrapped engine reported (height, round,
        #: reason), bounded — the adaptive behavior's storm signal.
        self.observed_view_changes: Deque[Tuple[int, int, str]] = \
            deque(maxlen=256)

    # -- toggles -----------------------------------------------------------

    @property
    def name(self) -> bytes:
        return self.inner.name

    @property
    def active(self) -> Optional[str]:
        return self.behavior.name if self.behavior is not None else None

    def arm(self, behavior: Optional[str]) -> None:
        """Activate a behavior by name (None = back to honest)."""
        if behavior is None:
            if self.behavior is not None:
                self.toggles.append((self.behavior.name, False))
                if self.recorder is not None:
                    self.recorder.record("adversary_disarm",
                                         behavior=self.behavior.name)
            self.behavior = None
            return
        self.behavior = make_behavior(behavior, self)
        self.toggles.append((behavior, True))
        if self.recorder is not None:
            self.recorder.record("adversary_arm", behavior=behavior)
        logger.info("adversary: %s armed on %s", behavior,
                    self.name[:4].hex())

    # -- helpers behaviors lean on -----------------------------------------

    def authorities(self):
        return self.inner.controller.authority_list()

    def leader_of(self, height: int, round_: int) -> Optional[Address]:
        """Round leader — behaviors aim forged votes and replays at the
        vote sink.  Delegates to the wrapped engine's rotation
        (Engine.leader, the propose-weight-expanded slot list) so the
        aim stays true under unequal weights; before the engine has set
        authorities, falls back to the same expansion over the
        controller's list."""
        eng = self.engine
        if eng is not None and getattr(eng, "_leader_slots", None):
            return eng.leader(height, round_)
        from ..core.bitmap import sorted_authorities

        slots: List[Address] = []
        for n in sorted_authorities(self.authorities()):
            slots.extend([n.address] * max(n.propose_weight, 1))
        if not slots:
            return None
        return slots[(height + round_) % len(slots)]

    # -- ConsensusAdapter surface ------------------------------------------

    async def get_block(self, height: int):
        return await self.inner.get_block(height)

    async def check_block(self, height: int, block_hash: Hash,
                          content: bytes) -> bool:
        return await self.inner.check_block(height, block_hash, content)

    async def commit(self, height: int, commit):
        return await self.inner.commit(height, commit)

    async def get_authority_list(self, height: int):
        return await self.inner.get_authority_list(height)

    async def broadcast_to_other(self, msg_type: str,
                                 payload: bytes) -> None:
        if self.behavior is None:
            await self.inner.broadcast_to_other(msg_type, payload)
        else:
            await self.behavior.on_broadcast(msg_type, payload)

    async def transmit_to_relayer(self, relayer: Address, msg_type: str,
                                  payload: bytes) -> None:
        if self.behavior is None:
            await self.inner.transmit_to_relayer(relayer, msg_type,
                                                 payload)
        else:
            await self.behavior.on_transmit(relayer, msg_type, payload)

    def report_error(self, context: str) -> None:
        self.inner.report_error(context)

    def report_view_change(self, height: int, round: int,
                           reason: str) -> None:
        self.observed_view_changes.append((height, round, reason))
        self.inner.report_view_change(height, round, reason)

    def view_changes_since(self, height: int) -> int:
        """View changes this node's engine reported at or above
        `height` — the adaptive behavior's storm detector."""
        return sum(1 for h, _, _ in self.observed_view_changes
                   if h >= height)
