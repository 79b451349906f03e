"""Consensus wire types (the Overlord type vocabulary).

The reference consumes these types from the `overlord` crate (reference
src/consensus.rs:28-35: AggregatedVote, Commit, Hash, Node, OverlordMsg,
Proof, SignedChoke, SignedProposal, SignedVote, Status, ViewChangeReason,
Vote, VoteType; src/util.rs:21-22: DurationConfig, Node) and serializes them
with RLP at every network / proof boundary.  Here they are first-class,
defined from scratch as frozen dataclasses with explicit, documented RLP
layouts.  All integers are RLP big-endian minimal; all hashes are 32-byte
SM3 digests (reference src/util.rs:81-87); validator addresses are BLS public
key bytes doubling as the verification key (reference src/consensus.rs:352-357,
406, src/util.rs:69-79).

The port's own copy of consensus_overlord_tpu/core/types.py
(the port imports nothing of the JAX package).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import List, Optional, Sequence

from . import rlp

Address = bytes  # validator identity = serialized public key bytes
Hash = bytes     # 32-byte SM3 digest


# Strict decode helpers: every field position must carry the expected RLP
# kind and every struct the exact arity, or byte-distinct encodings of equal
# objects become possible (malleability of signed/hashed bytes).

def _arity(item, n: int) -> list:
    if not isinstance(item, list):
        raise rlp.RlpError("expected RLP list")
    if len(item) != n:
        raise rlp.RlpError(f"expected {n}-element RLP list, got {len(item)}")
    return item


def _bytes_field(item) -> bytes:
    if not isinstance(item, (bytes, bytearray)):
        raise rlp.RlpError("expected RLP byte string")
    return bytes(item)


def _int_field(item) -> int:
    return rlp.decode_int(_bytes_field(item))


def _vote_type_field(item) -> "VoteType":
    value = _int_field(item)
    try:
        return VoteType(value)
    except ValueError as e:
        raise rlp.RlpError(f"invalid vote type {value}") from e


class VoteType(enum.IntEnum):
    """Phase of a vote (reference: overlord VoteType, used src/consensus.rs:171)."""

    PREVOTE = 1
    PRECOMMIT = 2


class ViewChangeReason(enum.IntEnum):
    """Why a round view-changed (reference src/consensus.rs:777-779 logs these)."""

    CHECK_BLOCK_NOT_PASS = 1
    TIMEOUT_PROPOSE = 2
    TIMEOUT_PREVOTE = 3
    TIMEOUT_PRECOMMIT = 4
    TIMEOUT_BRAKE = 5
    UPDATE_FROM_HIGHER_ROUND = 6
    LEADER_MISBEHAVES = 7


@dataclass(frozen=True)
class Node:
    """Authority-list entry (reference src/util.rs:69-79 `validators_to_nodes`:
    address = validator pubkey bytes, weights fixed to 1 — unweighted BFT)."""

    address: Address
    propose_weight: int = 1
    vote_weight: int = 1

    def to_rlp(self) -> list:
        return [self.address, self.propose_weight, self.vote_weight]

    @classmethod
    def from_rlp(cls, item: list) -> "Node":
        item = _arity(item, 3)
        return cls(_bytes_field(item[0]), _int_field(item[1]),
                   _int_field(item[2]))


@dataclass(frozen=True)
class DurationConfig:
    """Round-timer ratios over the block interval (reference src/util.rs:89-91:
    DurationConfig::new(15, 10, 10, 7)).  Each phase timeout is
    interval * ratio / 10."""

    propose_ratio: int = 15
    prevote_ratio: int = 10
    precommit_ratio: int = 10
    brake_ratio: int = 7

    def to_rlp(self) -> list:
        return [self.propose_ratio, self.prevote_ratio, self.precommit_ratio,
                self.brake_ratio]

    @classmethod
    def from_rlp(cls, item: list) -> "DurationConfig":
        item = _arity(item, 4)
        return cls(*(_int_field(x) for x in item))


@dataclass(frozen=True)
class Vote:
    """The signed payload of a prevote/precommit.  The proof-audit path
    reconstructs exactly this and hashes rlp(vote) (reference
    src/consensus.rs:169-175)."""

    height: int
    round: int
    vote_type: VoteType
    block_hash: Hash

    def to_rlp(self) -> list:
        return [self.height, self.round, int(self.vote_type), self.block_hash]

    @classmethod
    def from_rlp(cls, item: list) -> "Vote":
        item = _arity(item, 4)
        return cls(_int_field(item[0]), _int_field(item[1]),
                   _vote_type_field(item[2]), _bytes_field(item[3]))

    def encode(self) -> bytes:
        return rlp.encode(self.to_rlp())


@dataclass(frozen=True)
class SignedVote:
    """A vote plus its BLS signature, relayed to the round leader (reference
    src/consensus.rs:727-739 transmit path, 210-222 inbound decode)."""

    voter: Address
    signature: bytes
    vote: Vote

    def to_rlp(self) -> list:
        return [self.voter, self.signature, self.vote.to_rlp()]

    @classmethod
    def from_rlp(cls, item: list) -> "SignedVote":
        item = _arity(item, 3)
        return cls(_bytes_field(item[0]), _bytes_field(item[1]),
                   Vote.from_rlp(item[2]))

    def encode(self) -> bytes:
        return rlp.encode(self.to_rlp())

    @classmethod
    def decode(cls, data: bytes) -> "SignedVote":
        return cls.from_rlp(rlp.decode(data))


@dataclass(frozen=True)
class AggregatedSignature:
    """One combined BLS signature plus the voter bitmap naming who is inside
    it (reference src/consensus.rs:166-167: `extract_voters(&mut authority_list,
    &proof.signature.address_bitmap)`)."""

    signature: bytes
    address_bitmap: bytes

    def to_rlp(self) -> list:
        return [self.signature, self.address_bitmap]

    @classmethod
    def from_rlp(cls, item: list) -> "AggregatedSignature":
        item = _arity(item, 2)
        return cls(_bytes_field(item[0]), _bytes_field(item[1]))


@dataclass(frozen=True)
class AggregatedVote:
    """A quorum certificate: an aggregated signature over a vote hash,
    broadcast by the leader (reference src/consensus.rs:693-700 broadcast,
    224-233 inbound decode)."""

    signature: AggregatedSignature
    vote_type: VoteType
    height: int
    round: int
    block_hash: Hash
    leader: Address

    def to_rlp(self) -> list:
        return [self.signature.to_rlp(), int(self.vote_type), self.height,
                self.round, self.block_hash, self.leader]

    @classmethod
    def from_rlp(cls, item: list) -> "AggregatedVote":
        item = _arity(item, 6)
        return cls(AggregatedSignature.from_rlp(item[0]),
                   _vote_type_field(item[1]), _int_field(item[2]),
                   _int_field(item[3]), _bytes_field(item[4]),
                   _bytes_field(item[5]))

    def encode(self) -> bytes:
        return rlp.encode(self.to_rlp())

    @classmethod
    def decode(cls, data: bytes) -> "AggregatedVote":
        return cls.from_rlp(rlp.decode(data))

    def to_vote(self) -> Vote:
        """The vote payload this QC certifies (what each voter signed)."""
        return Vote(self.height, self.round, self.vote_type, self.block_hash)


@dataclass(frozen=True)
class Proposal:
    """A block proposal.  `content` is opaque bytes — the reference's
    pass-through Codec (src/consensus.rs:465-486) treats proposal content as
    raw controller bytes; `lock` carries a polka QC when re-proposing a locked
    block."""

    height: int
    round: int
    content: bytes
    block_hash: Hash
    lock: Optional[AggregatedVote]
    proposer: Address

    def to_rlp(self) -> list:
        lock_item: list = [self.lock.to_rlp()] if self.lock is not None else []
        return [self.height, self.round, self.content, self.block_hash,
                lock_item, self.proposer]

    @classmethod
    def from_rlp(cls, item: list) -> "Proposal":
        item = _arity(item, 6)
        if not isinstance(item[4], list) or len(item[4]) > 1:
            # An absent lock is exactly the empty list (0xc0); accepting the
            # empty byte string too would make signed proposal bytes malleable.
            raise rlp.RlpError("proposal lock must be a 0/1-element list")
        lock = AggregatedVote.from_rlp(item[4][0]) if item[4] else None
        return cls(_int_field(item[0]), _int_field(item[1]),
                   _bytes_field(item[2]), _bytes_field(item[3]), lock,
                   _bytes_field(item[5]))

    def encode(self) -> bytes:
        return rlp.encode(self.to_rlp())


@dataclass(frozen=True)
class SignedProposal:
    """Proposal plus the proposer's signature over sm3(rlp(proposal))
    (reference src/consensus.rs:673-681 broadcast, 236-245 inbound)."""

    proposal: Proposal
    signature: bytes

    def to_rlp(self) -> list:
        return [self.proposal.to_rlp(), self.signature]

    @classmethod
    def from_rlp(cls, item: list) -> "SignedProposal":
        item = _arity(item, 2)
        return cls(Proposal.from_rlp(item[0]), _bytes_field(item[1]))

    def encode(self) -> bytes:
        return rlp.encode(self.to_rlp())

    @classmethod
    def decode(cls, data: bytes) -> "SignedProposal":
        return cls.from_rlp(rlp.decode(data))


@dataclass(frozen=True)
class Choke:
    """Liveness beacon payload: 'I am stuck at (height, round)' (reference
    src/consensus.rs:247-258 inbound SignedChoke, 684-691 broadcast)."""

    height: int
    round: int

    def to_rlp(self) -> list:
        return [self.height, self.round]

    @classmethod
    def from_rlp(cls, item: list) -> "Choke":
        item = _arity(item, 2)
        return cls(_int_field(item[0]), _int_field(item[1]))

    def encode(self) -> bytes:
        return rlp.encode(self.to_rlp())


@dataclass(frozen=True)
class SignedChoke:
    signature: bytes
    address: Address
    choke: Choke

    def to_rlp(self) -> list:
        return [self.signature, self.address, self.choke.to_rlp()]

    @classmethod
    def from_rlp(cls, item: list) -> "SignedChoke":
        item = _arity(item, 3)
        return cls(_bytes_field(item[0]), _bytes_field(item[1]),
                   Choke.from_rlp(item[2]))

    def encode(self) -> bytes:
        return rlp.encode(self.to_rlp())

    @classmethod
    def decode(cls, data: bytes) -> "SignedChoke":
        return cls.from_rlp(rlp.decode(data))


@dataclass(frozen=True)
class Proof:
    """Commit proof: the precommit QC for a committed block.  Audited by
    `check_block` (reference src/consensus.rs:144-207): block_hash and height
    must match the proposal, and the aggregated signature must verify over
    sm3(rlp(Vote{height, round, Precommit, block_hash})) for the voters named
    in the bitmap."""

    height: int
    round: int
    block_hash: Hash
    signature: AggregatedSignature

    def to_rlp(self) -> list:
        return [self.height, self.round, self.block_hash,
                self.signature.to_rlp()]

    @classmethod
    def from_rlp(cls, item: list) -> "Proof":
        item = _arity(item, 4)
        return cls(_int_field(item[0]), _int_field(item[1]),
                   _bytes_field(item[2]),
                   AggregatedSignature.from_rlp(item[3]))

    def encode(self) -> bytes:
        return rlp.encode(self.to_rlp())

    @classmethod
    def decode(cls, data: bytes) -> "Proof":
        return cls.from_rlp(rlp.decode(data))


@dataclass(frozen=True)
class Commit:
    """What the engine hands Brain::commit (reference src/consensus.rs:594-657):
    the committed content and its proof."""

    height: int
    content: bytes
    proof: Proof


@dataclass(frozen=True)
class Status:
    """Next-height marching orders returned from commit / injected via
    RichStatus (reference src/consensus.rs:116-121, 631-636): engine moves to
    `height`, with the given interval (ms), timers, and authority list."""

    height: int
    interval: Optional[int]  # milliseconds
    timer_config: Optional[DurationConfig]
    authority_list: List[Node]


# ---------------------------------------------------------------------------
# Mailbox messages (OverlordMsg equivalent, reference src/consensus.rs:114-121,
# 210-262: RichStatus, SignedVote, AggregatedVote, SignedProposal, SignedChoke)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class RichStatus:
    status: Status


# The network-envelope `type` strings, exactly as the reference matches them
# (src/consensus.rs:212-252) and stamps outbound envelopes
# (src/consensus.rs:676-700, 734-752).
MSG_TYPE_SIGNED_VOTE = "SignedVote"
MSG_TYPE_AGGREGATED_VOTE = "AggregatedVote"
MSG_TYPE_SIGNED_PROPOSAL = "SignedProposal"
MSG_TYPE_SIGNED_CHOKE = "SignedChoke"

WIRE_TYPES = {
    MSG_TYPE_SIGNED_VOTE: SignedVote,
    MSG_TYPE_AGGREGATED_VOTE: AggregatedVote,
    MSG_TYPE_SIGNED_PROPOSAL: SignedProposal,
    MSG_TYPE_SIGNED_CHOKE: SignedChoke,
}


def decode_wire_message(msg_type: str, payload: bytes):
    """Decode an inbound consensus payload by its envelope type string — the
    reference's proc_network_msg match (src/consensus.rs:210-262).  Raises
    (RlpError or struct errors) on malformed input; callers log-and-drop
    (src/consensus.rs:220-260: BFT tolerates lost messages)."""
    cls = WIRE_TYPES.get(msg_type)
    if cls is None:
        raise rlp.RlpError(f"unknown consensus message type {msg_type!r}")
    return cls.decode(payload)


def validators_to_nodes(validators: Sequence[bytes]) -> List[Node]:
    """Reference src/util.rs:69-79: every validator gets weight 1."""
    return [Node(bytes(v), 1, 1) for v in validators]


def validator_to_origin(address: Address) -> int:
    """Network routing id: big-endian u64 from the first 8 address bytes
    (reference src/util.rs:93-97)."""
    return int.from_bytes(address[:8], "big")
