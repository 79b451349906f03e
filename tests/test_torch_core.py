"""The port's wire layer (core/rlp.py, core/types.py, core/bitmap.py)
against the JAX package's: seeded random votes, signed votes, aggregated
votes, proposals with and without a lock, chokes, proofs and bitmaps
encode to the same bytes in both packages, each decodes the other's
bytes to equal fields, and the rejection cases of tests/test_core.py
raise errors of the same class in both.  Tolerance: none (bytes)."""

import dataclasses
import enum

import numpy as np
import pytest

from consensus_overlord_tpu.core import bitmap as jbitmap
from consensus_overlord_tpu.core import rlp as jrlp
from consensus_overlord_tpu.core import types as jtypes
from consensus_overlord_tpu_torch.core import bitmap as tbitmap
from consensus_overlord_tpu_torch.core import rlp as trlp
from consensus_overlord_tpu_torch.core import types as ttypes

PACKAGES = ((jtypes, jrlp, jbitmap), (ttypes, trlp, tbitmap))
SEEDS = range(6)


def plain(obj):
    """A wire object as nested builtins (enums as ints), so objects of the
    two packages compare field for field."""
    if dataclasses.is_dataclass(obj):
        return {f.name: plain(getattr(obj, f.name))
                for f in dataclasses.fields(obj)}
    if isinstance(obj, enum.Enum):
        return int(obj.value)
    if isinstance(obj, (list, tuple)):
        return [plain(x) for x in obj]
    return obj


class Draw:
    """Seeded field values, drawn once and built in either package."""

    def __init__(self, seed: int):
        self.rng = np.random.default_rng(seed)

    def bytes(self, n: int) -> bytes:
        return self.rng.integers(0, 256, n, dtype=np.uint8).tobytes()

    def int(self, bits: int = 40) -> int:
        # 0 and values spanning many byte lengths (RLP's big-endian ints).
        return int(self.rng.integers(0, 2 ** int(self.rng.integers(0, bits))))

    def vote(self):
        return dict(height=self.int(), round=self.int(16),
                    vote_type=int(self.rng.integers(1, 3)),
                    block_hash=self.bytes(32))

    def agg_vote(self):
        return dict(sig=self.bytes(96), bitmap=self.bytes(
            int(self.rng.integers(1, 9))), vote_type=int(
            self.rng.integers(1, 3)), height=self.int(), round=self.int(16),
            block_hash=self.bytes(32), leader=self.bytes(48))


def build_vote(t, d):
    return t.Vote(d["height"], d["round"], t.VoteType(d["vote_type"]),
                  d["block_hash"])


def build_agg_vote(t, d):
    return t.AggregatedVote(
        t.AggregatedSignature(d["sig"], d["bitmap"]),
        t.VoteType(d["vote_type"]), d["height"], d["round"],
        d["block_hash"], d["leader"])


def wire_objects(seed: int):
    """[(kind, build(types module) -> object)] for one seed."""
    d = Draw(seed)
    vote = d.vote()
    signed = dict(voter=d.bytes(48), sig=d.bytes(96), vote=d.vote())
    agg = d.agg_vote()
    lock = d.agg_vote()
    prop = dict(height=d.int(), round=d.int(16),
                content=d.bytes(int(d.rng.integers(0, 300))),
                block_hash=d.bytes(32), proposer=d.bytes(48),
                sig=d.bytes(96))
    choke = dict(sig=d.bytes(96), addr=d.bytes(48), height=d.int(),
                 round=d.int(16))
    proof = dict(height=d.int(), round=d.int(16), block_hash=d.bytes(32),
                 sig=d.bytes(96), bitmap=d.bytes(int(d.rng.integers(1, 9))))

    def proposal(t, with_lock):
        p = t.Proposal(prop["height"], prop["round"], prop["content"],
                       prop["block_hash"],
                       build_agg_vote(t, lock) if with_lock else None,
                       prop["proposer"])
        return t.SignedProposal(p, prop["sig"])

    return [
        ("Vote", lambda t: build_vote(t, vote)),
        ("SignedVote", lambda t: t.SignedVote(
            signed["voter"], signed["sig"], build_vote(t, signed["vote"]))),
        ("AggregatedVote", lambda t: build_agg_vote(t, agg)),
        ("SignedProposal", lambda t: proposal(t, False)),
        ("SignedProposal", lambda t: proposal(t, True)),
        ("SignedChoke", lambda t: t.SignedChoke(
            choke["sig"], choke["addr"],
            t.Choke(choke["height"], choke["round"]))),
        ("Proof", lambda t: t.Proof(
            proof["height"], proof["round"], proof["block_hash"],
            t.AggregatedSignature(proof["sig"], proof["bitmap"]))),
    ]


def decode(t, r, kind: str, data: bytes):
    cls = getattr(t, kind)
    if kind == "Vote":
        return cls.from_rlp(r.decode(data))
    return cls.decode(data)


@pytest.mark.parametrize("seed", SEEDS)
def test_wire_types_encode_alike_and_cross_decode(seed):
    for kind, build in wire_objects(seed):
        j, t = build(jtypes), build(ttypes)
        jb, tb = j.encode(), t.encode()
        assert jb == tb, kind
        assert plain(decode(ttypes, trlp, kind, jb)) == plain(j), kind
        assert plain(decode(jtypes, jrlp, kind, tb)) == plain(t), kind
        if kind in jtypes.WIRE_TYPES:
            assert plain(ttypes.decode_wire_message(kind, jb)) == plain(j)


@pytest.mark.parametrize("seed", SEEDS)
def test_bitmaps_and_helpers_match(seed):
    rng = np.random.default_rng(100 + seed)
    n = int(rng.integers(1, 40))
    addrs = [rng.integers(0, 256, 48, dtype=np.uint8).tobytes()
             for _ in range(n)]
    voters = [a for a in addrs if rng.random() < 0.6]
    out = []
    for t, _, b in PACKAGES:
        nodes = t.validators_to_nodes(addrs)
        bm = b.build_bitmap(nodes, voters)
        out.append((bm, b.extract_voters(nodes, bm),
                    [plain(x) for x in b.sorted_authorities(nodes)],
                    t.validator_to_origin(addrs[0])))
    assert out[0] == out[1]
    assert sorted(out[0][1]) == sorted(voters)


def _rlp_cases(r):
    return [
        lambda: r.decode(r.encode(b"dog") + b"\x00"),  # trailing bytes
        lambda: r.decode(bytes([0x81, 0x05])),  # non-canonical
        lambda: r.decode(b"\xc1" * 5000 + b"\xc0"),  # deep nesting
    ]


def _type_cases(t, r):
    def arity():
        sv = t.SignedVote(b"\x01" * 48, b"\x02" * 96,
                          t.Vote(1, 0, t.VoteType.PREVOTE, b"\x03" * 32))
        item = r.decode(sv.encode())
        item.append(b"extra")
        t.SignedVote.from_rlp(item)

    def field_kind():
        sv = t.SignedVote(b"", b"\x02" * 96,
                          t.Vote(1, 0, t.VoteType.PREVOTE, b"\x03" * 32))
        item = r.decode(sv.encode())
        item[0] = []
        t.SignedVote.from_rlp(item)

    def vote_type():
        item = r.decode(t.Vote(1, 0, t.VoteType.PREVOTE,
                               b"\x03" * 32).encode())
        item[2] = r.encode_int(9)
        t.Vote.from_rlp(item)

    def lock_form():
        p = t.Proposal(1, 0, b"c", b"\xaa" * 32, None, b"\xbb" * 48)
        item = r.decode(p.encode())
        item[4] = b""
        t.Proposal.from_rlp(item)

    def unknown_type():
        t.decode_wire_message("NoSuchMessage", b"\xc0")

    return [arity, field_kind, vote_type, lock_form, unknown_type]


def _bitmap_cases(t, b):
    return [
        lambda: b.build_bitmap([t.Node(b"\x01" * 48)], [b"\x02" * 48]),
        lambda: b.extract_voters([t.Node(b"\x01" * 48)], b"\x00\x00"),
        lambda: b.extract_voters([t.Node(bytes([i]) * 48) for i in range(9)],
                                 b"\x80\x7f"),  # padding bits
    ]


def _raised(fn) -> str:
    try:
        fn()
    except Exception as e:  # noqa: BLE001 — the class is what is compared
        return type(e).__name__
    return "nothing"


@pytest.mark.parametrize("group", ["rlp", "types", "bitmap"])
def test_rejections_raise_the_same_error_class(group):
    names = []
    for t, r, b in PACKAGES:
        cases = {"rlp": lambda: _rlp_cases(r),
                 "types": lambda: _type_cases(t, r),
                 "bitmap": lambda: _bitmap_cases(t, b)}[group]()
        names.append([_raised(fn) for fn in cases])
    assert names[0] == names[1]
    assert "nothing" not in names[1]
    want = "ValueError" if group == "bitmap" else "RlpError"
    assert set(names[1]) == {want}
