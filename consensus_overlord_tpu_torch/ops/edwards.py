"""Batched edwards25519 (Ed25519) curve ops on the port's field layer.

The counterpart of consensus_overlord_tpu/ops/edwards.py: twisted
Edwards points in extended coordinates (X : Y : Z : T), T = XY/Z, with
the a = −1 unified addition law, complete on edwards25519, so scalar
ladders and tree sums run one formula for every lane.  Every function
issues the JAX package's field-op sequence over the 26-limb field of
2^255 − 19 (field.ED25519_FQ), so its outputs are bit-identical; where
JAX scans, this module runs a Python loop.

``add`` is a kernel's wrapper: on CUDA tensors it launches
csrc/ed_point.cu (kernels.ed_add), on CPU tensors it runs ``add_plain``,
the formula over the plain field.  ``scalar_mul_bits`` packs the bits
(``pack_bits``) and runs ``ladder``: on CUDA tensors the whole ladder
is one launch of the same source's ed_ladder_kernel
(kernels.ed_ladder), on CPU tensors ``ladder_plain``, the JAX scan's
loop over ``add_plain`` fed from the packed bits.
``scalar_mul_steps`` is that loop over ``add``, one ed_add launch a
step on CUDA tensors.  Decompression's field ops run the fq_mul kernel
built for this field on CUDA tensors.

Host side, in Python ints: the RFC 8032 key and signature of a seed
(``host_pub_key``, ``host_sign``; byte-equal to the JAX package's) and
the cofactored single-signature rule ``host_verify_cofactored``, which
gives the JAX function's verdicts over extended-coordinate adds instead
of its affine adds with two field inversions each.  Multiples of the
base point come from a table of d·16^j·B (``_base_mul``).
"""

from __future__ import annotations

import hashlib
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from . import kernels
from .curve import int32_words, int_to_bits_msb_np
from .field import ED25519_FQ, ED25519_P, PlainField, Tensor

FE = ED25519_FQ
_PLAIN = PlainField(FE)

P = ED25519_P
#: group order (prime subgroup): 2^252 + δ
L = 2**252 + 27742317777372353535851937790883648493
#: curve constant d = −121665/121666
D = (-121665 * pow(121666, P - 2, P)) % P
D2 = (2 * D) % P
SQRT_M1 = pow(2, (P - 1) // 4, P)
#: base point: y = 4/5, x = the even root
_B_Y = (4 * pow(5, P - 2, P)) % P


def _xrecover(y: int, sign: int) -> Optional[int]:
    u = (y * y - 1) % P
    v = (D * y * y + 1) % P
    x = u * pow(v, 3, P) % P * pow(u * pow(v, 7, P) % P, (P - 5) // 8, P) % P
    if (v * x * x - u) % P != 0:
        x = x * SQRT_M1 % P
    if (v * x * x - u) % P != 0:
        return None
    if x == 0 and sign:
        return None
    if x & 1 != sign:
        x = P - x
    return x


_B_X = _xrecover(_B_Y, 0)


class EdPoint(NamedTuple):
    """Extended coordinates (X : Y : Z : T), each a (..., n) limb
    tensor."""
    x: Tensor
    y: Tensor
    z: Tensor
    t: Tensor


def identity_like(coord: Tensor) -> EdPoint:
    zero = torch.zeros_like(coord)
    one = FE.one(coord.device).expand(coord.shape).clone()
    return EdPoint(zero, one, one.clone(), zero.clone())


def from_affine(x: Tensor, y: Tensor) -> EdPoint:
    one = FE.one(x.device).expand(x.shape).clone()
    return EdPoint(x, y, one, FE.mul(x, y))


def base_point(batch: int = 1, device="cpu") -> EdPoint:
    x = FE.constant(_B_X, device).expand(batch, FE.n).clone()
    y = FE.constant(_B_Y, device).expand(batch, FE.n).clone()
    return from_affine(x, y)


def _add(f, p: EdPoint, q: EdPoint) -> EdPoint:
    """HWCD unified addition (a = −1) over the field object f: 9
    products."""
    d2 = f.constant(D2, p.x.device)
    a = f.mul(f.sub(p.y, p.x), f.sub(q.y, q.x))
    b = f.mul(f.add(p.y, p.x), f.add(q.y, q.x))
    c = f.mul(f.mul(p.t, d2), q.t)
    d = f.mul(f.add(p.z, p.z), q.z)
    e = f.sub(b, a)
    g = f.add(d, c)
    f_ = f.sub(d, c)
    h = f.add(b, a)
    return EdPoint(f.mul(e, f_), f.mul(g, h), f.mul(f_, g), f.mul(e, h))


def add_plain(p: EdPoint, q: EdPoint) -> EdPoint:
    """The plain version of the ed_add kernel: the formula over the plain
    field, on any device, launching no kernel."""
    return _add(_PLAIN, p, q)


def add(p: EdPoint, q: EdPoint) -> EdPoint:
    """p + q: the ed_add kernel on CUDA tensors, add_plain on CPU
    tensors; the two are bit-identical."""
    if p.x.device.type == "cpu":
        return add_plain(p, q)
    coords = torch.broadcast_tensors(*p, *q)
    shape = coords[0].shape
    lanes = tuple(c.reshape(-1, FE.n).contiguous() for c in coords)
    d2 = FE.constant(D2, p.x.device)[None]
    out = kernels.ed_add(FE, lanes[:4], lanes[4:], d2)
    return EdPoint(*(c.reshape(shape) for c in out))


def neg(p: EdPoint) -> EdPoint:
    return EdPoint(FE.neg(p.x), p.y, p.z, FE.neg(p.t))


def select(mask: Tensor, p: EdPoint, q: EdPoint) -> EdPoint:
    m = mask[..., None]
    return EdPoint(*(torch.where(m, a, b) for a, b in zip(p, q)))


def is_identity(p: EdPoint) -> Tensor:
    """(0 : λ : λ : 0): X = 0, T = 0, Y = Z (Y = −Z is the 2-torsion
    point (0, −1), which [8]·(anything) never leaves behind)."""
    return FE.is_zero(p.x) & FE.is_zero(p.t) & FE.eq(p.y, p.z)


def _ladder(p: EdPoint, bits: Tensor, add_fn) -> EdPoint:
    acc = identity_like(p.x)
    for bit in torch.movedim(bits, -1, 0).bool():
        acc2 = add_fn(acc, acc)
        acc = select(bit, add_fn(acc2, p), acc2)
    return acc


def scalar_mul_steps(p: EdPoint, bits: Tensor) -> EdPoint:
    """p_i · k_i for per-lane MSB-first bit tensors, batch + (nbits,): a
    doubling and an add of p where the bit is set, per bit, as the JAX
    scan does; on CUDA tensors one ed_add launch per add."""
    return _ladder(p, bits, add)


def pack_bits(bits: Tensor) -> Tensor:
    """(B, nbits) MSB-first bits (nonzero = 1) → (B, ceil(nbits / 32))
    int32: bit i in word i // 32 at position 31 − i % 32, the ladder
    kernel's layout (32 bytes a lane at 256 bits)."""
    b, nbits = bits.shape
    words = kernels.packed_words(nbits, 32)
    wide = torch.zeros((b, words * 32), dtype=torch.int64, device=bits.device)
    wide[:, :nbits] = bits != 0
    shifts = torch.arange(31, -1, -1, device=bits.device)
    return int32_words((wide.view(b, words, 32) << shifts).sum(-1))


def unpack_bits(packed: Tensor, nbits: int) -> Tensor:
    """pack_bits' inverse: (B, nbits) int32 bits of 0 and 1."""
    shifts = torch.arange(31, -1, -1, device=packed.device)
    bits = (packed.long()[..., None] >> shifts) & 1
    return bits.reshape(packed.shape[0], -1)[:, :nbits].to(torch.int32)


def ladder_plain(p: EdPoint, packed: Tensor, nbits: int) -> EdPoint:
    """The plain version of the ed_ladder kernel: the JAX scan's loop
    over add_plain, on any device, launching no kernel."""
    return _ladder(p, unpack_bits(packed, nbits), add_plain)


def ladder(p: EdPoint, packed: Tensor, nbits: int) -> EdPoint:
    """p_i · k_i for (B, n) coordinates and pack_bits' words: the
    ed_ladder kernel on CUDA tensors (one launch), ladder_plain on CPU
    tensors; the two are bit-identical."""
    if p.x.device.type == "cpu":
        return ladder_plain(p, packed, nbits)
    lanes = tuple(c.contiguous() for c in p)
    dev = p.x.device
    return EdPoint(*kernels.ed_ladder(
        FE, lanes, packed.contiguous(), nbits, FE.constant(D2, dev)[None],
        FE.one(dev)[None].contiguous()))


def scalar_mul_bits(p: EdPoint, bits: Tensor) -> EdPoint:
    """p_i · k_i for (B, n) coordinates and (B, nbits) MSB-first bits:
    the ladder of scalar_mul_steps, in one launch on CUDA tensors."""
    return ladder(p, pack_bits(bits), bits.shape[-1])


def tree_sum(p: EdPoint) -> EdPoint:
    """Σ over the leading batch axis in log2 steps (padded to a power of
    two, at least 2, with identities)."""
    n = p.x.shape[0]
    size = 1 << max(1, (n - 1).bit_length())
    if size != n:
        pad = identity_like(p.x.new_zeros((size - n,) + p.x.shape[1:]))
        p = EdPoint(*(torch.cat([a, b]) for a, b in zip(p, pad)))
    while p.x.shape[0] > 1:
        half = p.x.shape[0] // 2
        p = add(EdPoint(*(a[:half] for a in p)),
                EdPoint(*(a[half:] for a in p)))
    return p


def mul8(p: EdPoint) -> EdPoint:
    p = add(p, p)
    p = add(p, p)
    return add(p, p)


def decompress(y: Tensor, sign: Tensor) -> Tuple[EdPoint, Tensor]:
    """Batched point decompression: x from y and the sign bit.  Returns
    (point, valid); invalid lanes carry garbage flagged False."""
    dev = y.device
    one = FE.one(dev).expand(y.shape)
    y2 = FE.sq(y)
    u = FE.sub(y2, one)
    v = FE.add(FE.mul(FE.constant(D, dev), y2), one)
    v3 = FE.mul(FE.sq(v), v)
    v7 = FE.mul(FE.sq(v3), v)
    pow_arg = FE.mul(u, v7)
    w = FE.pow_static(pow_arg, (P - 5) // 8)
    x = FE.mul(FE.mul(u, v3), w)
    vx2 = FE.mul(v, FE.sq(x))
    root_ok = FE.eq(vx2, u)
    neg_ok = FE.eq(vx2, FE.neg(u))
    x = FE.where(~root_ok & neg_ok, FE.mul(x, FE.constant(SQRT_M1, dev)), x)
    valid = root_ok | neg_ok
    valid = valid & ~(FE.is_zero(x) & sign)
    parity = (FE.strict(x)[..., 0] & 1) == 1
    x = FE.where(parity != sign, FE.neg(x), x)
    return from_affine(x, y), valid


# ---------------------------------------------------------------------------
# Host-side parsing
# ---------------------------------------------------------------------------

class ParsedEd(NamedTuple):
    y: np.ndarray           # (B, n) int32 limb rows
    sign: np.ndarray        # (B,) bool
    wellformed: np.ndarray  # (B,) bool


def parse_points(blobs: Sequence[bytes]) -> ParsedEd:
    """32-byte little-endian encodings → limb rows and sign bits; y ≥ p
    (a non-canonical encoding) and a wrong length are rejected here."""
    b = len(blobs)
    y = np.zeros((b, FE.n), np.int32)
    sign = np.zeros(b, bool)
    ok = np.zeros(b, bool)
    for i, blob in enumerate(blobs):
        if len(blob) != 32:
            continue
        v = int.from_bytes(blob, "little")
        yv = v & ((1 << 255) - 1)
        if yv >= P:
            continue
        y[i] = FE.from_int(yv)
        sign[i] = bool(v >> 255)
        ok[i] = True
    return ParsedEd(y, sign, ok)


def int_to_bits_msb(values: Sequence[int], nbits: int) -> np.ndarray:
    """MSB-first (len, nbits) int32 bit matrix (numpy)."""
    return int_to_bits_msb_np(values, nbits)


# ---------------------------------------------------------------------------
# Host side (Python ints): keys, signatures and the cofactored rule.  The
# single-signature rule MUST be the batched relation's ([8]-multiplied,
# RFC 8032-permitted), or two honest nodes could split on one
# adversarial torsioned signature depending on which path verified it.
# ---------------------------------------------------------------------------

_IDENTITY = (0, 1, 1, 0)


def _ext_add(p, q):
    """Unified extended-coordinate addition (add-2008-hwcd-3, a = −1),
    complete on edwards25519: no inversion."""
    x1, y1, z1, t1 = p
    x2, y2, z2, t2 = q
    a = (y1 - x1) * (y2 - x2) % P
    b = (y1 + x1) * (y2 + x2) % P
    c = 2 * t1 * t2 % P * D % P
    d = 2 * z1 * z2 % P
    e, f, g, h = b - a, d - c, d + c, b + a
    return (e * f % P, g * h % P, f * g % P, e * h % P)


def _ext_of(pt_affine):
    x, y = pt_affine
    return (x, y, 1, x * y % P)


def _ext_mul_ext(q, k: int):
    """[k]·q over extended coordinates, q and the result extended."""
    acc = _IDENTITY
    while k:
        if k & 1:
            acc = _ext_add(acc, q)
        q = _ext_add(q, q)
        k >>= 1
    return acc


def _affine(pt) -> Tuple[int, int]:
    x, y, z, _ = pt
    zi = pow(z, -1, P)
    return (x * zi % P, y * zi % P)


_BASE_TABLE: List[List[tuple]] = []


def _base_mul(k: int):
    """[k]·B (extended) from a table of d·16^j·B, d = 1..15, j = 0..63
    (built on first use): one add per nonzero base-16 digit."""
    if not _BASE_TABLE:
        q = _ext_of((_B_X, _B_Y))
        for _ in range(64):
            row = [q]
            for _ in range(14):
                row.append(_ext_add(row[-1], q))
            _BASE_TABLE.append(row)
            q = _ext_add(row[-1], q)  # 16·q
    acc = _IDENTITY
    for j in range(64):
        d = (k >> (4 * j)) & 15
        if d:
            acc = _ext_add(acc, _BASE_TABLE[j][d - 1])
    return acc


def _host_decompress(blob: bytes) -> Optional[Tuple[int, int]]:
    if len(blob) != 32:
        return None
    v = int.from_bytes(blob, "little")
    y = v & ((1 << 255) - 1)
    if y >= P:
        return None
    x = _xrecover(y, v >> 255)
    if x is None:
        return None
    return (x, y)


def _encode_point(pt_affine) -> bytes:
    x, y = pt_affine
    return (y | ((x & 1) << 255)).to_bytes(32, "little")


def _expand_seed(seed32: bytes) -> Tuple[int, bytes]:
    h = hashlib.sha512(bytes(seed32)).digest()
    a = int.from_bytes(h[:32], "little")
    a &= (1 << 254) - 8
    a |= 1 << 254
    return a, h[32:]


def host_pub_key(seed32: bytes) -> bytes:
    """RFC 8032 public key of a 32-byte seed, in Python ints."""
    a, _ = _expand_seed(seed32)
    return _encode_point(_affine(_base_mul(a)))


def host_sign(seed32: bytes, message: bytes) -> bytes:
    """RFC 8032 Ed25519 signature over `message`, in Python ints: the
    signer of the port's Ed25519 provider, which needs no `cryptography`
    package."""
    a, prefix = _expand_seed(seed32)
    a_enc = _encode_point(_affine(_base_mul(a)))
    r = int.from_bytes(hashlib.sha512(prefix + bytes(message)).digest(),
                       "little") % L
    r_enc = _encode_point(_affine(_base_mul(r)))
    k = int.from_bytes(
        hashlib.sha512(r_enc + a_enc + bytes(message)).digest(),
        "little") % L
    s = (r + k * a) % L
    return r_enc + s.to_bytes(32, "little")


def host_verify_cofactored(signature: bytes, message: bytes,
                           pubkey: bytes) -> bool:
    """[8]([s]B − R − [h]A) == identity: the batch relation at batch size
    one, the JAX package's rule, computed over extended coordinates."""
    if len(signature) != 64:
        return False
    r_pt = _host_decompress(signature[:32])
    a_pt = _host_decompress(bytes(pubkey))
    if r_pt is None or a_pt is None:
        return False
    s = int.from_bytes(signature[32:], "little")
    if s >= L:
        return False
    h = int.from_bytes(
        hashlib.sha512(signature[:32] + bytes(pubkey) + bytes(message))
        .digest(), "little") % L
    rhs = _ext_add(_ext_of(r_pt), _ext_mul_ext(_ext_of(a_pt), h))
    x, y, z, t = rhs
    diff = _ext_add(_base_mul(s), ((P - x) % P, y, z, (P - t) % P))
    x8, y8, z8, _ = _ext_mul_ext(diff, 8)
    return x8 == 0 and (y8 - z8) % P == 0
