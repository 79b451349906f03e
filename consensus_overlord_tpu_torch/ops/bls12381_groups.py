"""BLS12-381 G1/G2 group ops on device, plus host-side wire parsing.

The counterpart of consensus_overlord_tpu/ops/bls12381_groups.py in its
CONSENSUS_PALLAS=1 configuration: every Fq multiply goes through the
fq_mul CUDA kernel, G1's add and double go through the fused
csrc/g1_point.cu kernels and G2's through csrc/g2_point.cu (on CPU
tensors, through their plain versions ``G1.add_plain`` / ``dbl_plain``
and ``G2.add_plain`` / ``dbl_plain``).

G1: y² = x³ + 4 over Fq (48-byte compressed points — signatures).
G2: y² = x³ + 4(1+u) over Fq2 (96-byte compressed points — public keys,
which double as validator addresses, reference src/consensus.rs:352-357).
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Sequence, Tuple

import numpy as np
import torch

from ..crypto import bls12381 as oracle
from . import kernels
from .curve import CurveOps, Point
from .field import BLS12_381_FQ, PlainField, Tensor
from .fq2 import Fq2Ops

FQ = BLS12_381_FQ
FQ2 = Fq2Ops(FQ)
R = oracle.R  # subgroup order
_B3 = 12  # b = 4  →  b3 = 12;   b' = 4(1+u)  →  b3' = 12(1+u)


class _FusedCurveOps(CurveOps):
    """A curve whose add and double are fused kernels on CUDA tensors,
    each launched over the (-1, *lane) lanes of the broadcast
    coordinates, and whose plain versions are the generic formulas over
    the plain field, which launch nothing.  G1's kernels are
    bit-identical to their plain versions; G2's return the same field
    elements in limbs of their own (csrc/g2_point.cu), equal after
    FieldSpec.strict.  A failed build or launch raises: nothing falls
    back to the formulas."""

    def __init__(self, field, plain, mul_b3_of, name: str, add_kernel,
                 dbl_kernel):
        super().__init__(field, mul_b3_of(field), name)
        self._plain = CurveOps(plain, mul_b3_of(plain), f"{name}_plain")
        self._add_kernel, self._dbl_kernel = add_kernel, dbl_kernel
        self._lane = tuple(field.one().shape)

    def _lanes(self, *coords: Tensor):
        coords = torch.broadcast_tensors(*coords)
        shape = coords[0].shape
        return shape, tuple(c.reshape((-1,) + self._lane).contiguous()
                            for c in coords)

    def add(self, p: Point, q: Point) -> Point:
        if p.x.device.type == "cpu":
            return self.add_plain(p, q)
        shape, lanes = self._lanes(*p, *q)
        out = self._add_kernel(FQ, lanes[:3], lanes[3:])
        return Point(*(c.reshape(shape) for c in out))

    def dbl(self, p: Point) -> Point:
        if p.x.device.type == "cpu":
            return self.dbl_plain(p)
        shape, lanes = self._lanes(*p)
        out = self._dbl_kernel(FQ, lanes)
        return Point(*(c.reshape(shape) for c in out))

    def add_plain(self, p: Point, q: Point) -> Point:
        return self._plain.add(p, q)

    def dbl_plain(self, p: Point) -> Point:
        return self._plain.dbl(p)


class G1Ops(_FusedCurveOps):
    """G1 over Fq, its group law the kernels of csrc/g1_point.cu."""

    def __init__(self):
        super().__init__(FQ, PlainField(FQ),
                         lambda f: lambda x: f.mul_small(x, _B3),
                         "bls12381_g1", kernels.g1_add, kernels.g1_dbl)


class G2Ops(_FusedCurveOps):
    """G2 over Fq2, its group law the kernels of csrc/g2_point.cu; the
    plain versions run over Fq2 of the plain field."""

    def __init__(self):
        super().__init__(FQ2, Fq2Ops(PlainField(FQ)),
                         lambda f: lambda x: f.mul_small_xi(x, _B3),
                         "bls12381_g2", kernels.g2_add, kernels.g2_dbl)


G1 = G1Ops()
G2 = G2Ops()

_FLAG_COMPRESSED = 0x80
_FLAG_INFINITY = 0x40
_FLAG_SIGN = 0x20
_HALF_PLUS_1 = (oracle.P - 1) // 2 + 1

Z_ABS = 0xD201000000010000  # |z|; z itself is negative

# β = 2^((p−1)/3) mod p — the cube root whose φ acts as λ = −z² on G1.
_BETA_INT = pow(2, (oracle.P - 1) // 3, oracle.P)
# ψ twist constants over Fq2 (ξ = 1 + u).
_PSI_CX_INT = oracle.fq2_inv(oracle._fq2_pow((1, 1), (oracle.P - 1) // 3))
_PSI_CY_INT = oracle.fq2_inv(oracle._fq2_pow((1, 1), (oracle.P - 1) // 2))
_CONST_NP = {
    "g1_b": FQ.from_int(4),
    "g2_b": FQ2.from_ints([(4, 4)])[0],  # 4 + 4u
    "beta": FQ.from_int(_BETA_INT),
    "psi_cx": FQ2.from_ints([_PSI_CX_INT])[0],
    "psi_cy": FQ2.from_ints([_PSI_CY_INT])[0],
}
_consts: Dict[Tuple[str, torch.device], Tensor] = {}


def _const(name: str, device) -> Tensor:
    """A curve constant as an int32 tensor on `device` (uploaded once)."""
    key = (name, torch.device(device))
    t = _consts.get(key)
    if t is None:
        t = _consts[key] = torch.as_tensor(_CONST_NP[name], device=key[1])
    return t


# ---------------------------------------------------------------------------
# Host-side wire parsing (flag bits, range checks) into numpy arrays;
# `wellformed` folds every host-detectable format error so malformed
# input degrades to a False lane, never an exception.
# ---------------------------------------------------------------------------

class ParsedG1(NamedTuple):
    x: np.ndarray          # (B, n) limbs
    sign: np.ndarray       # (B,) bool — lexicographically-largest flag
    infinity: np.ndarray   # (B,) bool
    wellformed: np.ndarray  # (B,) bool


class ParsedG2(NamedTuple):
    x: np.ndarray          # (B, 2, n) limbs
    sign: np.ndarray
    infinity: np.ndarray
    wellformed: np.ndarray


def parse_g1_compressed(blobs: Sequence[bytes]) -> ParsedG1:
    b = len(blobs)
    x = np.zeros((b, FQ.n), dtype=np.int32)
    sign = np.zeros(b, dtype=bool)
    inf = np.zeros(b, dtype=bool)
    ok = np.zeros(b, dtype=bool)
    for i, blob in enumerate(blobs):
        if len(blob) != 48 or not blob[0] & _FLAG_COMPRESSED:
            continue
        flags = blob[0]
        if flags & _FLAG_INFINITY:
            if flags & _FLAG_SIGN or flags & 0x1F or any(blob[1:]):
                continue
            inf[i] = ok[i] = True
            continue
        xv = int.from_bytes(bytes([flags & 0x1F]) + blob[1:], "big")
        if xv >= oracle.P:
            continue
        x[i] = FQ.from_int(xv)
        sign[i] = bool(flags & _FLAG_SIGN)
        ok[i] = True
    return ParsedG1(x, sign, inf, ok)


def parse_g2_compressed(blobs: Sequence[bytes]) -> ParsedG2:
    b = len(blobs)
    x = np.zeros((b, 2, FQ.n), dtype=np.int32)
    sign = np.zeros(b, dtype=bool)
    inf = np.zeros(b, dtype=bool)
    ok = np.zeros(b, dtype=bool)
    for i, blob in enumerate(blobs):
        if len(blob) != 96 or not blob[0] & _FLAG_COMPRESSED:
            continue
        flags = blob[0]
        if flags & _FLAG_INFINITY:
            if flags & _FLAG_SIGN or flags & 0x1F or any(blob[1:]):
                continue
            inf[i] = ok[i] = True
            continue
        x1 = int.from_bytes(bytes([flags & 0x1F]) + blob[1:48], "big")
        x0 = int.from_bytes(blob[48:], "big")
        if x0 >= oracle.P or x1 >= oracle.P:
            continue
        x[i, 0] = FQ.from_int(x0)
        x[i, 1] = FQ.from_int(x1)
        sign[i] = bool(flags & _FLAG_SIGN)
        ok[i] = True
    return ParsedG2(x, sign, inf, ok)


# ---------------------------------------------------------------------------
# Device-side batched decompression: solve y² = x³ + b, pick the root by
# the sign flag.  Invalid lanes (x not on curve) carry garbage points
# flagged False.
# ---------------------------------------------------------------------------

def g1_decompress_device(x: Tensor, sign: Tensor, infinity: Tensor,
                         wellformed: Tensor) -> Tuple[Point, Tensor]:
    rhs = FQ.add(FQ.mul(FQ.sq(x), x), _const("g1_b", x.device))
    y = FQ.sqrt_candidate(rhs)
    on_curve = FQ.eq(FQ.sq(y), rhs)
    flip = FQ.geq_const(y, _HALF_PLUS_1) != sign
    y = FQ.where(flip, FQ.neg(y), y)
    pt = G1.from_affine(x, y)
    pt = G1.select(infinity, G1.infinity_like(x), pt)
    valid = wellformed & (on_curve | infinity)
    return pt, valid


def g2_decompress_device(x: Tensor, sign: Tensor, infinity: Tensor,
                         wellformed: Tensor) -> Tuple[Point, Tensor]:
    rhs = FQ2.add(FQ2.mul(FQ2.sq(x), x), _const("g2_b", x.device))
    y, on_curve = FQ2.sqrt_checked(rhs)
    flip = FQ2.is_lex_largest(y) != sign
    y = FQ2.where(flip, FQ2.neg(y), y)
    pt = G2.from_affine(x, y)
    pt = G2.select(infinity, G2.infinity_like(x), pt)
    valid = wellformed & (on_curve | infinity)
    return pt, valid


# ---------------------------------------------------------------------------
# Subgroup membership by the endomorphism criteria (M. Scott 2021), with
# z = -0xd201000000010000 (r = z⁴ − z² + 1):
#   G1:  φ(x, y) = (β·x, y) acts as [−z²]:  P ∈ G1 ⇔ on curve ∧ φ(P) == [−z²]P
#   G2:  ψ = twist∘Frobenius∘untwist acts as [z]:  Q ∈ G2 ⇔ on curve ∧ ψ(Q) == [z]Q
# ---------------------------------------------------------------------------

def g1_endomorphism(p: Point) -> Point:
    """φ(X:Y:Z) = (βX : Y : Z) — one field mul."""
    return Point(FQ.mul(p.x, _const("beta", p.x.device)), p.y, p.z)


def g2_endomorphism(p: Point) -> Point:
    """ψ(X:Y:Z) = (c_x·X̄ : c_y·Ȳ : Z̄)."""
    dev = p.x.device
    return Point(FQ2.mul(FQ2.conj(p.x), _const("psi_cx", dev)),
                 FQ2.mul(FQ2.conj(p.y), _const("psi_cy", dev)),
                 FQ2.conj(p.z))


def g1_in_subgroup(p: Point) -> Tensor:
    """φ(P) == [−z²]P via one dense z² ladder."""
    z2p = G1.scalar_mul_static(p, Z_ABS * Z_ABS)
    return G1.eq(g1_endomorphism(p), G1.neg(z2p)) & G1.on_curve(p)


def g2_in_subgroup(p: Point) -> Tensor:
    """ψ(Q) == [z]Q = −[|z|]Q."""
    zq = G2.neg(G2.scalar_mul_static(p, Z_ABS))
    return G2.eq(g2_endomorphism(p), zq) & G2.on_curve(p)


# ---------------------------------------------------------------------------
# Composite device steps of the verify round (crypto/cuda_provider.py).
# ---------------------------------------------------------------------------

def unpack_weight_bits(wpacked: Tensor) -> Tensor:
    """(B, 8) uint8 → (B, 64) int32 MSB-first bit tensor, on device."""
    w = wpacked.to(torch.int32)
    shifts = torch.arange(7, -1, -1, dtype=torch.int32, device=w.device)
    bits = (w[..., None] >> shifts) & 1
    return bits.reshape(w.shape[:-1] + (w.shape[-1] * 8,))


def gather_rows(rows: Tensor, px: Tensor, py: Tensor, pz: Tensor) -> Point:
    """Gather pubkey rows from the device-resident cache (rows are
    validated host-side; masked lanes point at row 0)."""
    return Point(px.index_select(0, rows), py.index_select(0, rows),
                 pz.index_select(0, rows))


def g1_validate_batch(x: Tensor, sign: Tensor, infinity: Tensor,
                      wellformed: Tensor) -> Tuple[Point, Tensor]:
    """Decompress + validate + PER-LANE subgroup-check a G1 signature
    batch; invalid lanes become the identity.  The subgroup check must
    stay per lane: a batched check by linearity is unsound for the
    cofactor's small-torsion points (the order-3 point (0, 2) cancels
    under a random combination with probability 1/3)."""
    pt, valid = g1_decompress_device(x, sign, infinity, wellformed)
    valid = valid & ~infinity & g1_in_subgroup(pt)
    return G1.select(valid, pt, G1.infinity_like(x)), valid


# ---------------------------------------------------------------------------
# Host conversions for cross-checking with the oracle.
# ---------------------------------------------------------------------------

def g1_to_oracle(p: Point) -> List:
    x, y, inf = G1.to_affine(p)
    xs, ys = FQ.to_ints(x), FQ.to_ints(y)
    infs = inf.cpu().numpy().reshape(-1)
    return [None if i else (xv, yv) for xv, yv, i in zip(xs, ys, infs)]


def g2_to_oracle(p: Point) -> List:
    x, y, inf = G2.to_affine(p)
    xs, ys = FQ2.to_int_pairs(x), FQ2.to_int_pairs(y)
    infs = inf.cpu().numpy().reshape(-1)
    return [None if i else (xv, yv) for xv, yv, i in zip(xs, ys, infs)]


def g1_from_oracle(pts: Sequence, device="cpu") -> Point:
    xs = [0 if p is None else p[0] for p in pts]
    ys = [1 if p is None else p[1] for p in pts]
    zs = [0 if p is None else 1 for p in pts]
    return Point(*(torch.as_tensor(FQ.from_ints(v), device=device)
                   for v in (xs, ys, zs)))


def g2_from_oracle(pts: Sequence, device="cpu") -> Point:
    xs = [(0, 0) if p is None else p[0] for p in pts]
    ys = [(1, 0) if p is None else p[1] for p in pts]
    zs = [(0, 0) if p is None else (1, 0) for p in pts]
    return Point(*(torch.as_tensor(FQ2.from_ints(v), device=device)
                   for v in (xs, ys, zs)))
