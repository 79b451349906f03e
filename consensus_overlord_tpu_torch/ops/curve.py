"""Batched elliptic-curve arithmetic with branchless complete addition.

The counterpart of consensus_overlord_tpu/ops/curve.py.  Points live in
homogeneous projective coordinates (X:Y:Z) over a pluggable field (Fq for
G1, Fq2 for G2), with the Renes–Costello–Batina complete formulas for
a = 0, so add, double, identity and inverse pairs share one code path.
Every method issues the same field-op sequence as the JAX package's, so
outputs are bit-identical (on CUDA tensors G2's add and double are
kernels that return the same field elements in limbs of their own:
ops/bls12381_groups.py); where JAX scans, this module runs a Python
loop, and where JAX selects a table row by a one-hot contraction, this
module gathers it (the same values).
"""

from __future__ import annotations

from typing import Callable, List, NamedTuple, Sequence

import numpy as np
import torch

from .field import Tensor


class Point(NamedTuple):
    """A batch of projective points; each coordinate is a field-layout
    tensor ((..., n) for Fq, (..., 2, n) for Fq2)."""
    x: Tensor
    y: Tensor
    z: Tensor


def _signed_base16_digits(k: int) -> List[int]:
    """MSB-first signed base-16 digits of k ≥ 1, each in [−8, 8]."""
    digs: List[int] = []
    v = k
    while v:
        d = v & 15
        if d > 8:
            d -= 16
        v = (v - d) >> 4
        digs.append(d)
    digs.reverse()
    return digs


def int_to_bits_msb_np(values: Sequence[int], nbits: int) -> np.ndarray:
    """Ints → a (len, nbits) MSB-first int32 numpy bit array for the
    scalar ladders, by np.unpackbits over the big-endian bytes."""
    nbytes = -(-nbits // 8)
    packed = b"".join(v.to_bytes(nbytes, "big") for v in values)
    arr = np.frombuffer(packed, np.uint8).reshape(len(values), nbytes)
    return np.unpackbits(arr, axis=1)[:, nbytes * 8 - nbits:].astype(
        np.int32)


def int32_words(v: Tensor) -> Tensor:
    """Words of 32 bits held in int64 as values in [0, 2**32) → int32
    with the same bits (the ladder kernels read them as unsigned)."""
    return torch.where(v >= 1 << 31, v - (1 << 32), v).to(torch.int32)


def _stack(points: List[Point]) -> Point:
    return Point(torch.stack([p.x for p in points]),
                 torch.stack([p.y for p in points]),
                 torch.stack([p.z for p in points]))


class CurveOps:
    """Group ops over any field object exposing the FieldSpec surface
    (add/sub/neg/mul/sq/mul_small/is_zero/eq/where/one/inv).

    mul_b3: multiply a field element by 3·b, the constant term of the
    complete-addition formula (G2's b3 = 12·(1+u) uses the ξ path)."""

    def __init__(self, field, mul_b3: Callable[[Tensor], Tensor], name: str):
        self.f = field
        self.mul_b3 = mul_b3
        self.name = name

    # -- constructors --------------------------------------------------------

    def infinity_like(self, coord: Tensor) -> Point:
        one = self.f.one(coord.device).expand(coord.shape).clone()
        zero = torch.zeros_like(coord)
        return Point(zero, one, zero)

    def from_affine(self, x: Tensor, y: Tensor) -> Point:
        one = self.f.one(x.device).expand(x.shape).clone()
        return Point(x, y, one)

    # -- group law -----------------------------------------------------------

    def add(self, p: Point, q: Point) -> Point:
        """Complete projective addition for a=0 (Renes–Costello–Batina 2016,
        Algorithm 7): 12 field muls, valid for every input pair.  The
        independent products of each stage run as one stacked call."""
        f, mul_b3, st = self.f, self.mul_b3, torch.stack
        x1, y1, z1, x2, y2, z2 = torch.broadcast_tensors(*p, *q)
        t0, t1, t2 = f.mul(st([x1, y1, z1]), st([x2, y2, z2]))
        s = f.add(st([x1, y1, x1, x2, y2, x2]), st([y1, z1, z1, y2, z2, z2]))
        # (x1+y1)(x2+y2) − (t0+t1), (y1+z1)(y2+z2) − (t1+t2),
        # (x1+z1)(x2+z2) − (t0+t2)  =  x1y2+x2y1, y1z2+y2z1, x1z2+x2z1
        t3, t4, t5 = f.sub(f.mul(s[:3], s[3:]),
                           f.add(st([t0, t1, t0]), st([t1, t2, t2])))
        three_t0 = f.mul_small(t0, 3)
        b3_t2, y3 = mul_b3(st([t2, t5]))
        z3 = f.add(t1, b3_t2)
        t1 = f.sub(t1, b3_t2)
        m = f.mul(st([t3, t4, t1, y3, z3, three_t0]),
                  st([t1, y3, z3, three_t0, t4, t3]))
        x3 = f.sub(m[0], m[1])
        y3, z3 = f.add(m[2::2], m[3::2])
        return Point(x3, y3, z3)

    def dbl(self, p: Point) -> Point:
        """Dedicated doubling (Renes–Costello–Batina 2016, Algorithm 9,
        a = 0): 8 field muls, exception-free for every input."""
        f, mul_b3, st = self.f, self.mul_b3, torch.stack
        x, y, z = torch.broadcast_tensors(*p)
        t0, t1, zz, xy = f.mul(st([y, y, z, x]), st([y, z, z, y]))  # Y², YZ, Z², XY
        z3 = f.mul_small(t0, 8)                           # 8Y²
        t2 = mul_b3(zz)                                   # 3bZ²
        x3, z3 = f.mul(st([t2, t1]), st([z3, z3]))        # 24bY²Z², 8Y³Z
        y3 = f.add(t0, t2)                                # Y² + 3bZ²
        t0 = f.sub(t0, f.mul_small(t2, 3))                # Y² − 9bZ²
        m = f.mul(st([t0, t0]), st([y3, xy]))
        y3 = f.add(m[0], x3)              # (Y²−9bZ²)(Y²+3bZ²) + 24bY²Z²
        x3 = f.mul_small(m[1], 2)         # 2XY(Y²−9bZ²)
        return Point(x3, y3, z3)

    def neg(self, p: Point) -> Point:
        return Point(p.x, self.f.neg(p.y), p.z)

    def select(self, mask: Tensor, p: Point, q: Point) -> Point:
        """Per-batch-element choice between two point batches."""
        f = self.f
        return Point(f.where(mask, p.x, q.x), f.where(mask, p.y, q.y),
                     f.where(mask, p.z, q.z))

    # -- predicates ----------------------------------------------------------

    def is_infinity(self, p: Point) -> Tensor:
        return self.f.is_zero(p.z)

    def eq(self, p: Point, q: Point) -> Tensor:
        """Projective equality by cross-multiplied coordinates."""
        f, st = self.f, torch.stack
        px, py, pz, qx, qy, qz = torch.broadcast_tensors(*p, *q)
        m = f.mul(st([px, qx, py, qy]), st([qz, pz, qz, pz]))
        ex, ey = f.eq(m[0::2], m[1::2])
        return ex & ey

    def on_curve(self, p: Point) -> Tensor:
        """Y²Z == X³ + b·Z³ (projective curve equation; identity passes)."""
        f, st = self.f, torch.stack
        x, y, z = torch.broadcast_tensors(*p)
        sq = f.mul(st([y, z, x]), st([y, z, x]))
        lhs, z3, x3 = f.mul(sq, st([z, z, x]))  # Y²Z, Z³, X³
        rhs3 = f.add(f.mul_small(x3, 3), self.mul_b3(z3))  # 3X³ + 3b·Z³
        return f.eq(f.mul_small(lhs, 3), rhs3)

    # -- scalar multiplication ----------------------------------------------

    def scalar_mul_static(self, p: Point, k: int) -> Point:
        """p·k for a static Python-int scalar: signed base-16 digits, a
        0..8·p table (negation is a free y-flip), 4 doublings + 1 table
        add per digit."""
        if k < 0:
            return self.scalar_mul_static(self.neg(p), -k)
        if k == 0:
            return self.infinity_like(p.x)
        table = self._build_table(p, 9)
        acc = self.infinity_like(p.x)
        for d in _signed_base16_digits(k):
            for _ in range(4):
                acc = self.dbl(acc)
            t = table[abs(d)]
            if d < 0:
                t = self.neg(t)
            acc = self.add(acc, t)
        return acc

    def _build_table(self, p: Point, count: int) -> List[Point]:
        """[0·p, 1·p, ..., (count−1)·p] as one add-chain (entry 2 is
        p + p by the complete add, as in the JAX scan)."""
        entries = [self.infinity_like(p.x), p]
        acc = p
        for _ in range(count - 2):
            acc = self.add(acc, p)
            entries.append(acc)
        return entries[:count]

    def _coord_rank(self) -> int:
        """Number of trailing field axes in a coordinate (1 Fq, 2 Fq2)."""
        return self.f.one().dim()

    def _table_lookup(self, table: Point, digit: Tensor) -> Point:
        """Per-lane row of a stacked (k, *batch, *coord) table."""
        idx = digit[None].reshape((1,) + digit.shape
                                  + (1,) * self._coord_rank())
        idx = idx.expand((1,) + table.x.shape[1:]).long()
        return Point(table.x.gather(0, idx)[0], table.y.gather(0, idx)[0],
                     table.z.gather(0, idx)[0])

    def scalar_mul_bits(self, p: Point, bits: Tensor, window: int = 4
                        ) -> Point:
        """p_i · k_i with per-element scalars given as an MSB-first bit
        tensor of shape batch_shape + (nbits,): a per-lane [0..2^w)·p
        table, then nbits/w steps of w doublings + one table add."""
        nbits = bits.shape[-1]
        acc = self.infinity_like(p.x)
        if window <= 1 or nbits % window != 0:
            for i in range(nbits):
                acc = self.dbl(acc)
                acc = self.select(bits[..., i].bool(), self.add(acc, p), acc)
            return acc
        table = _stack(self._build_table(p, 1 << window))
        weights = torch.tensor([1 << (window - 1 - i) for i in range(window)],
                               dtype=torch.int32, device=bits.device)
        digits = (bits.reshape(bits.shape[:-1] + (nbits // window, window))
                  * weights).sum(-1)  # (...batch, nbits/w)
        for j in range(nbits // window):
            for _ in range(window):
                acc = self.dbl(acc)
            acc = self.add(acc, self._table_lookup(table, digits[..., j]))
        return acc

    def msm_bits(self, p: Point, bits: Tensor) -> Point:
        """Σᵢ kᵢ·pᵢ over the leading batch axis with per-lane scalars as an
        MSB-first bit tensor (B, nbits): the windowed ladder + one tree
        reduction, returned as a leading-axis-1 point."""
        return self.tree_sum(self.scalar_mul_bits(p, bits))

    def msm_table_build(self, p: Point, windows: int = 16,
                        digits: int = 16) -> Point:
        """(R, ...) base points → (R, windows, digits, ...) multiples
        T[r, j, d] = d · (2^w)^j · P_r, j = 0 the MOST significant window
        (the MSB-first bit order of unpack_weight_bits) and the d = 0 row
        the identity, so that msm_from_tables lanes whose scalar was
        masked to 0 gather identities.  The same op sequence as the JAX
        scans: w doublings a window from P up, then per digit one add of
        every window's point to the previous digit's row, starting from
        the identity.  Each digit step is written straight into one
        preallocated table, in place, so the build's peak is one table
        and one digit step (about 240 KB a row at 16 × 16 over Fq2), not
        the stacked steps plus their transposed copy."""
        w = 1
        while (1 << w) < digits:
            w += 1
        rows = p.x.shape[0]
        coord = p.x.shape[1:]
        tab = Point(*(c.new_empty((rows, windows, digits) + coord)
                      for c in p))
        per_win = Point(*(c.new_empty((rows, windows) + coord) for c in p))
        pt = p
        for j in range(windows):  # (2^w)^j·P lands in window windows−1−j
            if j:
                for _ in range(w):
                    pt = self.dbl(pt)
            for dst, c in zip(per_win, pt):
                dst[:, windows - 1 - j] = c
        acc = self.infinity_like(per_win.x)
        for d in range(digits):
            for dst, c in zip(tab, acc):
                dst[:, :, d] = c
            if d + 1 < digits:
                acc = self.add(acc, per_win)
        return tab

    def msm_from_tables(self, tab: Point, rows: Tensor,
                        bits: Tensor) -> Point:
        """Σ_i k_i·P_{rows_i} from msm_table_build's tables: per lane one
        point a window, gathered by (row, window, digit), summed over the
        windows by a halving tree and over the leading lane axis by
        tree_sum.  `rows` has the lanes' shape S (B, or (B, k) for k
        sums at once, one per column), `bits` S + (nbits,), the MSB-first
        scalar bits of msm_bits; masked lanes (all-zero scalars) gather
        identities only.  The gather puts the window axis first, so each
        tree level adds two contiguous halves."""
        windows, digits_n = tab.x.shape[1], tab.x.shape[2]
        w = 1
        while (1 << w) < digits_n:
            w += 1
        weights = torch.tensor([1 << (w - 1 - i) for i in range(w)],
                               dtype=torch.int32, device=bits.device)
        digits = (bits.reshape(rows.shape + (windows, w))
                  * weights).sum(-1)                      # S + (windows,)
        d = digits.movedim(-1, 0).long()                  # (windows,) + S
        r = rows[None].long()
        j = torch.arange(windows, device=rows.device).reshape(
            (windows,) + (1,) * rows.dim())
        p = Point(tab.x[r, j, d], tab.y[r, j, d], tab.z[r, j, d])
        width = windows
        while width > 1:
            half = width // 2
            p = self.add(Point(p.x[:half], p.y[:half], p.z[:half]),
                         Point(p.x[half:], p.y[half:], p.z[half:]))
            width = half
        return self.tree_sum(Point(p.x[0], p.y[0], p.z[0]))

    # -- reductions ----------------------------------------------------------

    def tree_sum(self, p: Point) -> Point:
        """Σᵢ pᵢ over the leading batch axis in log₂(B) batched adds."""
        batch = p.x.shape[0]
        size = 1
        while size < batch:
            size *= 2
        if size != batch:
            inf = self.infinity_like(p.x.new_zeros(
                (size - batch,) + p.x.shape[1:]))
            p = Point(torch.cat([p.x, inf.x]), torch.cat([p.y, inf.y]),
                      torch.cat([p.z, inf.z]))
        while size > 1:
            half = size // 2
            p = self.add(Point(p.x[:half], p.y[:half], p.z[:half]),
                         Point(p.x[half:], p.y[half:], p.z[half:]))
            size = half
        return p

    # -- conversions ---------------------------------------------------------

    def to_affine(self, p: Point):
        """(x, y, is_infinity) with x = X/Z, y = Y/Z (zeros at infinity,
        since field.inv(0) = 0)."""
        zinv = self.f.inv(p.z)
        ax, ay = self.f.mul(torch.stack(torch.broadcast_tensors(p.x, p.y)),
                            zinv)
        return ax, ay, self.is_infinity(p)
