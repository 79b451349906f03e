"""Batched short-Weierstrass curves beyond BLS12-381: secp256k1 and SM2.

The counterpart of consensus_overlord_tpu/ops/weierstrass.py, over the
port's 26-limb fields (field.SECP256K1_FQ, field.SM2_FQ), issuing the
JAX package's field-op sequences so every output is bit-identical:

* **secp256k1**, y² = x³ + 7 (a = 0): CurveOps' a = 0 complete addition
  and doubling with 3b = 21.  On CUDA tensors ``SECP.add``/``SECP.dbl``
  launch csrc/g1_point.cu built for this field (kernels.g1_add/g1_dbl),
  on CPU tensors their plain versions.
* **SM2**, y² = x³ − 3x + b (a = −3): ``GeneralCurveOps``, the general-a
  complete addition (Renes–Costello–Batina 2016, Algorithm 1), with
  doubling = add(p, p).  ``SM2.add`` launches csrc/wp_point.cu on CUDA
  tensors (kernels.wp_add_general), its plain version on CPU tensors.

``dual_scalar_mul_bits`` is Shamir's u1·G + u2·Q for the ECDSA and SM2
verification equations: one shared doubling run and two windowed table
adds per window.  The fixed base's table is built at batch 1 and read
by index; each lane keeps its own table for Q, read by a gather (the
same values as the JAX package's one-hot contraction).  For secp256k1
every step is a launch (``dual_scalar_mul_steps``); for SM2 the ladder
after the table builds is ``dual_ladder``: one launch of csrc/
wp_point.cu's wp_dual_ladder_kernel on CUDA tensors, on CPU tensors
``dual_ladder_plain``, the same loop over ``SM2.add_plain`` fed from the
packed digits (``pack_digits``).
"""

from __future__ import annotations

from typing import Callable

import torch

from . import kernels
from .curve import CurveOps, Point, _stack, int32_words
from .field import SECP256K1_FQ, SM2_FQ, PlainField, Tensor

# -- fields and curve constants ------------------------------------------------

FQ_SECP = SECP256K1_FQ
FQ_SM2 = SM2_FQ

#: secp256k1 group order (prime, cofactor 1)
SECP256K1_N = int("fffffffffffffffffffffffffffffffe"
                  "baaedce6af48a03bbfd25e8cd0364141", 16)
#: secp256k1 base point (SEC 2 v2 §2.4.1)
SECP256K1_GX = int("79be667ef9dcbbac55a06295ce870b07"
                   "029bfcdb2dce28d959f2815b16f81798", 16)
SECP256K1_GY = int("483ada7726a3c4655da4fbfc0e1108a8"
                   "fd17b448a68554199c47d08ffb10d4b8", 16)
SECP256K1_P = SECP256K1_FQ.p
SECP256K1_B = 7

#: SM2 recommended curve (GB/T 32918.5): a = p − 3
SM2_P = SM2_FQ.p
SM2_A = SM2_P - 3
SM2_B = int("28e9fa9e9d9f5e344d5a9e4bcf6509a7"
            "f39789f515ab8f92ddbcbd414d940e93", 16)
SM2_N = int("fffffffeffffffffffffffffffffffff"
            "7203df6b21c6052b53bbf40939d54123", 16)
SM2_GX = int("32c4ae2c1f1981195f9904466a39c994"
             "8fe30bbff2660be1715a4589334c74c7", 16)
SM2_GY = int("bc3736a2f4f6779c59bdcee36b692153"
             "d0a9877cc62a474002df32e52139f0a0", 16)
SM2_B3 = 3 * SM2_B % SM2_P


class GeneralCurveOps(CurveOps):
    """Complete projective addition for an arbitrary a (RCB 2016 Alg. 1).

    mul_a: multiply a field element by the curve's a (a callable, so a
    small negative a takes the mul_small/neg path instead of a product)."""

    def __init__(self, field, mul_a: Callable[[Tensor], Tensor],
                 mul_b3: Callable[[Tensor], Tensor], name: str):
        super().__init__(field, mul_b3, name)
        self.mul_a = mul_a

    def add(self, p: Point, q: Point) -> Point:
        f, mul_a, mul_b3 = self.f, self.mul_a, self.mul_b3
        x1, y1, z1, x2, y2, z2 = torch.broadcast_tensors(*p, *q)
        t0 = f.mul(x1, x2)
        t1 = f.mul(y1, y2)
        t2 = f.mul(z1, z2)
        t3 = f.sub(f.mul(f.add(x1, y1), f.add(x2, y2)),
                   f.add(t0, t1))                      # x1y2 + x2y1
        t4 = f.sub(f.mul(f.add(x1, z1), f.add(x2, z2)),
                   f.add(t0, t2))                      # x1z2 + x2z1
        t5 = f.sub(f.mul(f.add(y1, z1), f.add(y2, z2)),
                   f.add(t1, t2))                      # y1z2 + y2z1
        z3 = f.add(mul_b3(t2), mul_a(t4))
        x3 = f.sub(t1, z3)
        z3 = f.add(t1, z3)
        y3 = f.mul(x3, z3)
        t1 = f.add(f.mul_small(t0, 3), mul_a(t2))      # 3x1x2 + a·z1z2
        t2 = mul_a(f.sub(t0, mul_a(t2)))               # a·(x1x2 − a·z1z2)
        t4 = f.add(mul_b3(t4), t2)
        y3 = f.add(y3, f.mul(t1, t4))
        x3 = f.sub(f.mul(t3, x3), f.mul(t5, t4))
        z3 = f.add(f.mul(t5, z3), f.mul(t3, t1))
        return Point(x3, y3, z3)

    def dbl(self, p: Point) -> Point:
        """The dedicated doubling is a = 0 only: the complete addition of
        p with itself."""
        return self.add(p, p)

    def on_curve(self, p: Point) -> Tensor:
        """3·Y²Z == 3·X³ + 3a·XZ² + 3b·Z³ (the identity passes)."""
        f = self.f
        z2 = f.sq(p.z)
        lhs = f.mul_small(f.mul(f.sq(p.y), p.z), 3)
        rhs = f.add(f.mul_small(f.mul(f.sq(p.x), p.x), 3),
                    f.add(f.mul_small(self.mul_a(f.mul(p.x, z2)), 3),
                          self.mul_b3(f.mul(z2, p.z))))
        return f.eq(lhs, rhs)


def _lanes(n: int, *coords: Tensor):
    coords = torch.broadcast_tensors(*coords)
    return coords[0].shape, tuple(c.reshape(-1, n).contiguous()
                                  for c in coords)


def _secp_b3(x: Tensor) -> Tensor:
    return FQ_SECP.mul_small(x, 3 * SECP256K1_B)


class SecpOps(CurveOps):
    """secp256k1 with g1_point.cu (built for this field, 3b = 21) as its
    add and doubling on CUDA tensors, and the generic a = 0 formulas over
    the plain field as their plain versions."""

    def __init__(self):
        super().__init__(FQ_SECP, _secp_b3, "secp256k1")
        self._plain = CurveOps(PlainField(FQ_SECP), _secp_b3,
                               "secp256k1_plain")

    def add(self, p: Point, q: Point) -> Point:
        if p.x.device.type == "cpu":
            return self.add_plain(p, q)
        shape, lanes = _lanes(FQ_SECP.n, *p, *q)
        out = kernels.g1_add(FQ_SECP, lanes[:3], lanes[3:])
        return Point(*(c.reshape(shape) for c in out))

    def dbl(self, p: Point) -> Point:
        if p.x.device.type == "cpu":
            return self.dbl_plain(p)
        shape, lanes = _lanes(FQ_SECP.n, *p)
        out = kernels.g1_dbl(FQ_SECP, lanes)
        return Point(*(c.reshape(shape) for c in out))

    def add_plain(self, p: Point, q: Point) -> Point:
        return self._plain.add(p, q)

    def dbl_plain(self, p: Point) -> Point:
        return self._plain.dbl(p)


def _sm2_mul_a(x: Tensor) -> Tensor:
    return FQ_SM2.neg(FQ_SM2.mul_small(x, 3))


class Sm2Ops(GeneralCurveOps):
    """SM2 with wp_point.cu as its add (and so its doubling) on CUDA
    tensors, and the general-a formula over the plain field as its plain
    version."""

    def __init__(self):
        super().__init__(
            FQ_SM2, _sm2_mul_a,
            lambda x: FQ_SM2.mul(x, FQ_SM2.constant(SM2_B3, x.device)),
            "sm2")
        plain = PlainField(FQ_SM2)
        self._plain = GeneralCurveOps(
            plain, _sm2_mul_a,
            lambda x: plain.mul(x, FQ_SM2.constant(SM2_B3, x.device)),
            "sm2_plain")

    def add(self, p: Point, q: Point) -> Point:
        if p.x.device.type == "cpu":
            return self.add_plain(p, q)
        shape, lanes = _lanes(FQ_SM2.n, *p, *q)
        b3 = FQ_SM2.constant(SM2_B3, p.x.device)[None]
        out = kernels.wp_add_general(FQ_SM2, lanes[:3], lanes[3:], b3)
        return Point(*(c.reshape(shape) for c in out))

    def add_plain(self, p: Point, q: Point) -> Point:
        return self._plain.add(p, q)


SECP = SecpOps()
SM2 = Sm2Ops()


def _window_digits(bits: Tensor, window: int) -> Tensor:
    """(B, nbits) MSB-first bits → (nbits / window, B) int64 digits."""
    nbits = bits.shape[-1]
    weights = torch.tensor([1 << (window - 1 - i) for i in range(window)],
                           dtype=torch.int32, device=bits.device)
    d = (bits.reshape(bits.shape[:-1] + (nbits // window, window))
         * weights).sum(-1)
    return torch.movedim(d, -1, 0).long()


def _tables(ops: CurveOps, g: Point, q: Point, window: int):
    """G's table at batch 1, (2^w, 1, n), read by index, and the lanes'
    Q tables, (2^w, B, n), read by a gather: 2 · (2^w − 2) adds."""
    return (_stack(ops._build_table(g, 1 << window)),
            _stack(ops._build_table(q, 1 << window)))


def _check_bits(g_bits: Tensor, q_bits: Tensor, window: int) -> int:
    nbits = g_bits.shape[-1]
    if nbits != q_bits.shape[-1] or nbits % window:
        raise ValueError("bit lengths must agree and divide by the window")
    return nbits


def _dual_steps(ops: CurveOps, tg: Point, tq: Point, dgs: Tensor,
                dqs: Tensor, window: int, add, dbl) -> Point:
    """The JAX scan's loop: per window `window` doublings, then the add of
    G's row, then the add of the lane's Q row."""
    acc = ops.infinity_like(tq.x[0])
    for dg, dq in zip(dgs, dqs):
        for _ in range(window):
            acc = dbl(acc)
        acc = add(acc, Point(tg.x[dg, 0], tg.y[dg, 0], tg.z[dg, 0]))
        acc = add(acc, ops._table_lookup(tq, dq))
    return acc


def dual_scalar_mul_steps(ops: CurveOps, g: Point, g_bits: Tensor,
                          q: Point, q_bits: Tensor,
                          window: int = 4) -> Point:
    """Per-lane u1·G + u2·Q with one shared doubling run (Shamir's trick):
    each window does `window` doublings and two table adds, each a
    launch of ops.dbl / ops.add on CUDA tensors.

    `g` is one base point of batch shape (1, n), its table read by index;
    q holds the (B, n) lanes; both bit tensors are (B, nbits) MSB-first,
    nbits divisible by `window`."""
    _check_bits(g_bits, q_bits, window)
    tg, tq = _tables(ops, g, q, window)
    return _dual_steps(ops, tg, tq, _window_digits(g_bits, window),
                       _window_digits(q_bits, window), window, ops.add,
                       ops.dbl)


def pack_digits(dgs: Tensor, dqs: Tensor) -> Tensor:
    """(windows, B) digits of G and Q, each in [0, 16) → (B, ceil(windows
    / 4)) int32: window j's byte dg << 4 | dq at bits 8·(j % 4) of word
    j // 4, the ladder kernel's layout (64 bytes a lane at 64 windows)."""
    windows, b = dgs.shape
    words = kernels.packed_words(windows, 4)
    wide = torch.zeros((b, words * 4), dtype=torch.int64, device=dgs.device)
    wide[:, :windows] = (dgs.long() << 4 | dqs.long()).T
    shifts = torch.arange(0, 32, 8, device=dgs.device)
    return int32_words((wide.view(b, words, 4) << shifts).sum(-1))


def unpack_digits(packed: Tensor, windows: int):
    """pack_digits' inverse: the (windows, B) int64 digits of G and Q."""
    shifts = torch.arange(0, 32, 8, device=packed.device)
    by = (packed.long()[..., None] >> shifts) & 0xff
    by = by.reshape(packed.shape[0], -1)[:, :windows].T
    return by >> 4, by & 15


def dual_ladder_plain(tg: Point, tq: Point, packed: Tensor,
                      windows: int) -> Point:
    """The plain version of the wp_dual_ladder kernel: the JAX scan's loop
    over SM2.add_plain, on any device, launching no kernel."""
    dgs, dqs = unpack_digits(packed, windows)
    return _dual_steps(SM2, tg, tq, dgs, dqs, kernels.LADDER_WINDOW,
                       SM2.add_plain, lambda p: SM2.add_plain(p, p))


def dual_ladder(tg: Point, tq: Point, packed: Tensor,
                windows: int) -> Point:
    """SM2's u1·G + u2·Q from the window-4 tables and pack_digits' words:
    the wp_dual_ladder kernel on CUDA tensors (one launch),
    dual_ladder_plain on CPU tensors; the two are bit-identical."""
    dev = tq.x.device
    if dev.type == "cpu":
        return dual_ladder_plain(tg, tq, packed, windows)
    return Point(*kernels.wp_dual_ladder(
        FQ_SM2, tuple(c.contiguous() for c in tq),
        tuple(c[:, 0].contiguous() for c in tg), packed.contiguous(),
        windows, FQ_SM2.constant(SM2_B3, dev)[None],
        FQ_SM2.one(dev)[None].contiguous()))


def dual_scalar_mul_bits(ops: CurveOps, g: Point, g_bits: Tensor,
                         q: Point, q_bits: Tensor) -> Point:
    """dual_scalar_mul_steps' u1·G + u2·Q at window 4 (the JAX package's
    default): secp256k1 runs the steps; SM2's ladder after the table
    builds is dual_ladder, one launch on CUDA tensors."""
    window = kernels.LADDER_WINDOW
    if ops is not SM2:
        return dual_scalar_mul_steps(ops, g, g_bits, q, q_bits, window)
    nbits = _check_bits(g_bits, q_bits, window)
    tg, tq = _tables(ops, g, q, window)
    return dual_ladder(tg, tq, pack_digits(_window_digits(g_bits, window),
                                           _window_digits(q_bits, window)),
                       nbits // window)
