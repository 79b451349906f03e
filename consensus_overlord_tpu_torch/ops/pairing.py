"""Device optimal-ate pairing: batched Miller loop + one shared final
exponentiation per multi-pairing call.

The counterpart of consensus_overlord_tpu/ops/pairing.py, with the same
formulation:

* The Miller loop runs ON THE TWIST E': y² = x³ + 4ξ with the G2
  accumulator in homogeneous projective Fq2 coordinates (no inversions),
  and the G1 point twisted up: P = (x_P, y_P) ↦ (x_P·w², y_P·w³).  A
  line through R = (X:Y:Z), with Fq2 denominators cleared (they die in
  the final exponentiation), is sparse in the (1, v, vw) slots:

    doubling:  (3X³ − 2Y²Z)  +  (−3X²Z·x_P)·v  +  (2YZ²·y_P)·vw
    addition:  (θ·x_Q − μ·y_Q) + (−θ·x_P)·v + (μ·y_P)·vw,
               θ = Y − y_Q·Z,  μ = X − x_Q·Z        (Q affine)

  and point updates reuse the complete formulas of ops/curve.py.  The
  JAX package scans the |x| bits computing both arms and selecting one;
  here the schedule is a Python loop over the static bits that computes
  only the arm that is taken — the same values, and the addition arm on
  5 of the 63 steps only.
* ``multi_pairing_is_one``: per-pair Miller loops batched over the pair
  axis, masked pairs (infinity inputs, padding) forced to one, a tree
  product over pairs, ONE final exponentiation for the whole call.

Every function of the tower here is a plain PyTorch version over
``PlainField`` (it launches no kernel on any device): the CPU path and
the reference of the three hand-written kernels of csrc/pairing.cu.  The
staged entry points (``miller_product``, ``final_is_one``,
``multi_pairing_is_one_staged``, and the wrappers ``fq12_mul`` and
``final_exponentiation``) launch those kernels for CUDA tensors —
``miller_product_kernel``, ``fq12_mul_kernel`` for the pair tree,
``final_exp_kernel`` — and run the plain versions for CPU tensors.

Host oracle twin: crypto/bls12381.py multi_pairing_is_one.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..crypto import bls12381 as oracle
from . import kernels
from .curve import CurveOps, Point
from .field import BLS12_381_FQ, PlainField, Tensor
from .fq2 import Fq2Ops
from .fq6 import Fq6Ops
from .fq12 import Fq12Ops

_st = torch.stack

#: MSB-first bits of |x| after the leading 1 — the Miller loop schedule
#: (63 steps, 5 of them with the addition arm).
X_BITS = tuple(int(c) for c in bin(oracle.X_ABS)[3:])
_B3 = 12  # G2's 3·b' = 12·(1+u)


class Tower:
    """The pairing over one base-field object: the Fq2/Fq6/Fq12 tower,
    G2 on the twist, and the Miller loop and its pieces.  Over
    ``PlainField`` it is the plain PyTorch version (this module's
    ``PLAIN``); ops/tower_program.py runs it over a field that records
    the base-field ops, to make the kernels' programs."""

    def __init__(self, fq):
        self.fq = fq
        self.fq2 = fq2 = Fq2Ops(fq)
        self.fq6 = Fq6Ops(fq2)
        self.fq12 = Fq12Ops(self.fq6)
        self.g2 = CurveOps(fq2, lambda x: fq2.mul_small_xi(x, _B3),
                           "bls12381_g2")

    def fq2_scale_fq(self, a: Tensor, s: Tensor) -> Tensor:
        """Fq2 element × Fq scalar (component-wise Fq mul)."""
        return self.fq.mul(a, s[..., None, :])

    def sparse_line(self, f: Tensor, c0: Tensor, c1: Tensor, c4: Tensor,
                    xp: Tensor, yp: Tensor) -> Tensor:
        """f · line, line = c0 + (c1·x_P)·v + (c4·y_P)·vw."""
        s1, s4 = self.fq2_scale_fq(_st(torch.broadcast_tensors(c1, c4)),
                                   _st(torch.broadcast_tensors(xp, yp)))
        return self.fq12.mul_by_014(f, c0, s1, s4)

    def dbl_line(self, r: Point) -> Tuple[Tensor, Tensor, Tensor]:
        """Line coefficients (c0, c1, c4) of the tangent at R = (X:Y:Z):
        (3X³ − 2Y²Z, −3X²Z, 2YZ²)."""
        f = self.fq2
        x, y, z = torch.broadcast_tensors(*r)
        xx, yy, zz = f.sq(_st([x, y, z]))
        m = f.mul(_st([xx, yy, xx, y]), _st([x, z, z, zz]))
        t3 = f.mul_small(m[0::2], 3)  # 3X³, 3X²Z
        t2 = f.mul_small(m[1::2], 2)  # 2Y²Z, 2YZ²
        return f.sub(t3[0], t2[0]), f.neg(t3[1]), t2[1]

    def add_line(self, r: Point, qx: Tensor, qy: Tensor
                 ) -> Tuple[Tensor, Tensor, Tensor]:
        """Line coefficients (c0, c1, c4) through projective R and affine
        Q = (x_Q, y_Q): θ = Y − y_Q·Z, μ = X − x_Q·Z →
        (θ·x_Q − μ·y_Q, −θ, μ)."""
        f = self.fq2
        x, y, z, qx, qy = torch.broadcast_tensors(*r, qx, qy)
        theta, mu = f.sub(_st([y, x]), f.mul(_st([qy, qx]), _st([z, z])))
        m = f.mul(_st([theta, mu]), _st([qx, qy]))
        return f.sub(m[0], m[1]), f.neg(theta), mu

    def miller_loop(self, px: Tensor, py: Tensor, qx: Tensor,
                    qy: Tensor) -> Tensor:
        """f_{|x|,Q}(P) up to subfield factors, conjugated for the
        negative BLS parameter — batched over every leading dim.  px/py:
        (..., n) G1 affine limbs; qx/qy: (..., 2, n) G2' affine limbs.
        Returns an Fq12 element (..., 2, 3, 2, n).  Infinity handling is
        the caller's (mask the output to one)."""
        g2, fq12 = self.g2, self.fq12
        q = g2.from_affine(qx, qy)
        f = fq12.one(px.device).expand(px.shape[:-1] + (2, 3, 2, px.shape[-1]))
        r = q
        for bit in X_BITS:
            c0, c1, c4 = self.dbl_line(r)
            f = self.sparse_line(fq12.sq(f), c0, c1, c4, px, py)
            r = g2.dbl(r)
            if bit:
                a0, a1, a4 = self.add_line(r, qx, qy)
                f = self.sparse_line(f, a0, a1, a4, px, py)
                r = g2.add(r, q)
        # x < 0: conjugate (after the final exponentiation, an inversion).
        return fq12.conj(f)

    def fq12_tree_product(self, f: Tensor, mul=None) -> Tensor:
        """Π over the LEADING axis of an Fq12 stack: one-padded up to a
        power of two, then a log₂ tree of Fq12 muls (`mul`, the plain
        multiply by default)."""
        mul = mul or self.fq12.mul
        size = f.shape[0]
        target = 1
        while target < size:
            target *= 2
        if target != size:
            pad = self.fq12.one(f.device).expand(
                (target - size,) + f.shape[1:])
            f = torch.cat([f, pad], 0)
        while target > 1:
            half = target // 2
            f = mul(f[:half].contiguous(), f[half:].contiguous())
            target = half
        return f[0]

    def multi_pairing_product(self, px, py, skip, qx, qy) -> Tensor:
        """Π_i f_{|x|,Q_i}(P_i) over the LEADING pair axis, skipped lanes
        (infinity / padding) contributing one."""
        f = self.miller_loop(px, py, qx, qy)
        f = self.fq12.where(skip, self.fq12.one_like(f), f)
        return self.fq12_tree_product(f)

    def multi_pairing_is_one(self, px, py, p_inf, qx, qy, q_inf,
                             mask) -> Tensor:
        """Π e(P_i, Q_i) == 1 over the leading pair axis with ONE shared
        final exponentiation; p_inf/q_inf mark infinity inputs (skipped,
        like the host's None pairs), mask=False marks padding."""
        skip = p_inf | q_inf | ~mask
        f = self.multi_pairing_product(px, py, skip, qx, qy)
        return self.fq12.is_one(self.fq12.final_exponentiation(f))

    def pairing(self, px, py, qx, qy) -> Tensor:
        """e(P, Q)³ — the single-pair form (the host's shared cube)."""
        return self.fq12.final_exponentiation(
            self.miller_loop(px, py, qx, qy))


PLAIN = Tower(PlainField(BLS12_381_FQ))
FQ, FQ2, FQ6, FQ12, G2 = PLAIN.fq, PLAIN.fq2, PLAIN.fq6, PLAIN.fq12, PLAIN.g2

# The plain versions under the JAX package's names.
_fq2_scale_fq = PLAIN.fq2_scale_fq
_sparse_line = PLAIN.sparse_line
_dbl_line = PLAIN.dbl_line
_add_line = PLAIN.add_line
miller_loop = PLAIN.miller_loop
fq12_tree_product = PLAIN.fq12_tree_product
multi_pairing_product = PLAIN.multi_pairing_product
multi_pairing_is_one = PLAIN.multi_pairing_is_one
pairing = PLAIN.pairing


# -- the kernels' wrappers and the staged entry points ------------------------

def _on_cpu(t: Tensor) -> bool:
    return t.device.type == "cpu"


def fq12_mul(x: Tensor, y: Tensor) -> Tensor:
    """Batched Fq12 product: fq12_mul_kernel for CUDA tensors, FQ12.mul
    for CPU tensors (bit-identical)."""
    if _on_cpu(x):
        return FQ12.mul(x, y)
    return kernels.fq12_mul(BLS12_381_FQ, x, y)


def final_exponentiation(f: Tensor) -> Tensor:
    """f^(3(p¹²−1)/r) over a (B, 2, 3, 2, n) batch: final_exp_kernel for
    CUDA tensors, FQ12.final_exponentiation for CPU tensors."""
    if _on_cpu(f):
        return FQ12.final_exponentiation(f)
    return kernels.final_exp(BLS12_381_FQ, f)


def miller_product(px, py, p_inf, qx, qy, q_inf, mask) -> Tensor:
    """The staged pair's first stage (the JAX package's
    _miller_product_fn): per-pair Miller loops with skipped pairs forced
    to one, then the tree product.  CUDA tensors: one
    miller_product_kernel launch and ⌈log₂ P⌉ of fq12_mul_kernel."""
    skip = p_inf | q_inf | ~mask
    if _on_cpu(px):
        return multi_pairing_product(px, py, skip, qx, qy)
    f = kernels.miller_product(BLS12_381_FQ, px, py, qx, qy, skip)
    return fq12_tree_product(f, fq12_mul)


def final_is_one(f: Tensor) -> Tensor:
    """The staged pair's second stage: the final exponentiation of one
    Fq12 element and the == 1 verdict (a PyTorch compare)."""
    return FQ12.is_one(final_exponentiation(f[None])[0])


def multi_pairing_is_one_staged(px, py, p_inf, qx, qy, q_inf, mask):
    """multi_pairing_is_one as the two staged dispatches above — the form
    crypto/cuda_provider.py uses."""
    return final_is_one(miller_product(px, py, p_inf, qx, qy, q_inf, mask))


# -- host-format helpers (test/bench boundary, not hot-path) ----------------

def g1_affine_from_oracle(pts):
    """[(x, y) | None, ...] → (len, n) px, py, (len,) inf numpy arrays."""
    n = len(pts)
    px = np.zeros((n, FQ.n), np.int32)
    py = np.zeros((n, FQ.n), np.int32)
    inf = np.zeros(n, bool)
    for i, p in enumerate(pts):
        if p is None:
            inf[i] = True
            continue
        px[i] = FQ.from_int(p[0])
        py[i] = FQ.from_int(p[1])
    return px, py, inf


def g2_affine_from_oracle(pts):
    """[((x0,x1), (y0,y1)) | None, ...] → (len,2,n) qx, qy, (len,) inf."""
    n = len(pts)
    qx = np.zeros((n, 2, FQ.n), np.int32)
    qy = np.zeros((n, 2, FQ.n), np.int32)
    inf = np.zeros(n, bool)
    for i, p in enumerate(pts):
        if p is None:
            inf[i] = True
            continue
        qx[i] = FQ2.from_ints([p[0]])[0]
        qy[i] = FQ2.from_ints([p[1]])[0]
    return qx, qy, inf
