"""Batched Fq2 = Fq[u]/(u²+1) arithmetic for the BLS12-381 G2 group.

The counterpart of consensus_overlord_tpu/ops/fq2.py.  Elements are
(..., 2, n) int32 limb tensors — component axis then limb axis — and
every op is the same sequence of base-field ops as the JAX package's, so
loose outputs are bit-identical.  Base-field multiplies on CUDA tensors
go through the fq_mul kernel (ops/field.py).  Control flow is branchless
(selects), including the square root.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .field import FieldSpec, Tensor


class Fq2Ops:
    """Quadratic extension ops over a base FieldSpec with u² = −1
    (the BLS12-381 non-residue)."""

    def __init__(self, fq: FieldSpec):
        if fq.p % 4 != 3:
            raise ValueError("u²=−1 is a non-residue only for p ≡ 3 mod 4")
        self.fq = fq

    # components -------------------------------------------------------------

    @staticmethod
    def c0(x: Tensor) -> Tensor:
        return x[..., 0, :]

    @staticmethod
    def c1(x: Tensor) -> Tensor:
        return x[..., 1, :]

    @staticmethod
    def build(c0: Tensor, c1: Tensor) -> Tensor:
        c0, c1 = torch.broadcast_tensors(c0, c1)
        return torch.stack([c0, c1], dim=-2)

    def one(self, device="cpu") -> Tensor:
        return self.build(self.fq.one(device), self.fq.zero(device))

    def from_ints(self, pairs) -> np.ndarray:
        """(len, 2, n) int32 limbs of int pairs (c0, c1)."""
        return np.stack([np.stack([self.fq.from_int(a), self.fq.from_int(b)])
                         for a, b in pairs])

    def to_int_pairs(self, x: Tensor):
        c0s = self.fq.to_ints(self.c0(x))
        c1s = self.fq.to_ints(self.c1(x))
        return list(zip(c0s, c1s))

    # arithmetic -------------------------------------------------------------
    #
    # Base-field ops act per limb vector, so an Fq2 element's two
    # components — and independent products of one formula — go through
    # ONE base-field call on a stacked tensor: the same per-element
    # arithmetic as the JAX package in fewer, wider calls (and, on the
    # card, fq_mul launches over more lanes).

    def add(self, x: Tensor, y: Tensor) -> Tensor:
        return self.fq.add(x, y)

    def sub(self, x: Tensor, y: Tensor) -> Tensor:
        return self.fq.sub(x, y)

    def neg(self, x: Tensor) -> Tensor:
        return self.fq.neg(x)

    def mul(self, x: Tensor, y: Tensor) -> Tensor:
        # Karatsuba: (a0+a1u)(b0+b1u) = (a0b0 − a1b1) + ((a0+a1)(b0+b1) − a0b0 − a1b1)u
        fq = self.fq
        x, y = torch.broadcast_tensors(x, y)
        a0, a1, b0, b1 = self.c0(x), self.c1(x), self.c0(y), self.c1(y)
        s = fq.add(torch.stack([a0, b0]), torch.stack([a1, b1]))
        t0, t1, t2 = fq.mul(torch.stack([a0, a1, s[0]]),
                            torch.stack([b0, b1, s[1]]))
        return fq.sub(self.build(t0, t2), self.build(t1, fq.add(t0, t1)))

    def sq(self, x: Tensor) -> Tensor:
        # (a0² − a1²) + 2·a0·a1·u
        fq = self.fq
        a0, a1 = self.c0(x), self.c1(x)
        m = fq.mul(torch.stack([fq.add(a0, a1), a0]),
                   torch.stack([fq.sub(a0, a1), a1]))
        return self.build(m[0], fq.mul_small(m[1], 2))

    def mul_small(self, x: Tensor, k: int) -> Tensor:
        return self.fq.mul_small(x, k)

    def mul_small_xi(self, x: Tensor, k: int) -> Tensor:
        """x · k·(1+u): the G2 curve constant b = 4(1+u) and its triple
        b3 = 12(1+u)."""
        fq = self.fq
        a0, a1 = self.c0(x), self.c1(x)
        return fq.mul_small(self.build(fq.sub(a0, a1), fq.add(a0, a1)), k)

    def conj(self, x: Tensor) -> Tensor:
        return self.build(self.c0(x), self.fq.neg(self.c1(x)))

    def inv(self, x: Tensor) -> Tensor:
        # 1/(a0+a1u) = (a0 − a1u)/(a0² + a1²);  inv(0) = 0.
        fq = self.fq
        sq = fq.mul(x, x)  # a0², a1²
        norm_inv = fq.inv(fq.add(self.c0(sq), self.c1(sq)))
        m = fq.mul(x, norm_inv[..., None, :])
        return self.build(self.c0(m), fq.neg(self.c1(m)))

    # predicates / selection -------------------------------------------------

    def is_zero(self, x: Tensor) -> Tensor:
        return self.fq.is_zero(x).all(-1)

    def eq(self, x: Tensor, y: Tensor) -> Tensor:
        return self.fq.eq(x, y).all(-1)

    def where(self, mask: Tensor, x: Tensor, y: Tensor) -> Tensor:
        return torch.where(mask[..., None, None], x, y)

    def is_lex_largest(self, x: Tensor) -> Tensor:
        """ZCash serialization sign rule for Fq2 y-coordinates: compare c1
        first, tie-break on c0 (host analog crypto/bls12381.py
        _y_is_lexicographically_largest_fq2)."""
        fq = self.fq
        half = (fq.p - 1) // 2 + 1  # y > (p−1)/2  ⇔  y ≥ (p+1)/2
        c1_nonzero = ~fq.is_zero(self.c1(x))
        return torch.where(c1_nonzero,
                           fq.geq_const(self.c1(x), half),
                           fq.geq_const(self.c0(x), half))

    # square root (branchless) ----------------------------------------------

    def sqrt_checked(self, a: Tensor) -> Tuple[Tensor, Tensor]:
        """(root, ok): a square root of `a` when one exists, flagged by ok.
        Complex-sqrt method with every branch turned into a select (host
        analog crypto/bls12381.py fq2_sqrt).  The independent
        exponentiations run stacked: sqrt(x), sqrt(−x) and sqrt(x²+y²) as
        one chain, then the two sign branches' sqrt and inverse."""
        fq = self.fq
        x, y = self.c0(a), self.c1(a)
        inv2 = torch.as_tensor(fq.from_int(pow(2, -1, fq.p)),
                               device=a.device)
        neg_x = fq.neg(x)
        xy_sq = fq.mul(torch.stack([x, y]), torch.stack([x, y]))
        norm = fq.add(xy_sq[0], xy_sq[1])
        rx, rnx, s = fq.sqrt_candidate(torch.stack([x, neg_x, norm]))

        # Candidates for the y == 0 case: sqrt(x) or sqrt(−x)·u.
        rx_ok, rnx_ok = fq.eq(fq.mul(torch.stack([rx, rnx]),
                                     torch.stack([rx, rnx])),
                              torch.stack([x, neg_x]))
        cand_y0 = self.where(rx_ok,
                             self.build(rx, torch.zeros_like(rx)),
                             self.build(torch.zeros_like(rnx), rnx))
        ok_y0 = rx_ok | rnx_ok

        # General case: s = sqrt(x²+y²); t = sqrt((x ± s)/2); root = t + y/(2t)·u,
        # both signs of s at once.  fq.inv(0) = 0 keeps the math total.
        alpha = fq.mul(fq.add(x, torch.stack([s, fq.neg(s)])), inv2)
        t = fq.sqrt_candidate(alpha)
        cand = self.build(t, fq.mul(y, fq.inv(fq.mul_small(t, 2))))
        ok_a, ok_b = self.eq(self.sq(cand), a)
        general_cand = self.where(ok_a, cand[0], cand[1])
        general_ok = ok_a | ok_b

        y_zero = fq.is_zero(y)
        root = self.where(y_zero, cand_y0, general_cand)
        ok = torch.where(y_zero, ok_y0, general_ok)
        # Final sanity: ok implies root² == a (also covers norm non-residue).
        ok = ok & self.eq(self.sq(root), a)
        return root, ok
