"""Batched Fq6 = Fq2[v]/(v³ − ξ) arithmetic, ξ = 1 + u — the middle rung
of the BLS12-381 extension tower.

The counterpart of consensus_overlord_tpu/ops/fq6.py.  Elements are
(..., 3, 2, n) int32 limb tensors — Fq6 component axis, then the Fq2
layout of ops/fq2.py — and every op is the same sequence of base-field
ops as the JAX package's, per element, so loose outputs are
bit-identical.  The independent Fq2 ops of one formula run as one call
on a stacked tensor (one base-field call over more rows); that changes
no element's arithmetic.
"""

from __future__ import annotations

import numpy as np
import torch

from .field import Tensor
from .fq2 import Fq2Ops

_st = torch.stack


class Fq6Ops:
    """Cubic extension ops over Fq2 with v³ = ξ = 1 + u (the BLS12-381
    sextic-twist non-residue)."""

    def __init__(self, fq2: Fq2Ops):
        self.fq2 = fq2
        self.fq = fq2.fq

    # components -------------------------------------------------------------

    @staticmethod
    def c(x: Tensor, i: int) -> Tensor:
        return x[..., i, :, :]

    @staticmethod
    def build(c0: Tensor, c1: Tensor, c2: Tensor) -> Tensor:
        return torch.stack(torch.broadcast_tensors(c0, c1, c2), dim=-3)

    def one(self, device="cpu") -> Tensor:
        z = self.fq2.zero(device)
        return self.build(self.fq2.one(device), z, z)

    def zero(self, device="cpu") -> Tensor:
        z = self.fq2.zero(device)
        return self.build(z, z, z)

    def from_int_triples(self, triples) -> np.ndarray:
        """[((a0,a1), (b0,b1), (c0,c1)), ...] → (len, 3, 2, n) int32."""
        return np.stack([self.fq2.from_ints(list(t)) for t in triples])

    def to_int_triples(self, x: Tensor):
        c0 = self.fq2.to_int_pairs(self.c(x, 0))
        c1 = self.fq2.to_int_pairs(self.c(x, 1))
        c2 = self.fq2.to_int_pairs(self.c(x, 2))
        return list(zip(c0, c1, c2))

    # arithmetic -------------------------------------------------------------
    #
    # add/sub/neg act per Fq coefficient, as the JAX package's
    # component-wise forms do, so one base-field call covers all six.

    def add(self, x: Tensor, y: Tensor) -> Tensor:
        return self.fq.add(x, y)

    def sub(self, x: Tensor, y: Tensor) -> Tensor:
        return self.fq.sub(x, y)

    def neg(self, x: Tensor) -> Tensor:
        return self.fq.neg(x)

    def mul_xi(self, x: Tensor) -> Tensor:
        """Component-wise multiply by ξ = 1 + u (fq2.mul_small_xi k=1)."""
        return self.fq2.mul_small_xi(x, 1)

    def mul(self, x: Tensor, y: Tensor) -> Tensor:
        # Toom-style interpolation, the host fq6_mul schedule: 6 Fq2 muls,
        # here one stacked Fq2 multiply.
        f = self.fq2
        x, y = torch.broadcast_tensors(x, y)
        a0, a1, a2 = self.c(x, 0), self.c(x, 1), self.c(x, 2)
        b0, b1, b2 = self.c(y, 0), self.c(y, 1), self.c(y, 2)
        s = f.add(_st([a1, a0, a0, b1, b0, b0]), _st([a2, a1, a2, b2, b1, b2]))
        t0, t1, t2, m12, m01, m02 = f.mul(_st([a0, a1, a2, s[0], s[1], s[2]]),
                                          _st([b0, b1, b2, s[3], s[4], s[5]]))
        # (m12 − t1) − t2, (m01 − t0) − t1, (m02 − t0) − t2
        u = f.sub(f.sub(_st([m12, m01, m02]), _st([t1, t0, t0])),
                  _st([t2, t1, t2]))
        xi = f.mul_small_xi(_st([u[0], t2]), 1)
        return self.build(*f.add(_st([t0, u[1], u[2]]), _st([xi[0], xi[1], t1])))

    def sq(self, x: Tensor) -> Tensor:
        return self.mul(x, x)

    def mul_v(self, x: Tensor) -> Tensor:
        """Multiply by v: (c0, c1, c2) → (ξ·c2, c0, c1)."""
        return self.build(self.fq2.mul_small_xi(self.c(x, 2), 1),
                          self.c(x, 0), self.c(x, 1))

    def mul_by_01(self, x: Tensor, b0: Tensor, b1: Tensor) -> Tensor:
        """x · (b0 + b1·v) — the sparse multiply of the pairing's line
        evaluations (5 Fq2 muls instead of 6)."""
        f = self.fq2
        a0, a1, a2 = self.c(x, 0), self.c(x, 1), self.c(x, 2)
        a0, a1, a2, b0, b1 = torch.broadcast_tensors(a0, a1, a2, b0, b1)
        s = f.add(_st([a0, b0]), _st([a1, b1]))
        t0, t1, m, p21, p20 = f.mul(_st([a0, a1, s[0], a2, a2]),
                                    _st([b0, b1, s[1], b1, b0]))
        t2 = f.sub(f.sub(m, t0), t1)
        c0, c2 = f.add(_st([t0, t1]), _st([f.mul_small_xi(p21, 1), p20]))
        return self.build(c0, t2, c2)

    def mul_by_1(self, x: Tensor, b1: Tensor) -> Tensor:
        """x · (b1·v) — 3 Fq2 muls."""
        f = self.fq2
        a0, a1, a2, b1 = torch.broadcast_tensors(
            self.c(x, 0), self.c(x, 1), self.c(x, 2), b1)
        m = f.mul(_st([a2, a0, a1]), _st([b1, b1, b1]))
        return self.build(f.mul_small_xi(m[0], 1), m[1], m[2])

    def inv(self, x: Tensor) -> Tensor:
        # Host fq6_inv: c-matrix adjugate over the norm; inv(0) = 0
        # (fq2.inv(0) = 0 keeps the math total).
        f = self.fq2
        a0, a1, a2 = self.c(x, 0), self.c(x, 1), self.c(x, 2)
        sq0, sq2, sq1 = f.sq(_st([a0, a2, a1]))
        m12, m01, m02 = f.mul(_st([a1, a0, a0]), _st([a2, a1, a2]))
        xi12, xisq2 = f.mul_small_xi(_st([m12, sq2]), 1)
        c = f.sub(_st([sq0, xisq2, sq1]), _st([xi12, m01, m02]))
        p0, p21, p12 = f.mul(_st([a0, a2, a1]), c)
        t = f.add(p0, f.mul_small_xi(f.add(p21, p12), 1))
        return self.build(*f.mul(c, f.inv(t)))

    # predicates / selection -------------------------------------------------

    def is_zero(self, x: Tensor) -> Tensor:
        return self.fq.is_zero(x).all(-1).all(-1)

    def eq(self, x: Tensor, y: Tensor) -> Tensor:
        return self.fq.eq(x, y).all(-1).all(-1)

    def where(self, mask: Tensor, x: Tensor, y: Tensor) -> Tensor:
        return torch.where(mask[..., None, None, None], x, y)
