"""Batched Fq12 = Fq6[w]/(w² − v) arithmetic — the top of the BLS12-381
tower — with the cyclotomic squaring and the |x|-power chain the final
exponentiation needs.

The counterpart of consensus_overlord_tpu/ops/fq12.py.  Elements are
(..., 2, 3, 2, n) int32 limb tensors: Fq12 component axis (1, w), then
the Fq6 layout of ops/fq6.py.  Every op is the JAX package's sequence of
base-field ops, per element, so loose outputs are bit-identical; the
independent Fq6 products of one formula run as one stacked call.  Where
the JAX package scans the static bits of an exponent and selects
between both arms, this module runs a Python loop over the bits and
computes only the arm that is taken (the select returns the other arm
unchanged, so the values are the same).  The Frobenius constants
γ_k = ξ^(k·(p−1)/6) come from the port's host tower
(crypto/bls12381.py).

Tower recap: Fq2 = Fq[u]/(u²+1); Fq6 = Fq2[v]/(v³ − ξ), ξ = 1+u;
Fq12 = Fq6[w]/(w² − v), so w⁶ = ξ.
"""

from __future__ import annotations

import numpy as np
import torch

from ..crypto import bls12381 as oracle
from .field import Tensor
from .fq6 import Fq6Ops

_st = torch.stack


def _gamma_ints():
    if oracle._GAMMA is None:
        oracle.fq12_frobenius(oracle.FQ12_ONE)  # builds the table
    return oracle._GAMMA


class Fq12Ops:
    """Quadratic extension ops over Fq6 with w² = v."""

    def __init__(self, fq6: Fq6Ops):
        self.fq6 = fq6
        self.fq2 = fq6.fq2
        self.fq = fq6.fq

    # components -------------------------------------------------------------

    @staticmethod
    def c0(x: Tensor) -> Tensor:
        return x[..., 0, :, :, :]

    @staticmethod
    def c1(x: Tensor) -> Tensor:
        return x[..., 1, :, :, :]

    @staticmethod
    def build(c0: Tensor, c1: Tensor) -> Tensor:
        return torch.stack(torch.broadcast_tensors(c0, c1), dim=-4)

    def one(self, device="cpu") -> Tensor:
        return self.build(self.fq6.one(device), self.fq6.zero(device))

    def one_like(self, x: Tensor) -> Tensor:
        return self.one(x.device).expand(x.shape).clone()

    def gamma(self, device="cpu"):
        """The five Frobenius twist constants as Fq2 elements."""
        fq = self.fq
        return [self.fq2.build(fq.constant(g0, device), fq.constant(g1, device))
                for g0, g1 in _gamma_ints()]

    def from_int_pairs(self, vals) -> np.ndarray:
        """[(fq6_triple, fq6_triple), ...] host tuples → (len, 2,3,2,n)."""
        return np.stack([self.fq6.from_int_triples([a, b]) for a, b in vals])

    def to_int_pairs(self, x: Tensor):
        a = self.fq6.to_int_triples(self.c0(x))
        b = self.fq6.to_int_triples(self.c1(x))
        return list(zip(a, b))

    # arithmetic -------------------------------------------------------------

    def add(self, x: Tensor, y: Tensor) -> Tensor:
        return self.fq.add(x, y)

    def mul(self, x: Tensor, y: Tensor) -> Tensor:
        # Karatsuba over Fq6 with w² = v (host fq12_mul): 3 Fq6 muls.
        f = self.fq6
        x, y = torch.broadcast_tensors(x, y)
        a0, a1, b0, b1 = self.c0(x), self.c1(x), self.c0(y), self.c1(y)
        s = f.add(_st([a0, b0]), _st([a1, b1]))
        t0, t1, m = f.mul(_st([a0, a1, s[0]]), _st([b0, b1, s[1]]))
        c0 = f.add(t0, f.mul_v(t1))
        c1 = f.sub(f.sub(m, t0), t1)
        return self.build(c0, c1)

    def sq(self, x: Tensor) -> Tensor:
        # Complex squaring: (a0 + a1w)² = (a0 + a1)(a0 + v·a1) − t − vt
        # with t = a0·a1 — 2 Fq6 muls vs mul's 3.
        f = self.fq6
        a0, a1 = self.c0(x), self.c1(x)
        s = f.add(_st([a0, a0]), _st([a1, f.mul_v(a1)]))
        t, m = f.mul(_st([a0, s[0]]), _st([a1, s[1]]))
        c0 = f.sub(f.sub(m, t), f.mul_v(t))
        return self.build(c0, f.add(t, t))

    def conj(self, x: Tensor) -> Tensor:
        """x^(p⁶): negate the w-odd half.  For cyclotomic elements this
        is the inverse (unitary)."""
        return self.build(self.c0(x), self.fq6.neg(self.c1(x)))

    def inv(self, x: Tensor) -> Tensor:
        f = self.fq6
        a = _st([self.c0(x), self.c1(x)])
        sq0, sq1 = f.sq(a)
        t = f.inv(f.sub(sq0, f.mul_v(sq1)))
        m0, m1 = f.mul(a, t)
        return self.build(m0, f.neg(m1))

    def mul_by_014(self, x: Tensor, a0: Tensor, a1: Tensor,
                   a4: Tensor) -> Tensor:
        """x · g where g is sparse in the (1, v, v², w, vw, v²w) basis:
        g = a0 + a1·v + a4·vw — the shape of a Miller-loop line evaluated
        at a twisted G1 point (ops/pairing.py).  13 Fq2 muls vs the dense
        mul's 18."""
        f6, f2 = self.fq6, self.fq2
        x0, x1 = self.c0(x), self.c1(x)
        a0, a1, a4 = (a.expand(x.shape[:-4] + a.shape[-2:])
                      for a in (a0, a1, a4))
        t0, m = f6.mul_by_01(_st([x0, f6.add(x0, x1)]), _st([a0, a0]),
                             _st([a1, f2.add(a1, a4)]))
        t1 = f6.mul_by_1(x1, a4)
        c0 = f6.add(t0, f6.mul_v(t1))
        c1 = f6.sub(f6.sub(m, t0), t1)
        return self.build(c0, c1)

    # cyclotomic subgroup ----------------------------------------------------

    def cyc_sq(self, x: Tensor) -> Tensor:
        """Squaring for UNITARY elements (x·conj(x) = 1, true of
        everything after the final exponentiation's easy part): with
        x = a + bw, x² = (2a² − 1) + 2ab·w — one Fq6 square and one Fq6
        mul, as one stacked multiply."""
        f = self.fq6
        a, b = self.c0(x), self.c1(x)
        a2, ab = f.mul(_st([a, a]), _st([a, b]))
        d = f.add(_st([a2, ab]), _st([a2, ab]))
        return self.build(f.sub(d[0], f.one(x.device)), d[1])

    def cyc_pow_abs(self, x: Tensor, e: int) -> Tensor:
        """x^e for a static e ≥ 1, x cyclotomic: MSB-first square-and-
        multiply with cyclotomic squarings; the multiply runs only on the
        set bits.  Negative exponents: pass conj(x) (= x⁻¹)."""
        assert e >= 1
        acc = x
        for c in bin(e)[3:]:
            acc = self.cyc_sq(acc)
            if c == "1":
                acc = self.mul(acc, x)
        return acc

    # Frobenius --------------------------------------------------------------

    def frobenius(self, x: Tensor) -> Tensor:
        """x^p: conjugate every Fq2 coefficient, twist by the γ table
        (host fq12_frobenius)."""
        f2 = self.fq2
        g = self.gamma(x.device)
        cx = f2.conj(x)  # (..., 2, 3, 2, n)
        a, b = self.c0(cx), self.c1(cx)
        m = f2.mul(_st(torch.broadcast_tensors(
                       a[..., 1, :, :], a[..., 2, :, :], b[..., 0, :, :],
                       b[..., 1, :, :], b[..., 2, :, :])),
                   _st([g[1], g[3], g[0], g[2], g[4]])
                   .reshape((5,) + (1,) * (x.dim() - 4) + (2, -1)))
        return self.build(self.fq6.build(a[..., 0, :, :], m[0], m[1]),
                          self.fq6.build(m[2], m[3], m[4]))

    # final exponentiation ---------------------------------------------------

    def final_exponentiation(self, f: Tensor) -> Tensor:
        """f^(3·(p¹²−1)/r) — the host fast chain
        (crypto/bls12381.py final_exponentiation): easy part by
        conjugation, one inversion and two Frobenius maps, hard part as
        the BLS12 (x−1)²·(x+p)·(x²+p²−1)+3 decomposition over cyclotomic
        |x|-power chains.  Outputs match the host chain value for value
        (the shared CUBE of the standard pairing)."""
        x_abs = oracle.X_ABS
        m = self.mul(self.conj(f), self.inv(f))             # f^(p⁶−1)
        m = self.mul(self.frobenius(self.frobenius(m)), m)  # ^(p²+1)
        # Hard part; m is cyclotomic now, x = −|x| so x−1 = −(|x|+1).
        t0 = self.cyc_pow_abs(self.conj(m), x_abs + 1)      # m^(x−1)
        t1 = self.cyc_pow_abs(self.conj(t0), x_abs + 1)     # ^(x−1)²
        t2 = self.mul(self.cyc_pow_abs(self.conj(t1), x_abs),
                      self.frobenius(t1))                   # ^(x+p)
        u = self.cyc_pow_abs(self.conj(t2), x_abs)
        t3 = self.mul(
            self.mul(self.cyc_pow_abs(self.conj(u), x_abs),
                     self.frobenius(self.frobenius(t2))),
            self.conj(t2))                                  # ^(x²+p²−1)
        return self.mul(t3, self.mul(self.cyc_sq(m), m))    # · m³

    # predicates / selection -------------------------------------------------

    def is_one(self, x: Tensor) -> Tensor:
        return self.eq(x, self.one_like(x))

    def eq(self, x: Tensor, y: Tensor) -> Tensor:
        return self.fq6.eq(x, y).all(-1)

    def where(self, mask: Tensor, x: Tensor, y: Tensor) -> Tensor:
        return torch.where(mask[..., None, None, None, None], x, y)
