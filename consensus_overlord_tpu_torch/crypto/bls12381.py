"""BLS12-381 pairing-based signatures — pure-Python CPU oracle.

The reference's crypto provider is BLS12-381 via ophelia-blst (native blst
C/assembly; reference src/consensus.rs:336-337, 385-463): min-sig layout with
48-byte G1 signatures and 96-byte G2 public keys that double as validator
addresses (src/consensus.rs:352-357, 406).  This module is a from-scratch
implementation of the full stack — Fq/Fq2/Fq6/Fq12 tower, curve arithmetic,
optimal-ate pairing, ZCash-format point (de)compression, hash-to-G1, and the
sign / verify / aggregate / aggregate-verify surface — used as the
correctness oracle for the batched device paths (ops/ and
crypto/cuda_provider.py).

A copy of consensus_overlord_tpu/crypto/bls12381.py: the PyTorch port
imports nothing of the JAX package, so it keeps its own oracle; the
native pairing goes through this package's crypto/native.py.

Scheme (min-sig, mirroring blst's BLS_SIG_BASIC on G1):
    sk ∈ Z_r;   pk = sk·G2  (96B compressed);   sig = sk·H(m) ∈ G1 (48B)
    verify:      e(sig, G2gen) == e(H(m), pk)
    agg-verify:  e(agg_sig, G2gen) == e(H(m), Σ pk_i)   (same-message agg)

Hash-to-curve is deterministic try-and-increment over SM3 (the reference
signs 32-byte SM3 digests directly, src/consensus.rs:390-395; its
`common_ref` domain string — "" in the reference, src/consensus.rs:351 — is
the `domain` parameter here).  Not constant-time: simulation/benchmark
posture, keys stay host-side (SURVEY.md §7 hard-parts note e).
"""

from __future__ import annotations

import functools
from typing import Iterable, List, Sequence, Tuple

from ..core.sm3 import sm3_hash

# --------------------------------------------------------------------------
# Parameters
# --------------------------------------------------------------------------

P = 0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFAAAB
R = 0x73EDA753299D7D483339D80809A1D80553BDA402FFFE5BFEFFFFFFFF00000001
# BLS parameter x (negative); |x| drives the Miller loop and final exp.
X_ABS = 0xD201000000010000
G1_COFACTOR = 0x396C8C005555E1568C00AAAB0000AAAB

G1_GEN = (
    0x17F1D3A73197D7942695638C4FA9AC0FC3688C4F9774B905A14E3A3F171BAC586C55E83FF97A1AEFFB3AF00ADB22C6BB,
    0x08B3F481E3AAA0F1A09E30ED741D8AE4FCF5E095D5D00AF600DB18CB2C04B3EDD03CC744A2888AE40CAA232946C5E7E1,
)
G2_GEN = (
    (
        0x024AA2B2F08F0A91260805272DC51051C6E47AD4FA403B02B4510B647AE3D1770BAC0326A805BBEFD48056C8C121BDB8,
        0x13E02B6052719F607DACD3A088274F65596BD0D09920B61AB5DA61BBDC7F5049334CF11213945D57E5AC7D055D042B7E,
    ),
    (
        0x0CE5D527727D6E118CC9CDC6DA2E351AADFD9BAA8CBDD3A76D429A695160D12C923AC9CC3BACA289E193548608B82801,
        0x0606C4A02EA734CC32ACD2B02BC28B99CB3E287E85A763AF267492AB572E99AB3F370D275CEC1DA1AAA9075FF05F79BE,
    ),
)

# --------------------------------------------------------------------------
# Fq and the Fq2 / Fq6 / Fq12 tower
#   Fq2  = Fq[u]  / (u² + 1)
#   Fq6  = Fq2[v] / (v³ − ξ),  ξ = u + 1
#   Fq12 = Fq6[w] / (w² − v)        (so w⁶ = ξ)
# Elements are plain tuples: Fq2 = (a, b); Fq6 = (c0, c1, c2); Fq12 = (d0, d1).
# --------------------------------------------------------------------------

Fq2 = Tuple[int, int]
Fq6 = Tuple[Fq2, Fq2, Fq2]
Fq12 = Tuple[Fq6, Fq6]

FQ2_ZERO: Fq2 = (0, 0)
FQ2_ONE: Fq2 = (1, 0)
FQ6_ZERO: Fq6 = (FQ2_ZERO, FQ2_ZERO, FQ2_ZERO)
FQ6_ONE: Fq6 = (FQ2_ONE, FQ2_ZERO, FQ2_ZERO)
FQ12_ZERO: Fq12 = (FQ6_ZERO, FQ6_ZERO)
FQ12_ONE: Fq12 = (FQ6_ONE, FQ6_ZERO)


def fq_inv(a: int) -> int:
    return pow(a, -1, P)


def fq_sqrt(a: int):
    """Square root in Fq (p ≡ 3 mod 4), or None if a is a non-residue."""
    a %= P
    if a == 0:
        return 0
    s = pow(a, (P + 1) // 4, P)
    return s if s * s % P == a else None


def fq2_add(a: Fq2, b: Fq2) -> Fq2:
    return ((a[0] + b[0]) % P, (a[1] + b[1]) % P)


def fq2_sub(a: Fq2, b: Fq2) -> Fq2:
    return ((a[0] - b[0]) % P, (a[1] - b[1]) % P)


def fq2_neg(a: Fq2) -> Fq2:
    return (-a[0] % P, -a[1] % P)


def fq2_mul(a: Fq2, b: Fq2) -> Fq2:
    # (a0 + a1 u)(b0 + b1 u) with u² = −1 (Karatsuba).
    t0 = a[0] * b[0]
    t1 = a[1] * b[1]
    t2 = (a[0] + a[1]) * (b[0] + b[1])
    return ((t0 - t1) % P, (t2 - t0 - t1) % P)


def fq2_sq(a: Fq2) -> Fq2:
    # (a0² − a1²) + 2 a0 a1 u
    return ((a[0] + a[1]) * (a[0] - a[1]) % P, 2 * a[0] * a[1] % P)


def fq2_scalar(a: Fq2, k: int) -> Fq2:
    return (a[0] * k % P, a[1] * k % P)


def fq2_conj(a: Fq2) -> Fq2:
    return (a[0], -a[1] % P)


def fq2_inv(a: Fq2) -> Fq2:
    # 1/(a0 + a1 u) = (a0 − a1 u) / (a0² + a1²)
    norm_inv = fq_inv((a[0] * a[0] + a[1] * a[1]) % P)
    return (a[0] * norm_inv % P, -a[1] * norm_inv % P)


def fq2_mul_xi(a: Fq2) -> Fq2:
    # multiply by ξ = 1 + u:  (a0 − a1) + (a0 + a1) u
    return ((a[0] - a[1]) % P, (a[0] + a[1]) % P)


def fq2_is_zero(a: Fq2) -> bool:
    return a[0] % P == 0 and a[1] % P == 0


def fq2_sqrt(a: Fq2):
    """Square root in Fq2 (u² = −1), or None.  Complex-sqrt formula:
    for a = x + y·u, with s = sqrt(x² + y²): sqrt(a) = t + (y / 2t)·u where
    t = sqrt((x ± s)/2)."""
    x, y = a[0] % P, a[1] % P
    if y == 0:
        t = fq_sqrt(x)
        if t is not None:
            return (t, 0)
        t = fq_sqrt(-x % P)
        if t is None:
            return None
        return (0, t)
    s = fq_sqrt((x * x + y * y) % P)
    if s is None:
        return None
    inv2 = fq_inv(2)
    for sign in (s, -s % P):
        alpha = (x + sign) * inv2 % P
        t = fq_sqrt(alpha)
        if t is not None and t != 0:
            res = (t, y * fq_inv(2 * t % P) % P)
            if fq2_sq(res) == (x, y):
                return res
    return None


def fq6_add(a: Fq6, b: Fq6) -> Fq6:
    return (fq2_add(a[0], b[0]), fq2_add(a[1], b[1]), fq2_add(a[2], b[2]))


def fq6_sub(a: Fq6, b: Fq6) -> Fq6:
    return (fq2_sub(a[0], b[0]), fq2_sub(a[1], b[1]), fq2_sub(a[2], b[2]))


def fq6_neg(a: Fq6) -> Fq6:
    return (fq2_neg(a[0]), fq2_neg(a[1]), fq2_neg(a[2]))


def fq6_mul(a: Fq6, b: Fq6) -> Fq6:
    a0, a1, a2 = a
    b0, b1, b2 = b
    t0 = fq2_mul(a0, b0)
    t1 = fq2_mul(a1, b1)
    t2 = fq2_mul(a2, b2)
    # c0 = t0 + ξ·((a1+a2)(b1+b2) − t1 − t2)
    c0 = fq2_add(t0, fq2_mul_xi(
        fq2_sub(fq2_sub(fq2_mul(fq2_add(a1, a2), fq2_add(b1, b2)), t1), t2)))
    # c1 = (a0+a1)(b0+b1) − t0 − t1 + ξ·t2
    c1 = fq2_add(
        fq2_sub(fq2_sub(fq2_mul(fq2_add(a0, a1), fq2_add(b0, b1)), t0), t1),
        fq2_mul_xi(t2))
    # c2 = (a0+a2)(b0+b2) − t0 − t2 + t1
    c2 = fq2_add(
        fq2_sub(fq2_sub(fq2_mul(fq2_add(a0, a2), fq2_add(b0, b2)), t0), t2), t1)
    return (c0, c1, c2)


def fq6_mul_v(a: Fq6) -> Fq6:
    # multiply by v:  (c0, c1, c2) → (ξ·c2, c0, c1)
    return (fq2_mul_xi(a[2]), a[0], a[1])


def fq6_inv(a: Fq6) -> Fq6:
    a0, a1, a2 = a
    c0 = fq2_sub(fq2_sq(a0), fq2_mul_xi(fq2_mul(a1, a2)))
    c1 = fq2_sub(fq2_mul_xi(fq2_sq(a2)), fq2_mul(a0, a1))
    c2 = fq2_sub(fq2_sq(a1), fq2_mul(a0, a2))
    t = fq2_add(fq2_mul(a0, c0),
                fq2_mul_xi(fq2_add(fq2_mul(a2, c1), fq2_mul(a1, c2))))
    t_inv = fq2_inv(t)
    return (fq2_mul(c0, t_inv), fq2_mul(c1, t_inv), fq2_mul(c2, t_inv))


def fq12_add(a: Fq12, b: Fq12) -> Fq12:
    return (fq6_add(a[0], b[0]), fq6_add(a[1], b[1]))


def fq12_mul(a: Fq12, b: Fq12) -> Fq12:
    a0, a1 = a
    b0, b1 = b
    t0 = fq6_mul(a0, b0)
    t1 = fq6_mul(a1, b1)
    # (a0 b0 + v·a1 b1) + ((a0+a1)(b0+b1) − t0 − t1)·w
    c0 = fq6_add(t0, fq6_mul_v(t1))
    c1 = fq6_sub(fq6_sub(fq6_mul(fq6_add(a0, a1), fq6_add(b0, b1)), t0), t1)
    return (c0, c1)


def fq12_sq(a: Fq12) -> Fq12:
    return fq12_mul(a, a)


def fq12_conj(a: Fq12) -> Fq12:
    return (a[0], fq6_neg(a[1]))


def fq12_inv(a: Fq12) -> Fq12:
    a0, a1 = a
    t = fq6_inv(fq6_sub(fq6_mul(a0, a0), fq6_mul_v(fq6_mul(a1, a1))))
    return (fq6_mul(a0, t), fq6_neg(fq6_mul(a1, t)))


def fq12_pow(a: Fq12, e: int) -> Fq12:
    if e < 0:
        return fq12_pow(fq12_inv(a), -e)
    result = FQ12_ONE
    while e:
        if e & 1:
            result = fq12_mul(result, a)
        a = fq12_sq(a)
        e >>= 1
    return result


# Embeddings into Fq12.  An Fq element sits in the Fq2 c0 slot; an Fq2
# element x+yu sits in the Fq6 c0 slot of the Fq12 c0 slot.

def fq_to_fq12(a: int) -> Fq12:
    return (((a % P, 0), FQ2_ZERO, FQ2_ZERO), FQ6_ZERO)


def fq2_to_fq12(a: Fq2) -> Fq12:
    return ((a, FQ2_ZERO, FQ2_ZERO), FQ6_ZERO)


# --------------------------------------------------------------------------
# Curve arithmetic.
# G1: y² = x³ + 4 over Fq.  G2 (twist E'): y² = x³ + 4ξ over Fq2.
# Points are affine tuples or None (infinity); generic over the field ops.
# --------------------------------------------------------------------------

class _FieldOps:
    def __init__(self, add, sub, neg, mul, sq, inv, zero, one, scalar):
        self.add, self.sub, self.neg, self.mul = add, sub, neg, mul
        self.sq, self.inv, self.zero, self.one = sq, inv, zero, one
        self.scalar = scalar


_FQ_OPS = _FieldOps(
    add=lambda a, b: (a + b) % P, sub=lambda a, b: (a - b) % P,
    neg=lambda a: -a % P, mul=lambda a, b: a * b % P,
    sq=lambda a: a * a % P, inv=fq_inv, zero=0, one=1,
    scalar=lambda a, k: a * k % P)
_FQ2_OPS = _FieldOps(
    add=fq2_add, sub=fq2_sub, neg=fq2_neg, mul=fq2_mul, sq=fq2_sq,
    inv=fq2_inv, zero=FQ2_ZERO, one=FQ2_ONE, scalar=fq2_scalar)
_FQ12_OPS = _FieldOps(
    add=fq12_add, sub=lambda a, b: fq12_add(a, (fq6_neg(b[0]), fq6_neg(b[1]))),
    neg=lambda a: (fq6_neg(a[0]), fq6_neg(a[1])), mul=fq12_mul, sq=fq12_sq,
    inv=fq12_inv, zero=FQ12_ZERO, one=FQ12_ONE,
    scalar=lambda a, k: fq12_mul(a, fq_to_fq12(k)))


def _pt_double(pt, ops):
    if pt is None:
        return None
    x, y = pt
    if y == ops.zero:
        return None
    lam = ops.mul(ops.scalar(ops.sq(x), 3), ops.inv(ops.scalar(y, 2)))
    x3 = ops.sub(ops.sq(lam), ops.scalar(x, 2))
    y3 = ops.sub(ops.mul(lam, ops.sub(x, x3)), y)
    return (x3, y3)


def _pt_add(p1, p2, ops):
    if p1 is None:
        return p2
    if p2 is None:
        return p1
    x1, y1 = p1
    x2, y2 = p2
    if x1 == x2:
        if y1 == y2:
            return _pt_double(p1, ops)
        return None
    lam = ops.mul(ops.sub(y2, y1), ops.inv(ops.sub(x2, x1)))
    x3 = ops.sub(ops.sub(ops.sq(lam), x1), x2)
    y3 = ops.sub(ops.mul(lam, ops.sub(x1, x3)), y1)
    return (x3, y3)


def _pt_neg(pt, ops):
    if pt is None:
        return None
    return (pt[0], ops.neg(pt[1]))


def _pt_mul_affine(pt, k, ops):
    """k·pt by affine double-and-add (an inversion a step): the plain
    form the Jacobian ladder below is tested against."""
    if k < 0:
        return _pt_mul_affine(_pt_neg(pt, ops), -k, ops)
    result = None
    while k:
        if k & 1:
            result = _pt_add(result, pt, ops)
        pt = _pt_double(pt, ops)
        k >>= 1
    return result


def _jac_double(p, ops):
    """2·(X, Y, Z) in Jacobian coordinates on y² = x³ + b (a = 0;
    dbl-2009-l); Z = 0 is the point at infinity."""
    x, y, z = p
    if z == ops.zero or y == ops.zero:
        return (ops.one, ops.one, ops.zero)
    a = ops.sq(x)
    b = ops.sq(y)
    c = ops.sq(b)
    d = ops.scalar(ops.sub(ops.sub(ops.sq(ops.add(x, b)), a), c), 2)
    e = ops.scalar(a, 3)
    x3 = ops.sub(ops.sq(e), ops.scalar(d, 2))
    y3 = ops.sub(ops.mul(e, ops.sub(d, x3)), ops.scalar(c, 8))
    return (x3, y3, ops.scalar(ops.mul(y, z), 2))


def _jac_add_affine(p, q, ops):
    """(X, Y, Z) + affine q (madd-2007-bl), q not infinity."""
    x1, y1, z1 = p
    if z1 == ops.zero:
        return (q[0], q[1], ops.one)
    z1z1 = ops.sq(z1)
    u2 = ops.mul(q[0], z1z1)
    s2 = ops.mul(ops.mul(q[1], z1), z1z1)
    h = ops.sub(u2, x1)
    r = ops.sub(s2, y1)
    if h == ops.zero:
        if r == ops.zero:
            return _jac_double(p, ops)
        return (ops.one, ops.one, ops.zero)
    hh = ops.sq(h)
    i = ops.scalar(hh, 4)
    j = ops.mul(h, i)
    r = ops.scalar(r, 2)
    v = ops.mul(x1, i)
    x3 = ops.sub(ops.sub(ops.sq(r), j), ops.scalar(v, 2))
    y3 = ops.sub(ops.mul(r, ops.sub(v, x3)), ops.scalar(ops.mul(y1, j), 2))
    z3 = ops.sub(ops.sub(ops.sq(ops.add(z1, h)), z1z1), hh)
    return (x3, y3, z3)


def _pt_mul(pt, k, ops):
    """k·pt: a left-to-right Jacobian ladder with one inversion at the
    end (the affine double-and-add inverts at every step)."""
    if k < 0:
        return _pt_mul(_pt_neg(pt, ops), -k, ops)
    if pt is None or k == 0:
        return None
    acc = (ops.one, ops.one, ops.zero)
    for bit in bin(k)[2:]:
        acc = _jac_double(acc, ops)
        if bit == "1":
            acc = _jac_add_affine(acc, pt, ops)
    x, y, z = acc
    if z == ops.zero:
        return None
    zinv = ops.inv(z)
    zinv2 = ops.sq(zinv)
    return (ops.mul(x, zinv2), ops.mul(y, ops.mul(zinv2, zinv)))


# Public G1/G2 wrappers.

def g1_add(p1, p2):
    return _pt_add(p1, p2, _FQ_OPS)


def g1_mul(pt, k):
    return _pt_mul(pt, k % R if pt is not None else k, _FQ_OPS)


def g1_neg(pt):
    return _pt_neg(pt, _FQ_OPS)


def g2_add(p1, p2):
    return _pt_add(p1, p2, _FQ2_OPS)


def g2_mul(pt, k):
    return _pt_mul(pt, k % R if pt is not None else k, _FQ2_OPS)


def g1_is_on_curve(pt) -> bool:
    if pt is None:
        return True
    x, y = pt
    return (y * y - (x * x * x + 4)) % P == 0


def g2_is_on_curve(pt) -> bool:
    if pt is None:
        return True
    x, y = pt
    b = fq2_mul_xi((4, 0))  # 4ξ = 4 + 4u
    return fq2_sub(fq2_sq(y), fq2_add(fq2_mul(fq2_sq(x), x), b)) == FQ2_ZERO


def g1_in_subgroup(pt) -> bool:
    return g1_is_on_curve(pt) and _pt_mul(pt, R, _FQ_OPS) is None


def g2_in_subgroup(pt) -> bool:
    return g2_is_on_curve(pt) and _pt_mul(pt, R, _FQ2_OPS) is None


# --------------------------------------------------------------------------
# Pairing: untwist G2 into E(Fq12), Miller loop over |x|, final exponentiation.
# Untwist (M-twist, ξ = w⁶): (x', y') → (x'/w², y'/w³).
# With the tower w² = v:  1/w² = 1/v = v²·ξ⁻¹;  1/w³ = 1/(v·w) = w·v·ξ⁻¹...
# computed once below via a generic Fq12 inversion for clarity.
# --------------------------------------------------------------------------

def _w_pow_inv(n: int) -> Fq12:
    """(w^n)⁻¹ in Fq12."""
    w: Fq12 = (FQ6_ZERO, FQ6_ONE)
    return fq12_inv(fq12_pow(w, n))


_W2_INV = _w_pow_inv(2)
_W3_INV = _w_pow_inv(3)


def untwist(pt):
    """Map a point on E'(Fq2) to E(Fq12)."""
    if pt is None:
        return None
    x, y = pt
    return (fq12_mul(fq2_to_fq12(x), _W2_INV), fq12_mul(fq2_to_fq12(y), _W3_INV))


def _line(p1, p2, at):
    """Evaluate the line through p1,p2 (or tangent if equal) at point `at`.
    All points on E(Fq12), affine."""
    ops = _FQ12_OPS
    x1, y1 = p1
    x2, y2 = p2
    xt, yt = at
    if x1 != x2:
        lam = ops.mul(ops.sub(y2, y1), ops.inv(ops.sub(x2, x1)))
    elif y1 == y2:
        lam = ops.mul(ops.scalar(ops.sq(x1), 3), ops.inv(ops.scalar(y1, 2)))
    else:  # vertical line
        return ops.sub(xt, x1)
    return ops.sub(ops.sub(yt, y1), ops.mul(lam, ops.sub(xt, x1)))


def miller_loop(q, p) -> Fq12:
    """f_{|x|,Q}(P), conjugated for the negative BLS parameter.
    q, p are points on E(Fq12) (q from untwist(G2 point), p from G1)."""
    if q is None or p is None:
        return FQ12_ONE
    ops = _FQ12_OPS
    f = FQ12_ONE
    r_pt = q
    for bit in bin(X_ABS)[3:]:
        f = fq12_mul(fq12_sq(f), _line(r_pt, r_pt, p))
        r_pt = _pt_add(r_pt, r_pt, ops)
        if bit == "1":
            f = fq12_mul(f, _line(r_pt, q, p))
            r_pt = _pt_add(r_pt, q, ops)
    # x < 0: invert; post-final-exp, conjugation == inversion, and the
    # difference is killed by the final exponentiation.
    return fq12_conj(f)


def _frob_gamma() -> List[Fq2]:
    """γ^k = ξ^(k·(p−1)/6) for k = 1..5 — the Frobenius twist constants of
    the 1, v, v², w, vw, v²w basis."""
    xi: Fq2 = (1, 1)
    e = (P - 1) // 6
    g = _fq2_pow(xi, e)
    out = [g]
    for _ in range(4):
        out.append(fq2_mul(out[-1], g))
    return out


def _fq2_pow(a: Fq2, e: int) -> Fq2:
    result: Fq2 = FQ2_ONE
    while e:
        if e & 1:
            result = fq2_mul(result, a)
        a = fq2_sq(a)
        e >>= 1
    return result


_GAMMA = None


def fq12_frobenius(f: Fq12) -> Fq12:
    """f^p via coefficient conjugation + twist constants (γ table built
    lazily)."""
    global _GAMMA
    if _GAMMA is None:
        _GAMMA = _frob_gamma()
    g = _GAMMA
    (a0, a1, a2), (b0, b1, b2) = f
    return (
        (fq2_conj(a0), fq2_mul(fq2_conj(a1), g[1]), fq2_mul(fq2_conj(a2), g[3])),
        (fq2_mul(fq2_conj(b0), g[0]), fq2_mul(fq2_conj(b1), g[2]),
         fq2_mul(fq2_conj(b2), g[4])),
    )


def _cyc_pow(f: Fq12, e: int) -> Fq12:
    """f^e for f in the cyclotomic subgroup (where f⁻¹ = conj(f)), signed
    exponent."""
    if e < 0:
        return _cyc_pow(fq12_conj(f), -e)
    result = FQ12_ONE
    while e:
        if e & 1:
            result = fq12_mul(result, f)
        f = fq12_sq(f)
        e >>= 1
    return result


def final_exponentiation(f: Fq12) -> Fq12:
    """f^(3·(p¹²−1)/r) — the standard *cubed* final exponentiation: the
    BLS12 parameter decomposition (x−1)²·(x+p)·(x²+p²−1) + 3 equals three
    times the hard exponent, and since gcd(3, r) = 1 the cube changes no
    `== 1` or cross-pairing equality check, while costing ~5 64-bit
    exponentiations instead of one 4569-bit one.  Easy part by
    inversion + Frobenius."""
    # Easy part: f^((p⁶−1)(p²+1)).  m = f^(p⁶−1) = conj(f)·f⁻¹, then
    # m^(p²)·m via two Frobenius applications.
    m = fq12_mul(fq12_conj(f), fq12_inv(f))
    m = fq12_mul(fq12_frobenius(fq12_frobenius(m)), m)
    # Hard part (m is now cyclotomic: m⁻¹ = conj(m)).
    x = -X_ABS
    t0 = _cyc_pow(m, x - 1)                       # m^(x−1)
    t1 = _cyc_pow(t0, x - 1)                      # m^((x−1)²)
    t2 = fq12_mul(_cyc_pow(t1, x), fq12_frobenius(t1))   # ^(x+p)
    t3 = fq12_mul(
        fq12_mul(_cyc_pow(_cyc_pow(t2, x), x),
                 fq12_frobenius(fq12_frobenius(t2))),
        fq12_conj(t2))                            # ^(x²+p²−1)
    return fq12_mul(t3, fq12_mul(fq12_sq(m), m))  # · m³


def final_exponentiation_naive(f: Fq12) -> Fq12:
    """Reference-grade slow path (plain square-and-multiply over the full
    hard exponent); kept as the oracle for the fast chain above."""
    f1 = fq12_mul(fq12_conj(f), fq12_inv(f))
    f2 = fq12_mul(fq12_pow(f1, P * P), f1)
    hard = (P**4 - P**2 + 1) // R
    return fq12_pow(f2, hard)


def pairing(q, p) -> Fq12:
    """e(P, Q)³ with P ∈ G1, Q ∈ G2' (affine Fq/Fq2 points).

    NOTE: the fast final_exponentiation computes f^(3·e), so this returns
    the CUBE of the standard ate pairing value.  Since 3 ∤ r, cubing is a
    bijection on the r-th roots of unity: every in-repo use (== 1 tests,
    cross-pairing equality) is invariant.  For byte-level comparison
    against external pairing test vectors, use
    final_exponentiation_naive(miller_loop(...)) instead."""
    return final_exponentiation(miller_loop(untwist(q), (fq_to_fq12(p[0]), fq_to_fq12(p[1]))))


def multi_pairing_is_one_pure(
        pairs: Iterable[Tuple[object, object]]) -> bool:
    """Π e(P_i, Q_i) == 1, sharing one final exponentiation — the
    pure-Python path (the correctness oracle for the native backend).
    pairs: iterable of (g1_point, g2_point)."""
    f = FQ12_ONE
    for p, q in pairs:
        if p is None or q is None:
            continue
        f = fq12_mul(f, miller_loop(untwist(q), (fq_to_fq12(p[0]), fq_to_fq12(p[1]))))
    return final_exponentiation(f) == FQ12_ONE


def multi_pairing_is_one(pairs: Iterable[Tuple[object, object]]) -> bool:
    """Π e(P_i, Q_i) == 1 — dispatches to the native C backend
    (csrc/bls381.c, ~13x faster per check) when a compiler is around,
    falling back to the pure path.  Every pairing consumer (verify,
    aggregate-verify, the CUDA provider's per-batch checks) funnels
    through here."""
    from . import native
    if native.available():
        return native.multi_pairing_is_one(list(pairs))
    return multi_pairing_is_one_pure(pairs)


# --------------------------------------------------------------------------
# Serialization (ZCash BLS12-381 format: 48B G1 / 96B G2 compressed,
# flag bits in the top 3 bits of byte 0: compressed, infinity, y-sign).
# --------------------------------------------------------------------------

_FLAG_COMPRESSED = 0x80
_FLAG_INFINITY = 0x40
_FLAG_SIGN = 0x20


def _y_is_lexicographically_largest_fq(y: int) -> bool:
    return y > (P - 1) // 2


def _y_is_lexicographically_largest_fq2(y: Fq2) -> bool:
    if y[1] != 0:
        return y[1] > (P - 1) // 2
    return y[0] > (P - 1) // 2


def g1_compress(pt) -> bytes:
    if pt is None:
        return bytes([_FLAG_COMPRESSED | _FLAG_INFINITY]) + b"\x00" * 47
    x, y = pt
    flags = _FLAG_COMPRESSED
    if _y_is_lexicographically_largest_fq(y):
        flags |= _FLAG_SIGN
    raw = bytearray(x.to_bytes(48, "big"))
    raw[0] |= flags
    return bytes(raw)


def g1_decompress(data: bytes):
    if len(data) != 48:
        raise ValueError("G1 compressed point must be 48 bytes")
    flags = data[0]
    if not flags & _FLAG_COMPRESSED:
        raise ValueError("uncompressed G1 encoding not supported")
    if flags & _FLAG_INFINITY:
        if any(data[1:]) or flags & _FLAG_SIGN or data[0] & 0x1F:
            raise ValueError("malformed G1 infinity encoding")
        return None
    x = int.from_bytes(bytes([data[0] & 0x1F]) + data[1:], "big")
    if x >= P:
        raise ValueError("G1 x out of range")
    y = fq_sqrt((x * x * x + 4) % P)
    if y is None:
        raise ValueError("G1 x not on curve")
    if _y_is_lexicographically_largest_fq(y) != bool(flags & _FLAG_SIGN):
        y = -y % P
    return (x, y)


def g2_compress(pt) -> bytes:
    if pt is None:
        return bytes([_FLAG_COMPRESSED | _FLAG_INFINITY]) + b"\x00" * 95
    x, y = pt
    flags = _FLAG_COMPRESSED
    if _y_is_lexicographically_largest_fq2(y):
        flags |= _FLAG_SIGN
    raw = bytearray(x[1].to_bytes(48, "big") + x[0].to_bytes(48, "big"))
    raw[0] |= flags
    return bytes(raw)


def g2_decompress(data: bytes):
    if len(data) != 96:
        raise ValueError("G2 compressed point must be 96 bytes")
    flags = data[0]
    if not flags & _FLAG_COMPRESSED:
        raise ValueError("uncompressed G2 encoding not supported")
    if flags & _FLAG_INFINITY:
        if any(data[1:]) or flags & _FLAG_SIGN or data[0] & 0x1F:
            raise ValueError("malformed G2 infinity encoding")
        return None
    x1 = int.from_bytes(bytes([data[0] & 0x1F]) + data[1:48], "big")
    x0 = int.from_bytes(data[48:], "big")
    if x0 >= P or x1 >= P:
        raise ValueError("G2 x out of range")
    x: Fq2 = (x0, x1)
    rhs = fq2_add(fq2_mul(fq2_sq(x), x), fq2_mul_xi((4, 0)))
    y = fq2_sqrt(rhs)
    if y is None:
        raise ValueError("G2 x not on curve")
    if _y_is_lexicographically_largest_fq2(y) != bool(flags & _FLAG_SIGN):
        y = fq2_neg(y)
    return (x, y)


# --------------------------------------------------------------------------
# Hash-to-G1 (deterministic try-and-increment over SM3) and the signature
# scheme surface.
# --------------------------------------------------------------------------

@functools.lru_cache(maxsize=4096)
def hash_to_g1(message: bytes, domain: bytes = b""):
    """Deterministic map bytes → G1 r-torsion point: RFC 9380
    BLS12381G1_XMD:SHA-256_SSWU_RO_ (crypto/hash_to_curve.py) — the
    standards hash the reference reaches through blst's hash-to-curve
    (src/consensus.rs:390-395).  `domain` is the DST; the reference's
    hard-coded common_ref = "" (src/consensus.rs:351) maps to the
    standard basic-scheme ciphersuite tag.  lru-cached: every verify of
    a batch on the same vote hash re-derives the same point."""
    from .hash_to_curve import DEFAULT_DST, hash_to_curve_g1
    return hash_to_curve_g1(message, domain or DEFAULT_DST)


def hash_to_g1_try_increment(message: bytes, domain: bytes = b""):
    """The round-1/2 try-and-increment map, kept as a non-standard
    cross-check of scheme-level properties (tests compare both maps'
    sign/verify behavior; new signatures use SSWU above)."""
    for ctr in range(256):
        seed = domain + message + bytes([ctr])
        h = sm3_hash(seed + b"\x00") + sm3_hash(seed + b"\x01")
        x = int.from_bytes(h, "big") % P
        rhs = (x * x * x + 4) % P
        y = fq_sqrt(rhs)
        if y is None:
            continue
        if sm3_hash(seed + b"\x02")[0] & 1:
            y = -y % P
        pt = g1_mul((x, y), G1_COFACTOR)
        if pt is not None:
            return pt
    raise ValueError("hash_to_g1 failed to find a point (probability ~2^-256)")


def sk_to_pk(sk: int) -> bytes:
    """Serialize the G2 public key for scalar sk (96B; doubles as the
    validator address, reference src/consensus.rs:352-357)."""
    return g2_compress(g2_mul(G2_GEN, sk % R))


def sign(sk: int, message: bytes, domain: bytes = b"") -> bytes:
    """sig = sk · H(m) ∈ G1, 48 bytes compressed."""
    return g1_compress(g1_mul(hash_to_g1(message, domain), sk % R))


def verify(pk_bytes: bytes, message: bytes, sig_bytes: bytes,
           domain: bytes = b"", check_subgroup: bool = True) -> bool:
    """e(sig, G2gen) == e(H(m), pk), via e(sig, −G2gen)·e(H(m), pk) == 1."""
    try:
        sig = g1_decompress(sig_bytes)
        pk = g2_decompress(pk_bytes)
    except ValueError:
        return False
    if sig is None or pk is None:
        return False
    if check_subgroup and not (g1_in_subgroup(sig) and g2_in_subgroup(pk)):
        return False
    h = hash_to_g1(message, domain)
    neg_g2 = (G2_GEN[0], fq2_neg(G2_GEN[1]))
    return multi_pairing_is_one([(sig, neg_g2), (h, pk)])


def aggregate_signatures(sig_bytes_list: Sequence[bytes]) -> bytes:
    """Sum the G1 signatures (reference src/consensus.rs:418-444)."""
    agg = None
    for sb in sig_bytes_list:
        agg = g1_add(agg, g1_decompress(sb))
    return g1_compress(agg)


def aggregate_pubkeys(pk_bytes_list: Sequence[bytes]) -> bytes:
    """Sum the G2 public keys (reference src/consensus.rs:365-383)."""
    agg = None
    for pb in pk_bytes_list:
        agg = g2_add(agg, g2_decompress(pb))
    return g2_compress(agg)


def aggregate_verify_same_message(
        pk_bytes_list: Sequence[bytes], message: bytes, agg_sig_bytes: bytes,
        domain: bytes = b"", check_subgroup: bool = True) -> bool:
    """Same-message aggregate verification: e(agg_sig, G2gen) ==
    e(H(m), Σ pk_i) — the QC verification shape of the reference
    (src/consensus.rs:446-462)."""
    try:
        agg_sig = g1_decompress(agg_sig_bytes)
        pks = [g2_decompress(pb) for pb in pk_bytes_list]
    except ValueError:
        return False
    if agg_sig is None or not pks:
        return False
    if check_subgroup:
        if not g1_in_subgroup(agg_sig):
            return False
        if any(pk is None or not g2_in_subgroup(pk) for pk in pks):
            return False
    agg_pk = None
    for pk in pks:
        agg_pk = g2_add(agg_pk, pk)
    if agg_pk is None:
        return False
    h = hash_to_g1(message, domain)
    neg_g2 = (G2_GEN[0], fq2_neg(G2_GEN[1]))
    return multi_pairing_is_one([(agg_sig, neg_g2), (h, agg_pk)])
