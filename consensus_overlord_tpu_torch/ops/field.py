"""Batched prime-field arithmetic on int32 limb tensors (PyTorch).

The counterpart of consensus_overlord_tpu/ops/field.py, with the same
limb layout and the same statically planned reductions, so every loose
output is bit-identical to the JAX package's:

* An element of F_p is ``n`` limbs of ``b`` bits on the trailing axis of
  an int32 tensor (n = 39, b = 10 for BLS12-381; n = 26 for the 256-bit
  primes of Ed25519, secp256k1 and SM2).  A full schoolbook
  product convolution stays below 2**31, so everything is exact int32.
* Limbs are **loose**: any limb ≤ ``loose_max`` (2**(b+2) − 1) is legal.
  Each op ends in a reduction pipeline (carry passes + fold-row
  multiplies) planned in exact Python integers by ``_plan``; the plan is
  a proof that no intermediate overflows int32 and the output is loose.
* Canonical strict digits (value < p) appear only at boundaries —
  equality and zero tests, serialization — via a ripple carry and a
  conditional-subtraction ladder of 2**k·p multiples.

``mul`` is the first CUDA kernel's wrapper: for CUDA tensors it launches
csrc/fq_mul.cu, built for this spec, through ops/kernels.py; for CPU
tensors it runs ``mul_plain``, the staircase form of the same
convolution and reduction.  ``inv`` of CUDA tensors runs its product
chain in one launch of csrc/pairing.cu (``kernels.fq_inv``) where that
library is built for the spec.
Every other op is plain PyTorch on whatever device the tensors are on,
except that on the CPU the reductions and mul_plain's convolution run
the same integer steps on numpy views of the tensors (torch's per-call
cost dominates at these sizes).
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from . import kernels

Tensor = torch.Tensor

_I32_MAX = 2**31 - 1

#: The calls of the plain arithmetic that differ between array libraries
#: (concatenate, zeros shaped like an operand's kind, int32): torch for
#: device tensors, numpy for views of CPU tensors, whose per-call cost on
#: these small arrays is a fraction of torch's; the integers are the same.
_TORCH_OPS = (torch.cat, lambda x, shape: x.new_zeros(shape), torch.int32)
_NUMPY_OPS = (np.concatenate, lambda x, shape: np.zeros(shape, x.dtype),
              np.int32)


def _digits(v: int, b: int, n: int) -> List[int]:
    """Base-2**b digits of v, little-endian, exactly n of them (top digit
    absorbs any excess)."""
    mask = (1 << b) - 1
    out = [(v >> (b * i)) & mask for i in range(n - 1)]
    out.append(v >> (b * (n - 1)))
    return out


class FieldSpec:
    """A prime field F_p with a fixed limb layout and precomputed reduction
    tables.  Methods are functions over int32 tensors whose trailing axis
    is the limb axis; constants follow the device of their operands."""

    def __init__(self, p: int, limb_bits: int = 10, name: str = "F_p"):
        self.p = p
        self.b = limb_bits
        self.name = name
        self.mask = (1 << limb_bits) - 1
        self.n = -(-p.bit_length() // limb_bits)
        self.loose_max = (1 << (limb_bits + 2)) - 1
        b, n = self.b, self.n
        if self.n * self.loose_max**2 > _I32_MAX:
            raise ValueError("limb width too large: product convolution "
                             "would overflow int32")
        if b * n - p.bit_length() < 2:
            raise ValueError("need ≥2 slack bits so fold-row top limbs "
                             "stay tiny")

        # Fold rows: row k is the limb form of 2**(b·(n+k)) mod p.
        self._fold_np = np.array(
            [_digits(pow(2, b * (n + k), p), b, n) for k in range(n + 8)],
            dtype=np.int64)
        # Conditional-subtraction ladder for canonicalization.
        j_top = b * n - p.bit_length()
        self._ladder = [1 << j for j in range(j_top, -1, -1)]
        # Subtraction pad: a multiple of p with every limb ≥ loose_max.
        self._pad_np = self._build_pad()
        self._one_np = np.array(_digits(1, b, n), dtype=np.int64)
        # int64 words of lpw limbs for canonicalization: a word of loose
        # limbs stays below 2**(lpw·b + 2), and a carry-fold round adds at
        # most a few multiples of 2**(lpw·b), all inside int64.
        self._lpw = 60 // b
        self._nwords = -(-n // self._lpw)
        self._word_bits = [b * min(self._lpw, n - self._lpw * k)
                           for k in range(self._nwords)]
        self._plan_memo: dict = {}
        self._consts: Dict[Tuple[str, torch.device], Tensor] = {}
        # Input bounds of the reductions (tuples: the plan memo's keys).
        # Planning them here also makes an unreducible layout fail at
        # construction.
        self._mul_bounds = tuple(self._conv_bounds())
        self._sub_bounds = (self.loose_max + int(self._pad_np.max()),) * n
        self._neg_bounds = (int(self._pad_np.max()),) * n
        for bounds in (self._mul_bounds, self._small_bounds(2),
                       self._sub_bounds, self._neg_bounds):
            self._plan(list(bounds))

    # -- construction of constants ------------------------------------------

    def _build_pad(self) -> np.ndarray:
        b, n, L = self.b, self.n, self.loose_max
        hi_cap = 3 * (1 << b) + L
        for m in range(1, 1 << (b + 3)):
            v = m * self.p
            if v >= 1 << (b * (n - 1) + b + 3):
                break
            d = _digits(v, b, n)
            ok = True
            for i in range(n - 1):
                if d[i] < L:
                    need = -(-(L - d[i]) >> b)
                    d[i] += need << b
                    d[i + 1] -= need
                if not (L <= d[i] <= hi_cap):
                    ok = False
                    break
            if ok and L <= d[n - 1] <= hi_cap:
                return np.array(d, dtype=np.int64)
        raise ValueError(f"no subtraction pad found for {self.name}")

    def const(self, name: str, device) -> Tensor:
        """A table of this field as a tensor on `device`, uploaded once
        per device: int32 limbs ('fold', 'pad', 'one') or int64 words
        ('word_shift', 'word_over', 'word_kp<k>')."""
        key = (name, torch.device(device))
        t = self._consts.get(key)
        if t is None:
            if name == "fold":
                arr = self._fold_np.astype(np.int32)
            elif name == "pad":
                arr = self._pad_np.astype(np.int32)
            elif name == "one":
                arr = self._one_np.astype(np.int32)
            elif name == "word_shift":
                arr = np.arange(self._lpw, dtype=np.int64) * self.b
            elif name == "word_over":
                arr = self._words_of(pow(2, self.b * self.n, self.p))
            else:  # word_kp<k>
                arr = self._words_of(int(name[7:]) * self.p)
            t = torch.as_tensor(arr, device=key[1])
            self._consts[key] = t
        return t

    # -- loose-pipeline internals -------------------------------------------

    def _plan(self, bounds: List[int]) -> List[Tuple[str, int]]:
        """Static reduction plan for the given per-position bounds: a list
        of ('fold', k) / ('carry', extend) / ('pad', k) steps ending with
        width n and all bounds ≤ loose_max.  Pure bound arithmetic —
        raises if no safe plan exists.  Memoized on the bound tuple."""
        key = tuple(bounds)
        cached = self._plan_memo.get(key)
        if cached is not None:
            return cached
        b, n, mask = self.b, self.n, self.mask
        steps: List[Tuple[str, int]] = []
        for _ in range(256):
            if len(bounds) <= n and max(bounds) <= self.loose_max:
                if len(bounds) < n:
                    steps.append(("pad", n - len(bounds)))
                    bounds += [0] * (n - len(bounds))
                self._plan_memo[key] = steps
                return steps
            m = len(bounds)
            if m > n:
                k = m - n
                fold_np = self._fold_np[:k]
                out_bounds = [
                    bounds[j] + int(sum(bounds[n + r] * fold_np[r, j]
                                        for r in range(k)))
                    for j in range(n)
                ]
                if max(out_bounds) <= _I32_MAX:
                    steps.append(("fold", k))
                    bounds = out_bounds
                    continue
            extend = 1 if bounds[-1] > mask else 0
            if extend:
                bounds.append(0)
            steps.append(("carry", extend))
            bounds = [min(bounds[i], mask) +
                      (bounds[i - 1] >> b if i else 0)
                      for i in range(len(bounds))]
        raise ValueError(f"reduction plan did not converge for {self.name}")

    def _reduce(self, x: Tensor, bounds: Tuple[int, ...]) -> Tensor:
        """Reduce a wide non-negative accumulator (trailing axis =
        positions, per-position upper bounds as exact Python ints) to n
        loose limbs congruent mod p, following the planned steps."""
        if x.shape[-1] != len(bounds):
            raise ValueError("bounds do not match the accumulator width")
        plan = self._plan_memo.get(bounds) or self._plan(list(bounds))
        if x.device.type == "cpu":
            # graftlint: disable=CUDA001 -- a CPU tensor's numpy view (no device sync): the same integer steps at a fraction of torch's per-call cost on these small arrays
            fold = self.const("fold", x.device).numpy()
            # graftlint: disable=CUDA001 -- as above, a view of a CPU tensor
            return torch.from_numpy(self._run_plan(x.numpy(), plan, fold,
                                                   _NUMPY_OPS))
        return self._run_plan(x, plan, self.const("fold", x.device),
                              _TORCH_OPS)

    def _run_plan(self, x, plan, fold, ops):
        """The planned steps on x, a torch tensor or (on the CPU) a numpy
        array; `ops` are that library's concatenate, zeros and int32."""
        b, n, mask = self.b, self.n, self.mask
        cat, zeros, int32 = ops
        for step, arg in plan:
            if step == "pad":
                x = cat([x, zeros(x, x.shape[:-1] + (arg,))], -1)
            elif step == "fold":
                if arg == 1:
                    x = x[..., :n] + x[..., n:] * fold[0]
                else:
                    x = x[..., :n] + (x[..., n:, None] * fold[:arg]).sum(
                        -2, dtype=int32)
            else:  # carry: position i keeps its low b bits plus the
                # carry of position i − 1; arg = 1 widens by one position
                # for the top carry, else the top carry is provably 0.
                c = x >> b
                x = x & mask
                if arg:
                    x = cat([x, c[..., -1:]], -1)
                    x[..., 1:-1] += c[..., :-1]
                else:
                    x[..., 1:] += c[..., :-1]
        return x

    def _conv_bounds(self) -> List[int]:
        n, L = self.n, self.loose_max
        return [(min(i, n - 1) - max(0, i - n + 1) + 1) * L * L
                for i in range(2 * n - 1)]

    def _small_bounds(self, k: int) -> Tuple[int, ...]:
        return (k * self.loose_max,) * self.n

    # -- arithmetic (loose → loose) -----------------------------------------

    def add(self, x: Tensor, y: Tensor) -> Tensor:
        return self._reduce(x + y, self._small_bounds(2))

    def sub(self, x: Tensor, y: Tensor) -> Tensor:
        z = x + (self.const("pad", x.device) - y)
        return self._reduce(z, self._sub_bounds)

    def neg(self, x: Tensor) -> Tensor:
        return self._reduce(self.const("pad", x.device) - x,
                            self._neg_bounds)

    def mul(self, x: Tensor, y: Tensor) -> Tensor:
        """Loose × loose → loose.  CUDA tensors go through the fq_mul
        kernel (csrc/fq_mul.cu), CPU tensors through mul_plain; the two
        are bit-identical."""
        if x.device.type == "cpu" and y.device.type == "cpu":
            return self.mul_plain(x, y)
        x, y = torch.broadcast_tensors(x, y)
        shape = x.shape
        out = kernels.fq_mul(self, x.reshape(-1, self.n).contiguous(),
                             y.reshape(-1, self.n).contiguous())
        return out.reshape(shape)

    def mul_plain(self, x: Tensor, y: Tensor) -> Tensor:
        """The plain PyTorch multiply: the outer product P[i,j] = x_i·y_j,
        each row i right-shifted by i through a pad-flatten-rerow
        (staircase), summed to the 2n−1 convolution positions, then the
        planned reduction — the arithmetic of the JAX FieldSpec.mul.  On
        the CPU the product runs on numpy views, as _reduce does."""
        x, y = torch.broadcast_tensors(x, y)
        if x.device.type == "cpu":
            # graftlint: disable=CUDA001 -- views of CPU tensors (no device sync), as in _reduce
            acc = torch.from_numpy(self._conv(x.numpy(), y.numpy(),
                                              _NUMPY_OPS))
        else:
            acc = self._conv(x, y, _TORCH_OPS)
        return self._reduce(acc, self._mul_bounds)

    def _conv(self, x, y, ops):
        """The 2n−1 convolution positions of x·y (torch tensors, or numpy
        arrays on the CPU; `ops` as in _run_plan)."""
        n = self.n
        cat, zeros, int32 = ops
        prod = x[..., :, None] * y[..., None, :]
        prod = cat([prod, zeros(prod, prod.shape)], -1)
        flat = prod.reshape(prod.shape[:-2] + (2 * n * n,))[..., :2 * n * n - n]
        stair = flat.reshape(flat.shape[:-1] + (n, 2 * n - 1))
        return stair.sum(-2, dtype=int32)

    def sq(self, x: Tensor) -> Tensor:
        return self.mul(x, x)

    def mul_small(self, x: Tensor, k: int) -> Tensor:
        if not (0 <= k and k * self.loose_max <= _I32_MAX):
            raise ValueError(f"small multiplier {k} out of range")
        return self._reduce(x * k, self._small_bounds(k))

    def pow_static(self, x: Tensor, e: int) -> Tensor:
        """x**e mod p for a static Python-int exponent: fixed-window (w = 4)
        square-and-multiply with a 16-entry table — the same multiply
        sequence as the JAX scan, so the result is bit-identical."""
        if e == 0:
            return self.one(x.device).expand(x.shape).clone()
        if e < 0:
            raise ValueError("negative exponent")
        if e.bit_length() <= 16:  # tiny exponent: table build won't pay
            acc = x
            for c in bin(e)[3:]:  # after the leading 1 bit
                acc = self.mul(acc, acc)
                if c == "1":
                    acc = self.mul(acc, x)
            return acc
        digs = []
        v = e
        while v:
            digs.append(v & 15)
            v >>= 4
        digs.reverse()
        entries = [self.one(x.device).expand(x.shape), x]
        for _ in range(2, 16):
            entries.append(self.mul(entries[-1], x))
        acc = entries[digs[0]]
        for d in digs[1:]:
            for _ in range(4):
                acc = self.mul(acc, acc)
            acc = self.mul(acc, entries[d])
        return acc

    def inv(self, x: Tensor) -> Tensor:
        """Modular inverse by Fermat (x**(p−2)); inv(0) = 0.  CUDA tensors
        of a field the pairing kernels are built for run the whole chain
        in one launch (kernels.fq_inv, whose program is recorded from
        inv_chain); every other tensor runs inv_chain."""
        if x.device.type == "cuda" and kernels.has_fq_inv(self):
            return kernels.fq_inv(self, x)
        return self.inv_chain(x)

    def inv_chain(self, x: Tensor) -> Tensor:
        """x**(p−2) product by product (pow_static over this field's
        mul): the JAX FieldSpec.inv's sequence."""
        return self.pow_static(x, self.p - 2)

    def sqrt_candidate(self, x: Tensor) -> Tensor:
        """x**((p+1)/4) — a square root of x when one exists (p ≡ 3 mod 4).
        Callers must check sq(result) == x."""
        if self.p % 4 != 3:
            raise ValueError("sqrt_candidate needs p ≡ 3 mod 4")
        return self.pow_static(x, (self.p + 1) // 4)

    # -- canonicalization / predicates --------------------------------------
    #
    # The canonical form of a value mod p is unique, so it is computed on
    # int64 words of several limbs each (7 words for BLS12-381) instead of
    # limb by limb: the ripple carries then take 7 steps, not 39.  The
    # steps are those of the JAX package's strict — two carry-and-fold
    # rounds of the overflow past bit b·n, a final carry, then the
    # conditional-subtraction ladder of 2**k·p — on the same values.

    def _to_words(self, x: Tensor) -> Tensor:
        """(..., n) int32 limbs → (..., W) int64 words of the same value
        (word k = Σ_j limb[lpw·k + j]·2**(b·j))."""
        lpw, w = self._lpw, self._nwords
        x64 = torch.nn.functional.pad(x, (0, lpw * w - self.n)).to(torch.int64)
        x64 = x64.reshape(x.shape[:-1] + (w, lpw))
        return (x64 << self.const("word_shift", x.device)).sum(-1)

    def _word_carry(self, words: Tensor) -> Tuple[Tensor, Tensor]:
        """Exact ripple carry over the word axis (arithmetic shifts keep
        floor semantics for negative words).  Returns (canonical words,
        carry-out past bit b·n)."""
        c = torch.zeros(words.shape[:-1], dtype=torch.int64,
                        device=words.device)
        out = []
        for k, bits in enumerate(self._word_bits):
            t = words[..., k] + c
            c = t >> bits
            out.append(t & ((1 << bits) - 1))
        return torch.stack(out, -1), c

    def _strict_words(self, x: Tensor) -> Tensor:
        """Canonical value of loose x mod p as int64 words."""
        w = self._to_words(x)
        over = self.const("word_over", x.device)  # 2**(b·n) mod p
        for _ in range(2):
            w, c = self._word_carry(w)
            w = w + c[..., None] * over
        w, _ = self._word_carry(w)  # carry provably 0 here (≥2 slack bits)
        for k in self._ladder:
            d, borrow = self._word_carry(w - self.const(f"word_kp{k}",
                                                        x.device))
            w = torch.where((borrow == 0)[..., None], d, w)
        return w

    def strict(self, x: Tensor) -> Tensor:
        """Canonical strict digits of x mod p (each < 2**b, value < p).
        Input must be loose (limbs ≤ loose_max)."""
        w = self._strict_words(x)
        limbs = (w[..., None] >> self.const("word_shift", x.device)) & self.mask
        limbs = limbs.reshape(w.shape[:-1] + (-1,))[..., :self.n]
        return limbs.to(torch.int32)

    def is_zero(self, x: Tensor) -> Tensor:
        return torch.all(self._strict_words(x) == 0, dim=-1)

    def eq(self, x: Tensor, y: Tensor) -> Tensor:
        x, y = torch.broadcast_tensors(x, y)
        both = self._strict_words(torch.stack([x, y]))
        return torch.all(both[0] == both[1], dim=-1)

    def geq_const(self, x: Tensor, c: int) -> Tensor:
        """(x mod p) ≥ c, elementwise over the batch; c < 2**(b·n)."""
        cw = torch.as_tensor(self._words_of(c), device=x.device)
        _, borrow = self._word_carry(self._strict_words(x) - cw)
        return borrow == 0

    def _words_of(self, v: int) -> np.ndarray:
        out, shift = [], 0
        for bits in self._word_bits:
            out.append((v >> shift) & ((1 << bits) - 1))
            shift += bits
        return np.array(out, dtype=np.int64)

    def where(self, mask: Tensor, x: Tensor, y: Tensor) -> Tensor:
        """Select limb vectors by a batch-shaped boolean mask."""
        return torch.where(mask[..., None], x, y)

    # -- conversions ---------------------------------------------------------

    def one(self, device="cpu") -> Tensor:
        return self.const("one", device)

    def constant(self, v: int, device="cpu") -> Tensor:
        """The limbs of v mod p as an (n,) tensor on `device`, made once
        per device (the tower's Frobenius constants)."""
        key = (f"int{v % self.p}", torch.device(device))
        t = self._consts.get(key)
        if t is None:
            t = torch.as_tensor(self.from_int(v), device=key[1])
            self._consts[key] = t
        return t

    def zero(self, device="cpu") -> Tensor:
        return torch.zeros((self.n,), dtype=torch.int32, device=device)

    def from_int(self, v: int) -> np.ndarray:
        return np.array(_digits(v % self.p, self.b, self.n), dtype=np.int32)

    def from_ints(self, vs: Sequence[int]) -> np.ndarray:
        return np.stack([self.from_int(v) for v in vs])

    def to_ints(self, x: Tensor) -> List[int]:
        """Canonical integer values of a (..., n) limb tensor, flattened
        C-order (one device-to-host copy)."""
        return self.ints_from_strict(self.strict(x).cpu().numpy())

    def ints_from_strict(self, arr) -> List[int]:
        """Pure-numpy decode of already-canonical strict digits."""
        flat = np.asarray(arr, dtype=np.int64).reshape(-1, self.n)
        return [int(sum(int(d) << (self.b * i) for i, d in enumerate(row)))
                for row in flat]


class PlainField:
    """A FieldSpec whose mul/sq are always the plain PyTorch multiply —
    the field under the plain versions of the fused kernels
    (bls12381_groups.G1.add_plain/dbl_plain, the pairing tower), which
    must launch no kernel on any device.  Its exponentiations run its own
    multiply."""

    def __init__(self, spec: FieldSpec):
        self._spec = spec

    def __getattr__(self, name):
        return getattr(self._spec, name)

    def mul(self, x: Tensor, y: Tensor) -> Tensor:
        return self._spec.mul_plain(x, y)

    def sq(self, x: Tensor) -> Tensor:
        return self._spec.mul_plain(x, x)

    pow_static = FieldSpec.pow_static
    inv = inv_chain = FieldSpec.inv_chain


BLS12_381_P = int(
    "1a0111ea397fe69a4b1ba7b6434bacd764774b84f38512bf6730d2a0f6b0f624"
    "1eabfffeb153ffffb9feffffffffaaab", 16)

# The moduli of the other signature schemes (consensus_overlord_tpu/ops/
# field.py), each 26 limbs of 10 bits: Ed25519's, secp256k1's and SM2's.
ED25519_P = 2**255 - 19
SECP256K1_P = 2**256 - 2**32 - 977
SM2_P = int("fffffffeffffffffffffffffffffffffffffffff"
            "00000000ffffffffffffffff", 16)

BLS12_381_FQ = FieldSpec(BLS12_381_P, limb_bits=10, name="bls12381_fq")
# Named as the JAX package names them (ops/edwards.py FE, ops/
# weierstrass.py FQ_SECP and FQ_SM2): the kernels' builds go by name.
ED25519_FQ = FieldSpec(ED25519_P, limb_bits=10, name="F_ed25519")
SECP256K1_FQ = FieldSpec(SECP256K1_P, limb_bits=10, name="secp256k1_fq")
SM2_FQ = FieldSpec(SM2_P, limb_bits=10, name="sm2_fq")
