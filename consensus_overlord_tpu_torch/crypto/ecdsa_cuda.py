"""secp256k1 ECDSA and SM2 signature verification on an NVIDIA GPU.

The counterpart of consensus_overlord_tpu/crypto/ecdsa_tpu.py.  Each
lane is checked on its own, exactly (no random linear combination):

  ECDSA:  R = (e/s)·G + (r/s)·Q,  accept iff R ≠ ∞ and R.x ≡ r (mod n)
  SM2:    R = s·G + t·Q, t = r+s, accept iff R ≠ ∞ and (e + R.x) ≡ r (mod n)

Both are one dual-scalar multiplication u1·G + u2·Q (ops/weierstrass.py
``dual_scalar_mul_bits``) and an inversion-free x test: x1 ≡ c (mod n)
for projective (X : Y : Z) holds iff X == ĉ·Z for a lift ĉ ∈ {c, c + n}
∩ [0, p).  ``verify_lanes`` is the port of the JAX jit
``_verify_kernel(curve)``: on the card secp256k1's add and doubling run
csrc/g1_point.cu built for its field, SM2's add csrc/wp_point.cu, and
the products of the x test the fq_mul kernel of the curve's field.

Scheme rules, as in the JAX package: secp256k1 verification enforces
low-s (s ≤ (n−1)/2) and ``sign`` emits low-s; SM2 signs the 32-byte
hash directly (e = int(hash32)) and refuses r + s ≡ 0.  Signing is on
the host with deterministic nonces (``_det_nonce``).  QCs are
concatenated signatures verified through ``verify_batch``, so above the
threshold they reach the card too.

Unlike the JAX providers, a device error raises to the caller: nothing
re-verifies on the host because the card or a kernel failed, and a
provider asked for "cuda" on a machine without a GPU raises from its
constructor, which also builds and loads the kernels.
"""

from __future__ import annotations

import threading
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.sm3 import sm3_hash
from ..ops import kernels
from ..ops import weierstrass as w
from ..ops.curve import int_to_bits_msb_np
from .cuda_provider import _ISSUE, _pad_to
from .provider import CryptoError

_SCALAR_BITS = 256


# ---------------------------------------------------------------------------
# Host-side curve math (Python ints): signing and the single-verify oracle.
# ---------------------------------------------------------------------------

class HostCurve:
    """Short-Weierstrass arithmetic over Python ints: the signing path and
    the per-lane oracle.  The affine `add` keeps the textbook form; `mul`
    and `mul_add` run in Jacobian coordinates with one final inversion,
    and multiples of the base point come from a table of d·16^j·G."""

    def __init__(self, p: int, a: int, b: int, n: int, gx: int, gy: int):
        self.p, self.a, self.b, self.n = p, a, b, n
        self.g = (gx, gy)
        assert p % 4 == 3  # sqrt by (p+1)/4 on both curves
        self._g_table: List[List[tuple]] = []

    def add(self, p1: Optional[Tuple[int, int]],
            p2: Optional[Tuple[int, int]]) -> Optional[Tuple[int, int]]:
        if p1 is None:
            return p2
        if p2 is None:
            return p1
        P = self.p
        (x1, y1), (x2, y2) = p1, p2
        if x1 == x2:
            if (y1 + y2) % P == 0:
                return None
            lam = (3 * x1 * x1 + self.a) * pow(2 * y1, P - 2, P) % P
        else:
            lam = (y2 - y1) * pow(x2 - x1, P - 2, P) % P
        x3 = (lam * lam - x1 - x2) % P
        return (x3, (lam * (x1 - x3) - y1) % P)

    # -- Jacobian internals (X/Z², Y/Z³); None = infinity -------------------

    def _jdbl(self, pt):
        if pt is None:
            return None
        P = self.p
        x, y, z = pt
        if y == 0:
            return None
        ysq = y * y % P
        s = 4 * x * ysq % P
        m = (3 * x * x + self.a * pow(z, 4, P)) % P
        x3 = (m * m - 2 * s) % P
        return (x3, (m * (s - x3) - 8 * ysq * ysq) % P, 2 * y * z % P)

    def _jadd(self, p1, p2):
        if p1 is None:
            return p2
        if p2 is None:
            return p1
        P = self.p
        x1, y1, z1 = p1
        x2, y2, z2 = p2
        z1s, z2s = z1 * z1 % P, z2 * z2 % P
        u1, u2 = x1 * z2s % P, x2 * z1s % P
        s1, s2 = y1 * z2s * z2 % P, y2 * z1s * z1 % P
        if u1 == u2:
            if s1 != s2:
                return None
            return self._jdbl(p1)
        h = (u2 - u1) % P
        r = (s2 - s1) % P
        hs = h * h % P
        hc = hs * h % P
        u1hs = u1 * hs % P
        x3 = (r * r - hc - 2 * u1hs) % P
        return (x3, (r * (u1hs - x3) - s1 * hc) % P, h * z1 % P * z2 % P)

    def _jaffine(self, pt) -> Optional[Tuple[int, int]]:
        if pt is None:
            return None
        P = self.p
        x, y, z = pt
        zi = pow(z, -1, P)
        zis = zi * zi % P
        return (x * zis % P, y * zis * zi % P)

    def _base_mul(self, k: int):
        """[k]·G (Jacobian) from the table of d·16^j·G, built on first
        use: one add per nonzero base-16 digit."""
        if not self._g_table:
            q = (self.g[0], self.g[1], 1)
            for _ in range(64):
                row = [q]
                for _ in range(14):
                    row.append(self._jadd(row[-1], q))
                self._g_table.append(row)
                q = self._jadd(row[-1], q)  # 16·q
        acc = None
        for j in range(64):
            d = (k >> (4 * j)) & 15
            if d:
                acc = self._jadd(acc, self._g_table[j][d - 1])
        return acc

    def mul(self, k: int, pt: Optional[Tuple[int, int]]
            ) -> Optional[Tuple[int, int]]:
        if pt is None:
            return None
        k %= self.n
        if pt == self.g:
            return self._jaffine(self._base_mul(k))
        acc = None
        j = (pt[0], pt[1], 1)
        for bit in bin(k)[2:] if k else "":
            acc = self._jdbl(acc)
            if bit == "1":
                acc = self._jadd(acc, j)
        return self._jaffine(acc)

    def mul_add(self, u1: int, u2: int, q: Tuple[int, int]
                ) -> Optional[Tuple[int, int]]:
        """u1·G + u2·Q with one interleaved Jacobian ladder (Shamir)."""
        u1 %= self.n
        u2 %= self.n
        jg = (self.g[0], self.g[1], 1)
        jq = (q[0], q[1], 1)
        jgq = self._jadd(jg, jq)
        acc = None
        for i in range(max(u1.bit_length(), u2.bit_length()) - 1, -1, -1):
            acc = self._jdbl(acc)
            sel = ((u1 >> i) & 1) | (((u2 >> i) & 1) << 1)
            if sel:
                acc = self._jadd(acc, (jg, jq, jgq)[sel - 1])
        return self._jaffine(acc)

    def on_curve(self, x: int, y: int) -> bool:
        return (y * y - (x * x * x + self.a * x + self.b)) % self.p == 0

    def compress(self, pt: Tuple[int, int]) -> bytes:
        x, y = pt
        return bytes([2 | (y & 1)]) + x.to_bytes(32, "big")

    def decompress(self, blob: bytes) -> Optional[Tuple[int, int]]:
        """SEC1 compressed point → affine; None if malformed or off the
        curve."""
        if len(blob) != 33 or blob[0] not in (2, 3):
            return None
        x = int.from_bytes(blob[1:], "big")
        if x >= self.p:
            return None
        rhs = (x * x * x + self.a * x + self.b) % self.p
        y = pow(rhs, (self.p + 1) // 4, self.p)
        if y * y % self.p != rhs:
            return None
        if y & 1 != blob[0] & 1:
            y = self.p - y
        return (x, y)


SECP_HOST = HostCurve(w.SECP256K1_P, 0, w.SECP256K1_B, w.SECP256K1_N,
                      w.SECP256K1_GX, w.SECP256K1_GY)
SM2_HOST = HostCurve(w.SM2_P, w.SM2_A, w.SM2_B, w.SM2_N,
                     w.SM2_GX, w.SM2_GY)


def _det_nonce(sk: int, e: int, n: int, retry: int = 0) -> int:
    """Deterministic nonce: k = SM3(sk ‖ e ‖ retry ‖ ctr) mod n, the
    first nonzero one (RFC 6979-shaped).  `retry` is the signer's
    degenerate-r/s retry index and `ctr` absorbs zero draws, each in its
    own hash-input field, so no nonce is reused across messages."""
    ctr = 0
    while True:
        k = int.from_bytes(
            sm3_hash(sk.to_bytes(32, "big") + (e % 2**256).to_bytes(32, "big")
                     + retry.to_bytes(4, "big") + ctr.to_bytes(4, "big")),
            "big") % n
        if k:
            return k
        ctr += 1


# ---------------------------------------------------------------------------
# The device step.
# ---------------------------------------------------------------------------

_CURVES = {"secp256k1": (w.SECP, SECP_HOST), "sm2": (w.SM2, SM2_HOST)}


def verify_lanes(curve_name: str, qx, qy, valid, u1_bits, u2_bits, c1, c2):
    """Per-lane verify: R = u1·G + u2·Q; a lane passes iff it is valid,
    R ≠ ∞ and R.X == c·R.Z for one of its two x-lifts.  qx, qy, c1, c2
    (B, n) int32; valid (B,) bool; u1_bits, u2_bits (B, 256) MSB-first.
    An invalid lane's bits are zeroed first, so its garbage coordinates
    never enter the ladder.  The port of the JAX jit
    _verify_kernel(curve)."""
    ops, host = _CURVES[curve_name]
    f = ops.f
    dev = qx.device
    g = ops.from_affine(f.constant(host.g[0], dev)[None],
                        f.constant(host.g[1], dev)[None])
    q = ops.from_affine(qx, qy)
    u1_bits = u1_bits * valid[:, None]
    u2_bits = u2_bits * valid[:, None]
    r = w.dual_scalar_mul_bits(ops, g, u1_bits, q, u2_bits)
    not_inf = ~f.is_zero(r.z)
    cz = f.mul(torch.stack([c1, c2]), r.z)
    hit = f.eq(r.x, cz[0]) | f.eq(r.x, cz[1])
    return valid & not_inf & hit


# ---------------------------------------------------------------------------
# Providers.
# ---------------------------------------------------------------------------

class EcdsaPubkeyCache(NamedTuple):
    """A provider's validated pubkeys: affine rows (rows, 26) int32 and
    voter bytes → row (−1: the key did not decompress)."""
    x: np.ndarray
    y: np.ndarray
    index: Dict[bytes, int]


class _EcdsaFamilyCrypto:
    """Shared provider shell: QCs are concatenated signatures (these
    schemes do not aggregate) and verify_batch runs on the card.

    device: where verify_batch runs ("cuda" by default; "cpu" runs the
    kernels' plain versions, for tests).  device_threshold: batches
    smaller than this verify on the host oracle."""

    SIG_LEN = 64  # r ‖ s, 32 bytes each, big-endian
    curve_name = ""
    host: HostCurve

    def __init__(self, private_key: int, device_threshold: int = 64,
                 device="cuda"):
        host = self.host
        self._f = _CURVES[self.curve_name][0].f
        self.device = torch.device(device)
        if self.device.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError(f"{type(self).__name__}: device 'cuda' "
                                   "was asked for but "
                                   "torch.cuda.is_available() is False")
            if self.device.index is None:
                self.device = torch.device("cuda",
                                           torch.cuda.current_device())
            kernels.load_all(self.device, self._f)
        self._sk = private_key % host.n
        if self._sk == 0:
            raise CryptoError("zero private key")
        self._pk_pt = host.mul(self._sk, host.g)
        self._pk = host.compress(self._pk_pt)
        self._threshold = device_threshold
        # Voter bytes → row of the decompressed key (−1: invalid), and
        # the rows as limbs.  _pk_lock guards the read-check-append of
        # the cache: the frontier runs verify_batch calls from several
        # threads.
        self._pk_index: Dict[bytes, int] = {}
        self._pk_lock = threading.Lock()
        f = self._f
        self._pk_x = np.zeros((0, f.n), np.int32)
        self._pk_y = np.zeros((0, f.n), np.int32)
        #: verify_batch calls by where they ran (QC verifies included):
        #: "device" counts the batches issued, "host" those below the
        #: threshold.
        self.calls = {"verify_batch": {"device": 0, "host": 0}}
        self._calls_lock = threading.Lock()

    # -- provider surface ---------------------------------------------------

    @property
    def pub_key(self) -> bytes:
        return self._pk

    def hash(self, data: bytes) -> bytes:
        return sm3_hash(data)

    def verify_signature(self, signature: bytes, hash32: bytes,
                         voter: bytes) -> bool:
        pt = self.host.decompress(bytes(voter))
        if pt is None:
            return False
        return self._host_verify(bytes(signature), bytes(hash32), pt)

    def aggregate_signatures(self, signatures: Sequence[bytes],
                             voters: Sequence[bytes]) -> bytes:
        if len(signatures) != len(voters):
            raise CryptoError(
                f"signatures x voters length mismatch "
                f"{len(signatures)} x {len(voters)}")
        for sig in signatures:
            if len(sig) != self.SIG_LEN:
                raise CryptoError(f"bad {self.curve_name} signature length")
        return b"".join(bytes(s) for s in signatures)

    def verify_aggregated_signature(self, agg_sig: bytes, hash32: bytes,
                                    voters: Sequence[bytes]) -> bool:
        if not voters:
            return False
        if len(agg_sig) != self.SIG_LEN * len(voters):
            return False
        sigs = [agg_sig[i * self.SIG_LEN:(i + 1) * self.SIG_LEN]
                for i in range(len(voters))]
        return all(self.verify_batch(sigs, [hash32] * len(voters), voters))

    def degraded_status(self) -> dict:
        with self._calls_lock:
            return {"calls": {p: dict(c) for p, c in self.calls.items()}}

    def _count(self, where: str) -> None:
        with self._calls_lock:
            self.calls["verify_batch"][where] += 1

    # -- batched verification ------------------------------------------------

    def verify_batch(self, signatures: Sequence[bytes],
                     hashes: Sequence[bytes],
                     voters: Sequence[bytes]) -> List[bool]:
        n = len(signatures)
        if len(hashes) != n or len(voters) != n:
            raise ValueError("signatures, hashes and voters differ in "
                             "length")
        if n == 0:
            return []
        if n < self._threshold:
            self._count("host")
            return [self.verify_signature(s, h, v)
                    for s, h, v in zip(signatures, hashes, voters)]
        f = self._f
        rows = self._pk_rows_of(voters)
        valid = np.zeros(n, bool)
        u1, u2, c1, c2 = [0] * n, [0] * n, [0] * n, [0] * n
        for i in range(n):
            if rows[i] < 0:
                continue
            parsed = self._scalars_of(bytes(signatures[i]), bytes(hashes[i]))
            if parsed is None:
                continue
            u1[i], u2[i], c1[i], c2[i] = parsed
            valid[i] = True
        if not valid.any():
            return [False] * n

        size = _pad_to(n)
        pad_rows = np.zeros(size, np.int64)
        pad_rows[:n] = np.maximum(rows, 0)
        vmask = np.zeros(size, bool)
        vmask[:n] = valid

        def bits_of(vals):
            out = np.zeros((size, _SCALAR_BITS), np.uint8)
            out[:n] = int_to_bits_msb_np(vals, _SCALAR_BITS)
            return out

        def limbs_of(vals):
            out = np.zeros((size, f.n), np.int32)
            out[:n] = f.from_ints(vals)
            return out

        host_in = (self._pk_x[pad_rows], self._pk_y[pad_rows], vmask,
                   bits_of(u1), bits_of(u2), limbs_of(c1), limbs_of(c2))
        self._count("device")
        with _ISSUE:
            ok = verify_lanes(self.curve_name, *(
                torch.as_tensor(a).to(self.device) for a in host_in))
            ok = ok.cpu().numpy()
        return [bool(v) for v in ok[:n]]

    # -- scheme internals ----------------------------------------------------

    def _scalars_of(self, sig: bytes, hash32: bytes
                    ) -> Optional[Tuple[int, int, int, int]]:
        """(u1, u2, c1, c2) of one lane, or None if the signature is
        structurally invalid.  c1, c2 are the x-lifts (c2 == c1 when
        c + n ≥ p)."""
        raise NotImplementedError

    def _host_verify(self, sig: bytes, hash32: bytes,
                     q: Tuple[int, int]) -> bool:
        parsed = self._scalars_of(sig, hash32)
        if parsed is None:
            return False
        u1, u2, cand1, cand2 = parsed
        r_pt = self.host.mul_add(u1, u2, q)
        if r_pt is None:
            return False
        return r_pt[0] in (cand1, cand2)

    def _split_sig(self, sig: bytes) -> Optional[Tuple[int, int]]:
        if len(sig) != self.SIG_LEN:
            return None
        r = int.from_bytes(sig[:32], "big")
        s = int.from_bytes(sig[32:], "big")
        if not (1 <= r < self.host.n and 1 <= s < self.host.n):
            return None
        return r, s

    def _x_lifts(self, c: int) -> Tuple[int, int]:
        lift2 = c + self.host.n
        return c, (lift2 if lift2 < self.host.p else c)

    # -- pubkey cache --------------------------------------------------------

    def load_pubkey_cache(self, cache: EcdsaPubkeyCache) -> None:
        """Replace the pubkey cache (convert.ecdsa_pubkeys_from_jax makes
        one from a JAX provider's)."""
        with self._pk_lock:
            self._pk_x, self._pk_y = cache.x, cache.y
            self._pk_index = dict(cache.index)

    def _pk_rows_of(self, voters: Sequence[bytes]) -> np.ndarray:
        f = self._f
        with self._pk_lock:
            missing, seen = [], set()
            for v in voters:
                vb = bytes(v)
                if vb not in self._pk_index and vb not in seen:
                    seen.add(vb)
                    missing.append(vb)
            if missing:
                base = self._pk_x.shape[0]
                xs, ys = [], []
                for j, vb in enumerate(missing):
                    pt = self.host.decompress(vb)
                    if pt is None:
                        self._pk_index[vb] = -1
                        xs.append(np.zeros(f.n, np.int32))
                        ys.append(np.zeros(f.n, np.int32))
                    else:
                        self._pk_index[vb] = base + j
                        xs.append(f.from_int(pt[0]))
                        ys.append(f.from_int(pt[1]))
                self._pk_x = np.concatenate([self._pk_x, np.stack(xs)])
                self._pk_y = np.concatenate([self._pk_y, np.stack(ys)])
            return np.fromiter((self._pk_index[bytes(v)] for v in voters),
                               np.int64, len(voters))


class Secp256k1Crypto(_EcdsaFamilyCrypto):
    """secp256k1 ECDSA over 32-byte hashes, low-s enforced both ways."""

    curve_name = "secp256k1"
    host = SECP_HOST

    def sign(self, hash32: bytes) -> bytes:
        host = self.host
        e = int.from_bytes(hash32, "big") % host.n
        for retry in range(2**31):
            k = _det_nonce(self._sk, e, host.n, retry)
            r = host.mul(k, host.g)[0] % host.n
            s = (e + r * self._sk) * pow(k, -1, host.n) % host.n
            if r and s:
                if 2 * s > host.n:
                    s = host.n - s  # low-s normal form
                return r.to_bytes(32, "big") + s.to_bytes(32, "big")
        raise CryptoError("nonce derivation failed")  # unreachable

    def _scalars_of(self, sig, hash32):
        host = self.host
        rs = self._split_sig(sig)
        if rs is None:
            return None
        r, s = rs
        if 2 * s > host.n:
            return None  # low-s rule: one valid encoding per signature
        e = int.from_bytes(hash32, "big") % host.n
        w_inv = pow(s, -1, host.n)  # n is prime: s^(n−2)
        return (e * w_inv % host.n, r * w_inv % host.n) + self._x_lifts(r)


class Sm2Crypto(_EcdsaFamilyCrypto):
    """SM2 (GB/T 32918.2) over 32-byte hashes; e = int(hash32) directly
    (no Z_A digest: consensus vote hashes are SM3 digests already)."""

    curve_name = "sm2"
    host = SM2_HOST

    def sign(self, hash32: bytes) -> bytes:
        host = self.host
        e = int.from_bytes(hash32, "big")
        inv_1sk = pow(1 + self._sk, -1, host.n)
        for retry in range(2**31):
            k = _det_nonce(self._sk, e, host.n, retry)
            x1 = host.mul(k, host.g)[0]
            r = (e + x1) % host.n
            if r == 0 or r + k == host.n:
                continue
            s = inv_1sk * (k - r * self._sk) % host.n
            if s == 0:
                continue
            return r.to_bytes(32, "big") + s.to_bytes(32, "big")
        raise CryptoError("nonce derivation failed")  # unreachable

    def _scalars_of(self, sig, hash32):
        host = self.host
        rs = self._split_sig(sig)
        if rs is None:
            return None
        r, s = rs
        t = (r + s) % host.n
        if t == 0:
            return None
        e = int.from_bytes(hash32, "big")
        # accept iff (e + x1) ≡ r (mod n)  ⇔  x1 ≡ r − e (mod n)
        return (s, t) + self._x_lifts((r - e) % host.n)
