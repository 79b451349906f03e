"""Ed25519CudaCrypto: Ed25519 batch verification on an NVIDIA GPU.

The counterpart of consensus_overlord_tpu/crypto/ed25519_tpu.py.  The
RFC 8032 batch relation with 128-bit random weights z_i,

    [8] ( [Σ z_i s_i mod L]·B  −  Σ [z_i]·R_i  −  Σ [z_i h_i mod L]·A_i )
        == identity,       h_i = SHA512(R_i ‖ A_i ‖ M_i) mod L,

is one MSM over 2N + 2 lanes (the negated R and A lanes, the base point
and an identity pad) on the card: ``decompress_lanes`` (the JAX jit
``_ed_decompress``) on the fq_mul kernel built for 2^255 − 19, and
``msm_is_identity`` (the JAX jit ``_ed_msm_is_identity``) on the ed_add
kernel (csrc/ed_point.cu).  A failed relation localizes exactly: each
valid lane is checked on the host.

Every path applies the same *cofactored* acceptance rule: the batch
relation, the per-lane localization, the below-threshold host path and
the QC path (the inherited ``verify_aggregated_signature``, which checks
each signature with ``verify_signature``) all use ops/edwards.py
``host_verify_cofactored`` or its batched form.  Two honest nodes must
never split on one vote because they verified it at different batch
sizes.

Keys and signatures come from ops/edwards.py ``host_pub_key`` and
``host_sign`` (byte-equal to the JAX provider's), so this provider needs
no ``cryptography`` package.  Unlike the JAX provider, a device error
raises to the caller: nothing re-verifies on the host because the card
or a kernel failed, and a provider asked for "cuda" on a machine
without a GPU raises from its constructor, which also builds and loads
the kernels.
"""

from __future__ import annotations

import hashlib
import secrets
import threading
from typing import List, Sequence

import numpy as np
import torch

from ..ops import edwards as ed
from ..ops import kernels
from .cuda_provider import _ISSUE, _pad_to
from .provider import Ed25519Crypto

_Z_BITS = 128
_SCALAR_BITS = 256


def decompress_lanes(y: torch.Tensor, sign: torch.Tensor,
                     ok: torch.Tensor):
    """Batched decompression of wellformed-flagged encodings: (point,
    valid & ok).  The port of the JAX jit _ed_decompress."""
    pt, valid = ed.decompress(y, sign)
    return pt, valid & ok


def msm_is_identity(pts: ed.EdPoint, bits: torch.Tensor) -> torch.Tensor:
    """[8]·Σ bits_i·P_i == identity over the lanes (a 0-d bool tensor).
    The port of the JAX jit _ed_msm_is_identity."""
    acc = ed.tree_sum(ed.scalar_mul_bits(pts, bits))
    return ed.is_identity(ed.mul8(acc))[0]


class Ed25519CudaCrypto(Ed25519Crypto):
    """Ed25519 provider whose verify_batch runs on the card.

    device: where the batch relation runs ("cuda" by default; "cpu" runs
    the kernels' plain versions, for tests).
    device_threshold: batches smaller than this verify on the host.
    rng: the source of the relation's 128-bit weights (an object with
    getrandbits, e.g. a seeded random.Random); None uses `secrets`."""

    def __init__(self, seed32: bytes, device_threshold: int = 64,
                 device="cuda", rng=None):
        self.device = torch.device(device)
        if self.device.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError("Ed25519CudaCrypto: device 'cuda' was "
                                   "asked for but torch.cuda.is_available() "
                                   "is False")
            if self.device.index is None:
                self.device = torch.device("cuda",
                                           torch.cuda.current_device())
            kernels.load_all(self.device, ed.FE)
        self._seed = bytes(seed32)
        self._pk = ed.host_pub_key(self._seed)
        self._threshold = device_threshold
        self._rng = rng
        #: verify_batch calls by where they ran: "device" counts the
        #: batch relations issued, "host" the calls below the threshold.
        self.calls = {"verify_batch": {"device": 0, "host": 0}}
        self._calls_lock = threading.Lock()

    def sign(self, hash32: bytes) -> bytes:
        return ed.host_sign(self._seed, hash32)

    def verify_signature(self, signature: bytes, hash32: bytes,
                         voter: bytes) -> bool:
        """One signature under the batch relation's cofactored rule."""
        try:
            return ed.host_verify_cofactored(bytes(signature), bytes(hash32),
                                             bytes(voter))
        except Exception:  # noqa: BLE001 — malformed input is just False
            return False

    def degraded_status(self) -> dict:
        with self._calls_lock:
            return {"calls": {p: dict(c) for p, c in self.calls.items()}}

    def _count(self, where: str) -> None:
        with self._calls_lock:
            self.calls["verify_batch"][where] += 1

    def _weight(self) -> int:
        z = (self._rng.getrandbits(_Z_BITS) if self._rng is not None
             else secrets.randbits(_Z_BITS))
        return z | (1 << (_Z_BITS - 1))

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

        # Host parse: R = sig[:32], s = sig[32:] (< L), A = the voter;
        # h_i = SHA512(R ‖ A ‖ M) mod L.
        r_blobs, s_vals, h_vals = [], [0] * n, [0] * n
        s_ok = np.zeros(n, bool)
        for i, (sig, msg, pk) in enumerate(zip(signatures, hashes, voters)):
            sig, pk = bytes(sig), bytes(pk)
            s = int.from_bytes(sig[32:], "little")
            if len(sig) != 64 or len(pk) != 32 or s >= ed.L:
                r_blobs.append(b"\x00" * 32)
                continue
            r_blobs.append(sig[:32])
            s_vals[i] = s
            dig = hashlib.sha512(sig[:32] + pk + bytes(msg)).digest()
            h_vals[i] = int.from_bytes(dig, "little") % ed.L
            s_ok[i] = True
        pr = ed.parse_points(r_blobs)
        pa = ed.parse_points([bytes(v) for v in voters])

        # R lanes then A lanes, each padded to the rung: one
        # decompression over both.
        size = _pad_to(n)
        y = np.zeros((2 * size, ed.FE.n), np.int32)
        sign = np.zeros(2 * size, bool)
        ok = np.zeros(2 * size, bool)
        for k, parsed in enumerate((pr, pa)):
            y[k * size:k * size + n] = parsed.y
            sign[k * size:k * size + n] = parsed.sign
            ok[k * size:k * size + n] = parsed.wellformed
        self._count("device")
        dev = self.device
        with _ISSUE:
            pts, dvalid = decompress_lanes(
                torch.as_tensor(y).to(dev), torch.as_tensor(sign).to(dev),
                torch.as_tensor(ok).to(dev))
            dvalid = dvalid.cpu().numpy()
        valid = dvalid[:n] & dvalid[size:size + n] & s_ok
        if not valid.any():
            return [False] * n

        # Random weights; invalid lanes weigh 0 and drop out of c.
        z_vals = [self._weight() if valid[i] else 0 for i in range(n)]
        c = sum(z * s for z, s in zip(z_vals, s_vals)) % ed.L
        za_vals = [z * h % ed.L for z, h in zip(z_vals, h_vals)]
        # Lanes: [−R_0 ..], [−A_0 ..], [B], [identity]; 256-bit scalars.
        # An invalid lane's garbage point never enters the sum: its bits
        # are 0, so the ladder never adds it.
        bits = np.zeros((2 * size + 2, _SCALAR_BITS), np.uint8)
        bits[:n] = ed.int_to_bits_msb(z_vals, _SCALAR_BITS)
        bits[size:size + n] = ed.int_to_bits_msb(za_vals, _SCALAR_BITS)
        bits[2 * size] = ed.int_to_bits_msb([c], _SCALAR_BITS)[0]
        with _ISSUE:
            neg = ed.neg(pts)
            tail = ed.EdPoint(*(torch.cat([b, i]) for b, i in zip(
                ed.base_point(1, dev),
                ed.identity_like(torch.zeros((1, ed.FE.n), dtype=torch.int32,
                                             device=dev)))))
            lanes = ed.EdPoint(*(torch.cat([a, b]) for a, b in zip(neg,
                                                                  tail)))
            ok_all = bool(msm_is_identity(lanes, torch.as_tensor(bits).to(
                dev)))
        if ok_all:
            return [bool(v) for v in valid]
        # Localize: each valid lane on the host, under the same rule.
        return [bool(valid[i]) and self.verify_signature(
                    signatures[i], hashes[i], voters[i])
                for i in range(n)]

