"""CudaBlsCrypto: the device-batched BLS12-381 provider on an NVIDIA GPU.

The counterpart of consensus_overlord_tpu/crypto/tpu_provider.py's
verify slice.  ``verify_batch`` checks N (signature, hash, voter) triples
with one random-linear-combination relation

    e(Σ r_i·S_i, −g2) · Π_g e(H_g, Σ_{i∈g} r_i·P_i) == 1

with 64-bit random weights r_i.  The O(N) part — G1 decompression with a
per-lane subgroup check, the G1 MSM, the pubkey-row gather and the
validity-masked G2 MSM(s) — runs on the card (``verify_round`` /
``verify_round_multi``); the pairing runs on the host native backend.  A
failed relation falls back to per-signature checks, so verdicts are
exact.  ``update_pubkeys`` validates public keys on the card
(``g2_validate``) into a pubkey cache that stays on the device.

Nothing here hides the device: on a machine without a GPU, a provider
asked for "cuda" raises; a kernel that fails to build or launch raises.
Batches below ``device_threshold`` go to the host oracle, as in the JAX
package.
"""

from __future__ import annotations

import secrets
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.sm3 import sm3_hash
from ..ops import bls12381_groups as dev
from ..ops.curve import Point
from . import bls12381 as oracle
from .provider import CpuBlsCrypto

# Batches pad to the next rung, as in the JAX package.
_PAD_SIZES = (8, 32, 128, 512, 1024, 2048, 4096, 8192)
# Random-linear-combination weight width (blst's batch width).
_SCALAR_BITS = 64
# Pubkey-cache device capacity ladder (rows).
_PK_CAPS = (256, 1024, 4096, 16384)
# Fused multi-hash group-count ladder; more hashes split into
# single-hash sub-batches.
_GROUP_SIZES = (2, 3, 4)

#: −G2 generator, the fixed G2 point of the signature pair.
_NEG_G2_ORACLE = (oracle.G2_GEN[0], oracle.fq2_neg(oracle.G2_GEN[1]))


def _pad_to(n: int) -> int:
    for s in _PAD_SIZES:
        if n <= s:
            return s
    return -(-n // _PAD_SIZES[-1]) * _PAD_SIZES[-1]


def _pk_capacity(n: int) -> int:
    for s in _PK_CAPS:
        if n <= s:
            return s
    return -(-n // _PK_CAPS[-1]) * _PK_CAPS[-1]


# ---------------------------------------------------------------------------
# Device steps (tensors in, tensors out; every tensor on one device).
# ---------------------------------------------------------------------------

def verify_round(x, sign, inf, ok, wpacked, rows, pkx, pky, pkz):
    """One single-hash verification round on the device: weight unpack,
    G1 decompress + validate + per-lane subgroup check, the G1 MSM
    Σ r_i·S_i, the pubkey-cache gather, and the G2 MSM Σ r_i·P_i with
    weights masked by the device-computed validity.  Returns strict
    affine coords of both aggregates plus the per-lane validity:
    (ax, ay, ainf, valid, gx, gy, ginf)."""
    bits = dev.unpack_weight_bits(wpacked)
    pt, valid = dev.g1_validate_batch(x, sign, inf, ok)
    agg = dev.G1.msm_bits(pt, bits)
    ax, ay, ainf = dev.G1.to_affine(agg)
    vbits = bits * valid[..., None].to(bits.dtype)
    gagg = dev.G2.msm_bits(dev.gather_rows(rows, pkx, pky, pkz), vbits)
    gx, gy, ginf = dev.G2.to_affine(gagg)
    return (dev.FQ.strict(ax[0]), dev.FQ.strict(ay[0]), ainf[0], valid,
            dev.FQ.strict(gx[0]), dev.FQ.strict(gy[0]), ginf[0])


def verify_round_multi(x, sign, inf, ok, wpacked, rows, gmask,
                       pkx, pky, pkz):
    """k-hash verification round: one G1 MSM over all lanes plus one G2
    MSM per hash group (weights masked by validity AND the host-computed
    group membership `gmask` (k, B)).  The k G2 MSMs run as one ladder
    over (B, k) lanes — each group's lanes see exactly the ops of its own
    MSM.  Returns the G1 aggregate, the validity, then (gx, gy, ginf) per
    group."""
    bits = dev.unpack_weight_bits(wpacked)
    pt, valid = dev.g1_validate_batch(x, sign, inf, ok)
    agg = dev.G1.msm_bits(pt, bits)
    ax, ay, ainf = dev.G1.to_affine(agg)
    outs = [dev.FQ.strict(ax[0]), dev.FQ.strict(ay[0]), ainf[0], valid]
    k = gmask.shape[0]
    pk = dev.gather_rows(rows, pkx, pky, pkz)
    pk = Point(*(c[:, None].expand(c.shape[0], k, *c.shape[1:]) for c in pk))
    vbits = bits[:, None] * (valid[:, None] & gmask.t())[..., None].to(
        bits.dtype)  # (B, k, nbits)
    gx, gy, ginf = dev.G2.to_affine(dev.G2.msm_bits(pk, vbits))
    for g in range(k):
        outs += [dev.FQ.strict(gx[0, g]), dev.FQ.strict(gy[0, g]),
                 ginf[0, g]]
    return tuple(outs)


def g2_validate(x, sign, inf, ok):
    """Decompress + subgroup-check a batch of G2 public keys.  Returns
    projective coords + validity (what fills the pubkey cache)."""
    pt, valid = dev.g2_decompress_device(x, sign, inf, ok)
    valid = valid & ~inf & dev.g2_in_subgroup(pt)
    return pt.x, pt.y, pt.z, valid


def _affine_to_oracle_g1(ax, ay, ainf) -> Optional[Tuple[int, int]]:
    if bool(ainf):
        return None
    (xv,) = dev.FQ.ints_from_strict(ax)
    (yv,) = dev.FQ.ints_from_strict(ay)
    return (xv, yv)


def _affine_to_oracle_g2(ax, ay, ainf):
    if bool(ainf):
        return None
    return (tuple(dev.FQ.ints_from_strict(ax)),
            tuple(dev.FQ.ints_from_strict(ay)))


# ---------------------------------------------------------------------------
# The pubkey cache.
# ---------------------------------------------------------------------------

class PubkeyCache:
    """Validated public keys as stacked limb rows: voter bytes → row in
    (px, py, pz) (each (rows, 2, n) int32), or −1 for a key known bad;
    `aff` holds each row's oracle affine point (None for bad rows) for
    the exact per-lane fallback.  Host- and device-validated rows enter
    through the same `append`, so batch gathers see them identically."""

    def __init__(self):
        self.px = np.zeros((0, 2, dev.FQ.n), np.int32)
        self.py = np.zeros((0, 2, dev.FQ.n), np.int32)
        self.pz = np.zeros((0, 2, dev.FQ.n), np.int32)
        self.index: Dict[bytes, int] = {}
        self.aff: List[Optional[tuple]] = []

    def append(self, voters: Sequence[bytes], px, py, pz, aff: Sequence,
               valid) -> None:
        base = self.px.shape[0]
        self.px = np.concatenate([self.px, px], axis=0)
        self.py = np.concatenate([self.py, py], axis=0)
        self.pz = np.concatenate([self.pz, pz], axis=0)
        self.aff.extend(aff)
        for i, v in enumerate(voters):
            self.index[bytes(v)] = base + i if valid[i] else -1


class CudaBlsCrypto:
    """CryptoProvider (reference Overlord `Crypto` trait surface,
    src/consensus.rs:385-463) with device-batched vote verification.

    device: where the batched paths run ("cuda" by default; "cpu" runs
    every kernel's plain PyTorch version, for tests).
    device_threshold: batches smaller than this verify on the host oracle,
    and smaller pubkey sets validate there."""

    def __init__(self, private_key: int, common_ref: bytes = b"",
                 device_threshold: int = 32, device="cuda"):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("CudaBlsCrypto: device 'cuda' was asked for "
                               "but torch.cuda.is_available() is False")
        self._cpu = CpuBlsCrypto(private_key, common_ref)
        self._common_ref = common_ref
        self._threshold = device_threshold
        # Guards the cache and its device copy: a reconfigure may race a
        # verify that is gathering rows.
        self._pk_lock = threading.RLock()
        self._pk = PubkeyCache()
        # Device copy of the cache, padded to the capacity ladder;
        # uploaded once per reconfigure, so per batch only row indices
        # travel to the card.
        self._pk_dev: Optional[Tuple[torch.Tensor, ...]] = None

    # -- provider surface ----------------------------------------------------

    @property
    def pub_key(self) -> bytes:
        return self._cpu.pub_key

    def hash(self, data: bytes) -> bytes:
        return sm3_hash(data)

    def sign(self, hash32: bytes) -> bytes:
        return self._cpu.sign(hash32)

    def verify_signature(self, signature: bytes, hash32: bytes,
                         voter: bytes) -> bool:
        return self._cpu.verify_signature(signature, hash32, voter)

    def _to_dev(self, arr: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(arr).to(self.device, non_blocking=True)

    # -- batched verification ------------------------------------------------

    def verify_batch(self, signatures: Sequence[bytes],
                     hashes: Sequence[bytes],
                     voters: Sequence[bytes]) -> List[bool]:
        """Exact batched verification of (sig_i, hash_i, voter_i) triples."""
        return self.verify_batch_async(signatures, hashes, voters)()

    def verify_batch_async(self, signatures: Sequence[bytes],
                           hashes: Sequence[bytes],
                           voters: Sequence[bytes]):
        """Enqueue the device work now and return a zero-argument
        `resolve()` that reads the result back and finishes on the host
        (pairing, and the per-lane fallback of a failed relation).
        Single-hash and ≤4-hash batches are one device round; more hashes
        split into single-hash sub-batches enqueued back to back."""
        n = len(signatures)
        if len(hashes) != n or len(voters) != n:
            raise ValueError("signatures, hashes and voters differ in length")
        if n == 0:
            return lambda: []
        if n < self._threshold:
            return lambda: [self._cpu.verify_signature(s, h, v)
                            for s, h, v in zip(signatures, hashes, voters)]
        groups: Dict[bytes, List[int]] = {}
        for i, h in enumerate(hashes):
            groups.setdefault(bytes(h), []).append(i)
        if len(groups) == 1:
            return self._dispatch_single_hash(signatures, bytes(hashes[0]),
                                              voters, n)
        if len(groups) <= _GROUP_SIZES[-1]:
            return self._dispatch_multi_hash(signatures, voters, n, groups)
        resolvers = []
        for h, idxs in groups.items():
            resolvers.append((idxs, self.verify_batch_async(
                [signatures[i] for i in idxs], [h] * len(idxs),
                [voters[i] for i in idxs])))

        def resolve_split() -> List[bool]:
            results = [False] * n
            for idxs, r in resolvers:
                for i, ok in zip(idxs, r()):
                    results[i] = ok
            return results

        return resolve_split

    def _host_prep(self, signatures, voters, n):
        """Host-side prep shared by every batch path: parse + pad the
        signatures, resolve (validating on first sight) pubkey rows, draw
        packed 64-bit weights.  Returns (size, x, sign, inf, ok, wpacked,
        rows, pk_ok) with the first seven as device tensors."""
        pk_idx = self._pk_rows_of(voters)
        pk_ok = pk_idx >= 0
        size = _pad_to(n)
        parsed = dev.parse_g1_compressed(list(signatures))
        sx = np.zeros((size, dev.FQ.n), np.int32)
        sx[:n] = parsed.x
        ssign = np.zeros(size, bool)
        ssign[:n] = parsed.sign
        sinf = np.zeros(size, bool)
        sinf[:n] = parsed.infinity
        sok = np.zeros(size, bool)
        sok[:n] = parsed.wellformed & pk_ok  # bad-pubkey lanes are disabled
        # Random 64-bit weights, packed big-endian, top bit forced so each
        # is nonzero; padding lanes get weight 0.
        wpacked = np.zeros((size, _SCALAR_BITS // 8), np.uint8)
        wpacked[:n] = np.frombuffer(
            secrets.token_bytes(n * _SCALAR_BITS // 8),
            np.uint8).reshape(n, _SCALAR_BITS // 8)
        wpacked[:n, 0] |= 0x80
        rows = np.zeros(size, np.int64)
        rows[:n] = np.maximum(pk_idx, 0)  # bad-key lanes: sok=False
        ins = tuple(self._to_dev(a) for a in
                    (sx, ssign, sinf, sok, wpacked, rows))
        return (size,) + ins + (pk_ok,)

    def _dispatch_single_hash(self, signatures, h, voters, n):
        (_, sx, ssign, sinf, sok, wpacked, rows,
         pk_ok) = self._host_prep(signatures, voters, n)
        out = verify_round(sx, ssign, sinf, sok, wpacked, rows,
                           *self._pk_device())

        def resolve() -> List[bool]:
            ax, ay, ainf, valid, gx, gy, ginf = (t.cpu().numpy()
                                                 for t in out)
            v = valid[:n] & pk_ok
            if not v.any():
                return [False] * n
            agg_sig = _affine_to_oracle_g1(ax, ay, ainf)
            agg_pk = _affine_to_oracle_g2(gx, gy, ginf)
            h_pt = oracle.hash_to_g1(h, self._common_ref)
            if oracle.multi_pairing_is_one([(agg_sig, _NEG_G2_ORACLE),
                                            (h_pt, agg_pk)]):
                return [bool(b) for b in v]
            # Batch relation failed: exact per-lane localization.
            return [bool(v[i]) and self._verify_one_cached(
                        signatures[i], h, voters[i]) for i in range(n)]

        return resolve

    def _dispatch_multi_hash(self, signatures, voters, n,
                             groups: Dict[bytes, List[int]]):
        (size, sx, ssign, sinf, sok, wpacked, rows,
         pk_ok) = self._host_prep(signatures, voters, n)
        k = next(s for s in _GROUP_SIZES if len(groups) <= s)
        gmask = np.zeros((k, size), bool)
        ghashes = list(groups)
        for g, h in enumerate(ghashes):
            gmask[g, groups[h]] = True
        out = verify_round_multi(sx, ssign, sinf, sok, wpacked, rows,
                                 self._to_dev(gmask), *self._pk_device())
        lane_hashes = [b""] * n
        for h, idxs in groups.items():
            for i in idxs:
                lane_hashes[i] = h

        def resolve() -> List[bool]:
            flat = [t.cpu().numpy() for t in out]
            v = flat[3][:n] & pk_ok
            if not v.any():
                return [False] * n
            pairs = [(_affine_to_oracle_g1(*flat[:3]), _NEG_G2_ORACLE)]
            for g, h in enumerate(ghashes):
                agg_pk = _affine_to_oracle_g2(*flat[4 + 3 * g: 7 + 3 * g])
                if agg_pk is None:
                    continue  # no valid lane voted on this hash
                pairs.append((oracle.hash_to_g1(h, self._common_ref),
                              agg_pk))
            if oracle.multi_pairing_is_one(pairs):
                return [bool(b) for b in v]
            return [bool(v[i]) and self._verify_one_cached(
                        signatures[i], lane_hashes[i], voters[i])
                    for i in range(n)]

        return resolve

    def _verify_one_cached(self, sig: bytes, hash32: bytes,
                           voter: bytes) -> bool:
        """One lane on the host oracle against its cached pubkey."""
        row = self._pk.index.get(bytes(voter), -1)
        if row < 0:
            return False
        try:
            sig_pt = oracle.g1_decompress(sig)
        except ValueError:
            return False
        if sig_pt is None or not oracle.g1_in_subgroup(sig_pt):
            return False
        h = oracle.hash_to_g1(hash32, self._common_ref)
        return oracle.multi_pairing_is_one([(sig_pt, _NEG_G2_ORACLE),
                                            (h, self._pk.aff[row])])

    # -- pubkey cache --------------------------------------------------------

    def update_pubkeys(self, voters: Sequence[bytes]) -> None:
        """Validate and cache a validator set's public keys (the analog of
        the reference's pubkey cache refresh on reconfigure,
        src/consensus.rs:131-136, 622-629); a bad key is cached as bad."""
        voters = [bytes(v) for v in voters]
        with self._pk_lock:
            fresh = list(dict.fromkeys(v for v in voters
                                       if v not in self._pk.index))
            if not fresh:
                return
            if len(fresh) < self._threshold:
                self._update_pubkeys_host(fresh)
                return
            n = len(fresh)
            size = _pad_to(n)
            parsed = dev.parse_g2_compressed(fresh)
            x = np.zeros((size, 2, dev.FQ.n), np.int32)
            x[:n] = parsed.x
            sgn = np.zeros(size, bool)
            sgn[:n] = parsed.sign
            inf = np.zeros(size, bool)
            inf[:n] = parsed.infinity
            ok = np.zeros(size, bool)
            ok[:n] = parsed.wellformed
            px, py, pz, valid = g2_validate(*(self._to_dev(a) for a in
                                              (x, sgn, inf, ok)))
            px, py, pz = px[:n], py[:n], pz[:n]
            aff = dev.g2_to_oracle(Point(px, py, pz))
            valid = valid[:n].cpu().numpy()
            aff = [a if ok_ else None for a, ok_ in zip(aff, valid)]
            self._pk.append(fresh, px.cpu().numpy(), py.cpu().numpy(),
                            pz.cpu().numpy(), aff, valid)
            self._pk_dev = None  # the device copy is stale

    def _update_pubkeys_host(self, voters: List[bytes]) -> None:
        """Host-oracle twin of the device validation: decompress +
        subgroup-check each key on the CPU and cache its limb-encoded
        affine form (z = 1)."""
        n = len(voters)
        px = np.zeros((n, 2, dev.FQ.n), np.int32)
        py = np.zeros((n, 2, dev.FQ.n), np.int32)
        pz = np.zeros((n, 2, dev.FQ.n), np.int32)
        aff: List[Optional[tuple]] = []
        valid = np.zeros(n, bool)
        for i, v in enumerate(voters):
            try:
                pt = oracle.g2_decompress(v)
            except ValueError:
                pt = None
            if pt is None or not oracle.g2_in_subgroup(pt):
                aff.append(None)
                continue
            px[i] = dev.FQ2.from_ints([pt[0]])[0]
            py[i] = dev.FQ2.from_ints([pt[1]])[0]
            pz[i] = dev.FQ2.from_ints([(1, 0)])[0]
            valid[i] = True
            aff.append(pt)
        self._pk.append(voters, px, py, pz, aff, valid)
        self._pk_dev = None

    def load_pubkey_cache(self, cache: PubkeyCache) -> None:
        """Adopt a whole pubkey cache (convert.pubkey_cache_from_jax)."""
        with self._pk_lock:
            self._pk = cache
            self._pk_dev = None

    def _pk_device(self) -> Tuple[torch.Tensor, ...]:
        """The device copy of the cache, padded to the capacity ladder."""
        with self._pk_lock:
            if self._pk_dev is None:
                cap = _pk_capacity(max(self._pk.px.shape[0], 1))
                pad = [(0, cap - self._pk.px.shape[0]), (0, 0), (0, 0)]
                self._pk_dev = tuple(self._to_dev(np.pad(a, pad)) for a in
                                     (self._pk.px, self._pk.py, self._pk.pz))
            return self._pk_dev

    def _pk_rows_of(self, voters: Sequence[bytes]) -> np.ndarray:
        """Cache rows of the voters (validating unseen keys); bad = −1."""
        with self._pk_lock:
            missing = [v for v in voters if bytes(v) not in self._pk.index]
            if missing:
                self.update_pubkeys(missing)
            return np.fromiter((self._pk.index[bytes(v)] for v in voters),
                               np.int64, len(voters))
