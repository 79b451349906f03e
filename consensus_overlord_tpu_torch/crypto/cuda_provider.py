"""CudaBlsCrypto: the device-batched BLS12-381 provider on an NVIDIA GPU.

The counterpart of consensus_overlord_tpu/crypto/tpu_provider.py on one
card.  ``verify_batch`` checks N (signature, hash, voter) triples with
one random-linear-combination relation

    e(Σ r_i·S_i, −g2) · Π_g e(H_g, Σ_{i∈g} r_i·P_i) == 1

with 64-bit random weights r_i.  The O(N) part — G1 decompression with a
per-lane subgroup check, the G1 MSM, the pubkey-row gather and the
validity-masked G2 MSM(s) — runs on the card (``verify_round`` /
``verify_round_multi``), and so does the pairing verdict
(ops/pairing.py ``multi_pairing_is_one_staged``: the Miller product and
one final exponentiation), enqueued right behind the round, so a batch
reads back only the validity bitmap and one verdict bool.  With device
pairing off (``device_pairing=False``, or ``CONSENSUS_DEVICE_PAIRING=0``)
the aggregates are read back and paired on the host native backend.  A
failed relation falls back to per-signature checks on the host oracle,
so verdicts are exact.  ``update_pubkeys`` validates public keys on the
card (``g2_validate``) into a pubkey cache that stays on the device.

The QC paths (reference src/consensus.rs:418-462) run on the card too:
``aggregate_signatures`` decompresses and tree-sums the signatures
(``g1_validate_sum``), and ``verify_aggregated_signature`` tree-sums the
voters' cached pubkey rows (``g2_sum_rows``) with the 2-pair device
verdict enqueued right behind the sum.  Both have ``*_async`` forms that
dispatch now and return a blocking ``resolve()``.

Degraded mode, as in the JAX package: every device path asks a circuit
breaker (crypto/breaker.py) before it dispatches and reports its outcome.
A chaos fault raised in Python — ``breaker.inject_faults``, a kernel set
whose step raises ``InjectedDeviceFault``, ``inject_device_loss``, or an
``inject_dcn_stall`` that holds a readback past the watchdog's deadline
(``dispatch_deadline_s``) — is logged, counted in ``breaker.status()``
(and in bound metrics), and re-verified on the host oracle with exact
verdicts; a failed device pairing also counts in
``pairing_host_fallbacks``.  An open breaker routes work to the host
until a half-open probe succeeds.  Nothing of this hides the card or a
kernel: any other exception of a device step, launch or readback (a
CUDA runtime error, a real watchdog timeout) propagates to the caller
and never reaches the breaker; a provider asked for "cuda" on a machine
without a GPU raises; and on "cuda" the constructor builds and loads
every kernel library, so a failed build raises from the constructor.
Batches below ``device_threshold`` (QC work below
``qc_device_threshold``) go to the host oracle, as in the JAX package.
"""

from __future__ import annotations

import functools
import logging
import os
import secrets
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.sm3 import sm3_hash
from ..obs.prof import NULL_CALL, annotate, device_name
from ..ops import bls12381_groups as dev
from ..ops import kernels
from ..ops import pairing as pairing_ops
from ..ops.curve import Point
from . import bls12381 as oracle
from .breaker import (CircuitBreaker, DeviceLossError, DispatchTimeout,
                      InjectedDeviceFault)
from .provider import CpuBlsCrypto, CryptoError

# Batches pad to the next rung, as in the JAX package.
_PAD_SIZES = (8, 32, 128, 512, 1024, 2048, 4096, 8192)
# Random-linear-combination weight width (blst's batch width).
_SCALAR_BITS = 64
# Pubkey-cache device capacity ladder (rows).
_PK_CAPS = (256, 1024, 4096, 16384)
# Fused multi-hash group-count ladder; more hashes split into
# single-hash sub-batches.
_GROUP_SIZES = (2, 3, 4)

#: Uploads larger than this go through pinned memory (_to_dev).  CUDA
#: stages a copy from pageable memory up to some size at once; a larger
#: one waits for the work already on the stream.  On an H100 80GB HBM3
#: behind 200 ms of queued work a pageable copy of 1.25 MB (the 8192-lane
#: signature limbs, the main path's largest upload) returned at once and
#: one of 10 MB waited, while pinning first cost 1.99 ms against 0.34 at
#: 1.25 MB and 0.18 against 0.08 at 20 KB (chip_smoke.py pinned_upload,
#: which fails if an upload at or below this size waits).
_PAGEABLE_MAX_BYTES = 8192 * 39 * 4

# Device multi-pairing pad ladder: a flush pairs the signature aggregate
# with k ≤ 4 hash groups; padded pairs are masked to one.
_PAIR_SIZES = (2, 5)

#: −G2 generator, the fixed G2 point of every relation's signature pair:
#: as the host oracle's point and as limbs for the device pairing.
_NEG_G2_ORACLE = (oracle.G2_GEN[0], oracle.fq2_neg(oracle.G2_GEN[1]))
_NEG_G2_GEN_X = dev.FQ2.from_ints([_NEG_G2_ORACLE[0]])[0]
_NEG_G2_GEN_Y = dev.FQ2.from_ints([_NEG_G2_ORACLE[1]])[0]

logger = logging.getLogger(__name__)

#: One thread at a time issues device work in this process.  Every torch
#: call drops and retakes the GIL, so providers issuing from many threads
#: at once (a fleet: one frontier dispatcher per node) hand the GIL to
#: each other on every op and each op waits out a switch interval.
#: Waiters sleep on this lock instead.  Readbacks run outside it.  Taken
#: before a provider's _pk_lock, never after it.
_ISSUE = threading.RLock()


def _issuing(fn):
    """Run a method that issues device work under _ISSUE."""
    @functools.wraps(fn)
    def run(*args, **kwargs):
        with _ISSUE:
            return fn(*args, **kwargs)
    return run


def _pad_to(n: int) -> int:
    # CONSENSUS_PAD_MIN pins the bottom of the pad ladder: every batch
    # pads to at least this rung (one set of launch shapes per
    # deployment), as in the JAX package.
    floor = int(os.environ.get("CONSENSUS_PAD_MIN", "0"))
    for s in _PAD_SIZES:
        if n <= s and floor <= s:
            return s
    return -(-max(n, floor) // _PAD_SIZES[-1]) * _PAD_SIZES[-1]


def _pk_capacity(n: int) -> int:
    # CONSENSUS_PK_CAP_MIN pins the bottom of the pubkey-cache capacity
    # ladder, the same economics as CONSENSUS_PAD_MIN.
    n = max(n, int(os.environ.get("CONSENSUS_PK_CAP_MIN", "0")))
    for s in _PK_CAPS:
        if n <= s:
            return s
    return -(-n // _PK_CAPS[-1]) * _PK_CAPS[-1]


def _injected(exc: BaseException) -> bool:
    """Whether a device-path exception is a chaos fault raised in Python
    (breaker.inject_faults, a kernel set whose step raises
    InjectedDeviceFault, an injected lane loss, or a readback held past
    the deadline by an injected stall): the only failures degraded mode
    re-verifies on the host.  Anything else (a launch or CUDA runtime
    error, a failed readback, a real watchdog timeout) is a fault of the
    device or a kernel, and propagates to the caller."""
    if isinstance(exc, (InjectedDeviceFault, DeviceLossError)):
        return True
    return isinstance(exc, DispatchTimeout) and getattr(exc, "injected",
                                                        False)


def _readback(out):
    """A device tensor, or a tuple of them, as numpy arrays on the host:
    the blocking end of a dispatch, which every device path runs through
    CudaBlsCrypto._watched."""
    if isinstance(out, torch.Tensor):
        return out.cpu().numpy()
    return tuple(t.cpu().numpy() for t in out)


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


def g1_validate_sum(x, sign, inf, ok):
    """Decompress a batch of G1 signatures and tree-sum them (the QC
    signature aggregate, reference src/consensus.rs:418-444).  No
    subgroup check, matching the oracle aggregate path; invalid and
    infinity lanes become the identity before the sum.  Returns the
    strict affine sum and the per-lane validity: (ax, ay, ainf, valid)."""
    pt, valid = dev.g1_decompress_device(x, sign, inf, ok)
    agg = dev.G1.tree_sum(
        dev.G1.select(valid & ~inf, pt, dev.G1.infinity_like(x)))
    ax, ay, ainf = dev.G1.to_affine(agg)
    return dev.FQ.strict(ax[0]), dev.FQ.strict(ay[0]), ainf[0], valid


def g2_sum_rows(rows, mask, pkx, pky, pkz):
    """Σ P_i over cached pubkey rows (the QC pubkey aggregate, reference
    src/consensus.rs:365-383), padding lanes masked to the identity.
    Returns the strict affine sum (ax, ay, ainf)."""
    pk = dev.gather_rows(rows, pkx, pky, pkz)
    pk = dev.G2.select(mask, pk, dev.G2.infinity_like(pk.x))
    ax, ay, ainf = dev.G2.to_affine(dev.G2.tree_sum(pk))
    return dev.FQ.strict(ax[0]), dev.FQ.strict(ay[0]), ainf[0]


class _SingleChipKernels:
    """The device steps above, as the provider's default kernel set: the
    provider calls every device step through ``self._kernels``, so a
    test can swap in a set whose steps fail, and a multi-card set can
    plug in at the same point.  `lanes` is the number of devices a batch
    is split over: one here."""

    verify_round = staticmethod(verify_round)
    verify_round_multi = staticmethod(verify_round_multi)
    g2_validate = staticmethod(g2_validate)
    g1_validate_sum = staticmethod(g1_validate_sum)
    g2_sum_rows = staticmethod(g2_sum_rows)
    multi_pairing = staticmethod(pairing_ops.multi_pairing_is_one_staged)
    lanes = 1


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


def _g2_affine_strict(px, py, pz):
    """Strict affine coords (B, 2, n) and infinity flags of projective G2
    points, computed where the points are (the readback then decodes
    them with numpy alone)."""
    ax, ay, ainf = dev.G2.to_affine(Point(px, py, pz))
    return dev.FQ.strict(ax), dev.FQ.strict(ay), ainf


def _g2_oracle_points(ax, ay, ainf, valid) -> List[Optional[tuple]]:
    """Host decode of _g2_affine_strict's output: the oracle's affine
    points, None for invalid lanes and the identity."""
    xs, ys = dev.FQ.ints_from_strict(ax), dev.FQ.ints_from_strict(ay)
    return [((xs[2 * i], xs[2 * i + 1]), (ys[2 * i], ys[2 * i + 1]))
            if ok and not inf else None
            for i, (ok, inf) in enumerate(zip(valid, ainf))]


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
    src/consensus.rs:385-463) with device-batched vote verification and
    QC aggregation.

    device: where the batched paths run ("cuda" by default; "cpu" runs
    every kernel's plain PyTorch version, for tests).  On a CUDA device
    the constructor builds and loads every kernel library first, and a
    failed build raises from here.
    device_threshold: batches smaller than this verify on the host oracle.
    qc_device_threshold: the same for the QC paths (aggregate_signatures,
    verify_aggregated_signature) and pubkey validation; defaults to
    device_threshold.
    device_pairing: pair on the device (True) or on the host (False);
    None reads CONSENSUS_DEVICE_PAIRING: "auto" (the default) is on for
    a CUDA device and off on the CPU, "0"/"off"/"false" off, anything
    else on.  CONSENSUS_PAIRING_CROSSCHECK=1 also pairs every device
    verdict on the host and logs a mismatch as an error (counted in
    ``pairing_mismatches``); it costs the aggregates' readback.  A device
    pairing that fails with an injected fault is paired on the host
    instead, counted in ``pairing_host_fallbacks``.
    breaker: the device circuit breaker (crypto/breaker.py); the default
    trips after 3 consecutive device failures and probes every 5 s.
    dispatch_deadline_s: the watchdog's deadline for each blocking
    readback, scaled by the batch rung (_deadline_for); a readback that
    overruns raises DispatchTimeout — a breaker failure with an exact host
    re-verify when an injected stall held it, else the caller's error.
    None reads CONSENSUS_DISPATCH_DEADLINE_S; <= 0 (the
    default) turns the watchdog off."""

    def __init__(self, private_key: int, common_ref: bytes = b"",
                 device_threshold: int = 32, device="cuda",
                 device_pairing: Optional[bool] = None,
                 qc_device_threshold: Optional[int] = None,
                 breaker: Optional[CircuitBreaker] = None,
                 dispatch_deadline_s: Optional[float] = None):
        self.device = torch.device(device)
        if self.device.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError("CudaBlsCrypto: device 'cuda' was asked "
                                   "for but torch.cuda.is_available() is "
                                   "False")
            if self.device.index is None:
                self.device = torch.device("cuda",
                                           torch.cuda.current_device())
            kernels.load_all(self.device)
        if device_pairing is None:
            mode = os.environ.get("CONSENSUS_DEVICE_PAIRING", "auto")
            if mode == "auto":
                device_pairing = self.device.type == "cuda"
            else:
                device_pairing = mode not in ("0", "off", "false")
        self._pairing_on_device = bool(device_pairing)
        self._pairing_crosscheck = (
            os.environ.get("CONSENSUS_PAIRING_CROSSCHECK", "0") == "1")
        #: Crosscheck verdicts where the device and the host disagreed.
        self.pairing_mismatches = 0
        #: Host-oracle pairings taken where the device pairing was wanted
        #: but failed (dispatch or readback): 0 on the happy path.
        self.pairing_host_fallbacks = 0
        self._cpu = CpuBlsCrypto(private_key, common_ref)
        self._common_ref = common_ref
        self._threshold = device_threshold
        self._qc_threshold = (qc_device_threshold
                              if qc_device_threshold is not None
                              else device_threshold)
        self._kernels = _SingleChipKernels
        if dispatch_deadline_s is None:
            dispatch_deadline_s = float(os.environ.get(
                "CONSENSUS_DISPATCH_DEADLINE_S", "0"))
        #: Watchdog deadline base (see the class docstring); <= 0 = off.
        self._dispatch_deadline_s = float(dispatch_deadline_s)
        #: Chaos hook (dcn_stall): monotonic time until which every
        #: watched device call wedges.  0.0 = clear; clearing sets the
        #: event, which wakes every call wedged in the stall.
        self._dcn_stall_until = 0.0
        self._dcn_stall_cleared = threading.Event()
        #: Chaos hook (device_loss): {lane name: monotonic until}.
        self._inject_loss: dict = {}
        #: Device circuit breaker: consulted before every device
        #: dispatch, reported to after every resolve.  Open means
        #: degraded mode: exact results from the host oracle.
        self.breaker = breaker if breaker is not None else CircuitBreaker()
        #: Optional metric surface (the JAX package's obs.Metrics names)
        #: and device profiler (obs/prof.py DeviceProfiler); None keeps
        #: each site at one attribute check.
        self.metrics = None
        self.prof = None
        #: Calls of each batched path by where they ran: "device" counts
        #: the device dispatches issued, "host" the calls a threshold or
        #: an open breaker routed to the host oracle.
        self.calls = {path: {"device": 0, "host": 0}
                      for path in ("verify_batch", "aggregate",
                                   "verify_aggregated")}
        #: The same for update_pubkeys calls that had keys to validate.
        self.pubkey_updates = {"device": 0, "host": 0}
        self._calls_lock = threading.Lock()
        # Guards the cache and its device copy: a reconfigure may race a
        # verify that is gathering rows.
        self._pk_lock = threading.RLock()
        self._pk = PubkeyCache()
        # Device copy of the cache, padded to the capacity ladder;
        # uploaded once per reconfigure, so per batch only row indices
        # travel to the card.
        self._pk_dev: Optional[Tuple[torch.Tensor, ...]] = None

    # -- observability and the breaker ---------------------------------------

    def bind_metrics(self, metrics) -> None:
        """Attach a metric surface (an object with the JAX package's
        obs.Metrics attribute names), for the provider and its breaker."""
        self.metrics = metrics
        self.breaker.metrics = metrics

    def bind_profiler(self, prof) -> None:
        """Attach a device profiler (obs/prof.py DeviceProfiler): every
        device op then records a staged per-call profile."""
        self.prof = prof
        if prof is None:
            return
        try:
            prof.set_devices([self.device])
        except Exception:  # noqa: BLE001 — profiling never breaks crypto
            logger.warning("profiler set_devices failed", exc_info=True)

    def _prof_begin(self, op: str, n: int):
        """A StagedCall for one device op (the no-op twin when no
        profiler is bound)."""
        return self.prof.begin(op, n) if self.prof is not None \
            else NULL_CALL

    def degraded_status(self) -> dict:
        """Breaker and fallback state (the /statusz "crypto" section)."""
        doc = self.breaker.status()
        doc["device_pairing"] = self._pairing_on_device
        doc["pairing_host_fallbacks"] = self.pairing_host_fallbacks
        doc["g2_table_msm"] = False
        with self._calls_lock:
            doc["calls"] = {p: dict(c) for p, c in self.calls.items()}
            doc["pubkey_updates"] = dict(self.pubkey_updates)
        return doc

    def _count(self, path: str, where: str) -> None:
        with self._calls_lock:
            self.calls[path][where] += 1

    def _device_allowed(self, path: str) -> bool:
        """Ask the breaker; count the fallback when routed to the host."""
        if self.breaker.allow():
            return True
        if self.metrics is not None:
            self.metrics.host_fallbacks.labels(path=path).inc()
        return False

    def _device_failed(self, path: str, exc: BaseException) -> None:
        """One injected device dispatch/readback failure: feed the
        breaker, count it, log it; the caller then falls back to the host
        oracle.  Any other exception is re-raised here (see _injected)."""
        if not _injected(exc):
            raise exc
        logger.warning("device path %s failed (%s: %s); host fallback",
                       path, type(exc).__name__, exc)
        self.breaker.record_failure(f"{path}: {type(exc).__name__}")
        if self.metrics is not None:
            self.metrics.device_failures.labels(path=path).inc()
            self.metrics.host_fallbacks.labels(path=path).inc()

    def _device_succeeded(self) -> None:
        self.breaker.record_success()

    def _pairing_failed(self, exc: BaseException) -> None:
        """One injected device pairing dispatch/readback failure: feed the
        breaker and count the host-oracle pairing fallback (any other
        exception is re-raised)."""
        self._device_failed("pairing", exc)
        self.pairing_host_fallbacks += 1
        if self.metrics is not None:
            self.metrics.pairing_host_fallbacks.inc()

    #: crypto_dispatch_ms phase → crypto_device_stage_seconds stage.
    _STAGE_OF = {"prep": "parse"}

    def _observe_phase(self, phase: str, t0: float, call=NULL_CALL) -> float:
        """Observe one host-side device-path phase (ms histogram and the
        staged call's stage); returns a fresh timestamp."""
        now = time.perf_counter()
        if self.metrics is not None:
            self.metrics.crypto_dispatch_ms.labels(phase=phase).observe(
                (now - t0) * 1000.0)
        call.observe(self._STAGE_OF.get(phase, phase), now - t0)
        return now

    # -- watchdog and chaos hooks --------------------------------------------

    def inject_device_loss(self, lane: str, seconds: float) -> None:
        """Chaos hook (sim `device_loss`): for `seconds`, every watched
        device call on the lane named `lane` ("type:index", for example
        "cuda:0") raises DeviceLossError.  seconds <= 0 clears the
        lane."""
        name = str(lane)
        if seconds > 0:
            self._inject_loss[name] = time.monotonic() + float(seconds)
            logger.warning("device_loss armed: lane %s for %.2fs",
                           name, seconds)
        else:
            self._inject_loss.pop(name, None)

    def inject_dcn_stall(self, seconds: float) -> None:
        """Chaos hook (sim `dcn_stall`): for `seconds`, every watched
        device call wedges inside its readback window — the fault the
        watchdog converts to a DispatchTimeout within
        dispatch_deadline_s.  seconds <= 0 clears the window and wakes
        every call wedged in it; a call the watchdog already abandoned
        then ends without touching the device."""
        if seconds > 0:
            self._dcn_stall_cleared.clear()
            self._dcn_stall_until = time.monotonic() + float(seconds)
            logger.warning("dcn_stall armed for %.2fs", seconds)
        else:
            self._dcn_stall_until = 0.0
            self._dcn_stall_cleared.set()

    def _dcn_stall_remaining(self) -> float:
        until = self._dcn_stall_until
        if until <= 0.0:
            return 0.0
        remaining = until - time.monotonic()
        if remaining <= 0.0:
            self._dcn_stall_until = 0.0
            return 0.0
        return remaining

    def _raise_if_lost(self, path: str) -> None:
        """Raise DeviceLossError while an armed lane loss targets this
        provider's device (expired windows clear themselves)."""
        if not self._inject_loss:
            return
        now = time.monotonic()
        lane = device_name(self.device)
        for name, until in list(self._inject_loss.items()):
            if now >= until:
                self._inject_loss.pop(name, None)
            elif name == lane:
                raise DeviceLossError(
                    name, f"{path}: injected loss of lane {name}")

    def _deadline_for(self, size: int) -> Optional[float]:
        """Watchdog deadline for one blocking device call, scaled by the
        sqrt of the batch rung over the smallest rung (fixed launch costs
        dominate small rungs).  None = watchdog off."""
        base = self._dispatch_deadline_s
        if base <= 0:
            return None
        return base * max(1.0, (max(int(size), 1) / _PAD_SIZES[0]) ** 0.5)

    def _watched(self, fn, *args, size: int = 0, path: str = "dispatch"):
        """Run one blocking device call (a readback) under the dispatch
        watchdog.  Launches are asynchronous, so a wedged card surfaces
        at the readback — the chokepoint every device path funnels
        through.  Raises DeviceLossError while an injected lane loss
        targets this device and DispatchTimeout when the rung-scaled
        deadline expires; the timeout is marked `injected` when an armed
        dcn_stall held the call, and only then (and for the lane loss)
        does the caller's failure handling re-verify on the host.  With
        the watchdog off this is a plain call (plus the chaos stall,
        which then wedges for real).  The readback thread issues nothing
        of its own: every kernel runs on the default stream, so its copy
        orders after them."""
        self._raise_if_lost(path)
        deadline = self._deadline_for(size)
        stall = self._dcn_stall_remaining()
        cleared = self._dcn_stall_cleared
        if deadline is None:
            if stall > 0.0:
                cleared.wait(stall)
            return fn(*args)
        box: dict = {}
        done = threading.Event()
        abandoned = threading.Event()

        def work():
            try:
                if stall > 0.0:
                    cleared.wait(stall)  # the wedge the deadline cuts short
                    if abandoned.is_set():
                        return  # nobody reads it: leave the device alone
                box["result"] = fn(*args)
            # Not swallowed: re-raised on the caller's thread below
            # (unless the deadline fired first and took the failure path).
            except BaseException as e:  # noqa: BLE001
                box["error"] = e
            finally:
                done.set()

        # One daemon thread per watched call, not a pool: a wedged call
        # holds its thread until the device returns, and nothing joins
        # an abandoned one.
        t = threading.Thread(target=work, daemon=True,
                             name=f"dispatch-watchdog-{path}")
        t.start()
        if not done.wait(deadline):
            abandoned.set()
            exc = DispatchTimeout(
                f"{path}: device call exceeded dispatch deadline "
                f"{deadline:.2f}s (size={size})")
            exc.injected = stall > 0.0
            raise exc
        if "error" in box:
            raise box["error"]
        return box["result"]

    def _host_verify(self, signatures, hashes, voters) -> List[bool]:
        """Each lane on the host oracle: a voter whose key the cache holds
        (validated once, on reconfigure) verifies against its cached
        point, a key the cache knows bad verifies nothing, and any other
        voter goes through CpuBlsCrypto with its own key decompression
        and subgroup check.  The verdicts are CpuBlsCrypto's either way."""
        index = self._pk.index
        out = []
        for s, h, v in zip(signatures, hashes, voters):
            row = index.get(bytes(v))
            if row is None:
                out.append(self._cpu.verify_signature(s, h, v))
            else:
                out.append(row >= 0 and self._verify_one_cached(s, h, v))
        return out

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
        """Upload a host array without waiting for the card.  Above
        _PAGEABLE_MAX_BYTES it is first copied into pinned memory: a
        copy that large from pageable memory waits for the work already
        on the stream, which would block the issuing thread outside the
        watchdog (_watched).  The caching host allocator keeps the
        pinned block alive until the copy has run."""
        t = torch.as_tensor(arr)
        if (self.device.type == "cuda"
                and t.numel() * t.element_size() > _PAGEABLE_MAX_BYTES):
            t = t.pin_memory()
        return t.to(self.device, non_blocking=True)

    # -- QC paths ------------------------------------------------------------

    def aggregate_signatures(self, signatures: Sequence[bytes],
                             voters: Sequence[bytes]) -> bytes:
        return self.aggregate_signatures_async(signatures, voters)()

    def aggregate_signatures_async(self, signatures: Sequence[bytes],
                                   voters: Sequence[bytes]):
        """Dispatch the QC signature aggregation now; returns resolve()
        → compressed aggregate bytes (raises CryptoError on a bad
        lane)."""
        if len(signatures) != len(voters):
            raise CryptoError(
                f"signatures x voters length mismatch "
                f"{len(signatures)} x {len(voters)}")
        if (len(signatures) < self._qc_threshold
                or not self._device_allowed("aggregate")):
            self._count("aggregate", "host")
            return lambda: self._cpu.aggregate_signatures(signatures, voters)
        n = len(signatures)
        call = self._prof_begin("aggregate", n)
        with _ISSUE:
            try:
                self.breaker.raise_if_injected("aggregate")
                self._count("aggregate", "device")
                t0 = time.perf_counter()
                size = _pad_to(n)
                call.pad(n, size)
                parsed = dev.parse_g1_compressed(list(signatures))
                x = np.zeros((size, dev.FQ.n), np.int32)
                x[:n] = parsed.x
                sign_f = np.zeros(size, bool)
                sign_f[:n] = parsed.sign
                inf = np.zeros(size, bool)
                inf[:n] = parsed.infinity
                ok = np.zeros(size, bool)
                ok[:n] = parsed.wellformed
                call.observe("parse", time.perf_counter() - t0)
                t0 = time.perf_counter()
                with annotate("cuda_bls.aggregate.dispatch"):
                    out = self._kernels.g1_validate_sum(
                        *(self._to_dev(a) for a in (x, sign_f, inf, ok)))
                call.observe("dispatch", time.perf_counter() - t0)
            except Exception as e:  # noqa: BLE001 — see _injected
                call.finish(ok=False)
                self._device_failed("aggregate", e)
                return lambda: self._cpu.aggregate_signatures(
                    signatures, voters)

        def resolve() -> bytes:
            t0 = time.perf_counter()
            try:
                ax, ay, ainf, valid = self._watched(
                    _readback, out, size=size, path="aggregate")
            except Exception as e:  # noqa: BLE001 — see _injected
                call.finish(ok=False)
                self._device_failed("aggregate", e)
                return self._cpu.aggregate_signatures(signatures, voters)
            self._device_succeeded()
            call.observe("readback", time.perf_counter() - t0)
            if not bool(valid[:n].all()):
                call.finish(ok=False)  # the call raised — never ring ok
                raise CryptoError("invalid signature in aggregation batch")
            call.finish()
            return oracle.g1_compress(_affine_to_oracle_g1(ax, ay, ainf))

        return resolve

    def verify_aggregated_signature(self, agg_sig: bytes, hash32: bytes,
                                    voters: Sequence[bytes]) -> bool:
        return self.verify_aggregated_async(agg_sig, hash32, voters)()

    def verify_aggregated_async(self, agg_sig: bytes, hash32: bytes,
                                voters: Sequence[bytes]):
        """Dispatch the QC pubkey aggregation now (a tree sum of the
        voters' cached rows on the device), and with device pairing on
        the 2-pair verdict right behind it; returns resolve() → bool."""
        if (len(voters) < self._qc_threshold
                or not self._device_allowed("verify_aggregated")):
            self._count("verify_aggregated", "host")
            return lambda: self._cpu.verify_aggregated_signature(
                agg_sig, hash32, voters)
        call = self._prof_begin("verify_aggregated", len(voters))
        with _ISSUE:
            try:
                self.breaker.raise_if_injected("verify_aggregated")
                t0 = time.perf_counter()
                idx = self._pk_rows_of(voters)
                if (idx < 0).any():
                    # A QC over an unknown or bad key never verifies (no
                    # device dispatch happened).
                    call.observe("parse", time.perf_counter() - t0)
                    call.finish(ok=False)
                    return lambda: False
                n = len(voters)
                size = _pad_to(n)
                call.pad(n, size)
                rows = np.zeros(size, np.int64)
                rows[:n] = idx
                mask = np.zeros(size, bool)
                mask[:n] = True
                call.observe("parse", time.perf_counter() - t0)
                t0 = time.perf_counter()
                self._count("verify_aggregated", "device")
                pkx, pky, pkz = self._pk_device()
                with annotate("cuda_bls.verify_aggregated.dispatch"):
                    out = self._kernels.g2_sum_rows(
                        self._to_dev(rows), self._to_dev(mask), pkx, pky, pkz)
                call.observe("dispatch", time.perf_counter() - t0)
            except Exception as e:  # noqa: BLE001 — see _injected
                call.finish(ok=False)
                self._device_failed("verify_aggregated", e)
                return lambda: self._cpu.verify_aggregated_signature(
                    agg_sig, hash32, voters)

        # The verdict is enqueued right behind the pubkey sum: the
        # signature's decompression and the hash map are host work, so
        # the pairing is in flight before resolve() blocks.  An aggregate
        # at infinity skips its pair (q_inf), leaving e(sig, −g2) ≠ 1, so
        # the device verdict agrees with the host's "infinity → False".
        verdict_dev = None
        sig_pt = None
        if self._pairing_on_device:
            try:
                sig_pt = oracle.g1_decompress(agg_sig)
            except ValueError:
                sig_pt = None
            if sig_pt is not None and not oracle.g1_in_subgroup(sig_pt):
                sig_pt = None  # the rejection the host path applies
            if sig_pt is not None:
                h_pt = oracle.hash_to_g1(hash32, self._common_ref)
                verdict_dev = self._dispatch_pairing(
                    [(dev.FQ.from_int(sig_pt[0]),
                      dev.FQ.from_int(sig_pt[1]), False),
                     (*self._h_limbs(h_pt), False)],
                    [(_NEG_G2_GEN_X, _NEG_G2_GEN_Y, False),
                     (out[0], out[1], out[2])])

        def resolve() -> bool:
            t0 = time.perf_counter()
            use_dev = self._pairing_on_device
            agg = None
            try:
                if use_dev and not self._pairing_crosscheck:
                    # Only the infinity flag crosses; the aggregate stays
                    # on the device for the pairing.
                    ainf = bool(self._watched(_readback, out[2], size=size,
                                              path="verify_aggregated"))
                else:
                    agg = self._watched(_readback, out, size=size,
                                        path="verify_aggregated")
                    ainf = bool(agg[2])
            except Exception as e:  # noqa: BLE001 — see _injected
                call.finish(ok=False)
                self._device_failed("verify_aggregated", e)
                return self._cpu.verify_aggregated_signature(
                    agg_sig, hash32, voters)
            self._device_succeeded()
            call.observe("readback", time.perf_counter() - t0)
            t0 = time.perf_counter()
            try:
                if ainf:
                    return False
                if sig_pt is None and use_dev:
                    return False  # decompress/subgroup failed at dispatch
                if not use_dev:
                    try:
                        host_sig = oracle.g1_decompress(agg_sig)
                    except ValueError:
                        return False
                    if (host_sig is None
                            or not oracle.g1_in_subgroup(host_sig)):
                        return False
                else:
                    host_sig = sig_pt
                result = None
                if verdict_dev is not None:
                    try:
                        result = bool(self._watched(
                            _readback, verdict_dev,
                            path="verify_aggregated"))
                    except Exception as e:  # noqa: BLE001 — see _injected
                        self._pairing_failed(e)
                if result is None:
                    # The host-oracle pairing: device pairing off, or its
                    # dispatch or readback failed above.
                    if agg is None:
                        try:
                            agg = self._watched(_readback, out, size=size,
                                                path="verify_aggregated")
                        except Exception as e:  # noqa: BLE001 — _injected
                            self._device_failed("verify_aggregated", e)
                            return self._cpu.verify_aggregated_signature(
                                agg_sig, hash32, voters)
                    result = self._host_pairing_aggregated(host_sig, hash32,
                                                           agg)
                elif self._pairing_crosscheck:
                    host_r = self._host_pairing_aggregated(host_sig, hash32,
                                                           agg)
                    if host_r != result:
                        self.pairing_mismatches += 1
                        logger.error(
                            "device pairing verdict %s != host oracle %s "
                            "(verify_aggregated, %d voters)", result,
                            host_r, len(voters))
                # Observed only when a pairing ran: early rejections
                # above would flood the stage with near-zero samples.
                call.observe("pairing", time.perf_counter() - t0)
                return result
            except BaseException:
                call.finish(ok=False)  # a real device fault propagates
                raise
            finally:
                call.finish()

        return resolve

    def _host_pairing_aggregated(self, sig_pt, hash32, agg) -> bool:
        """e(sig, −g2)·e(H(m), Σ P_i) == 1 on the host oracle."""
        agg_pk = _affine_to_oracle_g2(*agg)
        if agg_pk is None:
            return False
        h = oracle.hash_to_g1(hash32, self._common_ref)
        return oracle.multi_pairing_is_one([(sig_pt, _NEG_G2_ORACLE),
                                            (h, agg_pk)])

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
        (the per-lane fallback of a failed relation; the pairing too when
        device pairing is off or failed).
        Single-hash and ≤4-hash batches are one device round; more hashes
        split into single-hash sub-batches enqueued back to back."""
        n = len(signatures)
        if len(hashes) != n or len(voters) != n:
            raise ValueError("signatures, hashes and voters differ in length")
        if n == 0:
            return lambda: []
        if n < self._threshold or not self._device_allowed("verify_batch"):
            self._count("verify_batch", "host")
            return lambda: self._host_verify(signatures, hashes, voters)
        groups: Dict[bytes, List[int]] = {}
        for i, h in enumerate(hashes):
            groups.setdefault(bytes(h), []).append(i)
        # Opened before any failure point, so the except below finishes
        # the real record; the split below never rings it (each
        # sub-batch profiles itself).
        call = self._prof_begin("verify_batch", n)
        try:
            self.breaker.raise_if_injected("verify_batch")
            if len(groups) == 1:
                return self._dispatch_single_hash(
                    signatures, bytes(hashes[0]), voters, n, call)
            if len(groups) <= _GROUP_SIZES[-1]:
                return self._dispatch_multi_hash(signatures, voters, n,
                                                 groups, call)
        except Exception as e:  # noqa: BLE001 — see _injected
            call.finish(ok=False)
            self._device_failed("verify_batch", e)
            return lambda: self._host_verify(signatures, hashes, voters)
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

    def _host_prep(self, signatures, voters, n, call=NULL_CALL):
        """Host-side prep shared by every batch path: parse + pad the
        signatures, resolve (validating on first sight) pubkey rows, draw
        packed 64-bit weights.  Returns (size, x, sign, inf, ok, wpacked,
        rows, pk_ok) with the first seven as device tensors."""
        pk_idx = self._pk_rows_of(voters)
        pk_ok = pk_idx >= 0
        size = _pad_to(n)
        call.pad(n, size)
        if self.metrics is not None:
            self.metrics.frontier_occupancy.observe(n / size)
            if size > n:
                self.metrics.frontier_padded_lanes.inc(size - n)
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

    @_issuing
    def _dispatch_pairing(self, g1s, g2s) -> Optional[torch.Tensor]:
        """Enqueue the device multi-pairing verdict over a flush's pairs.
        g1s: [(x, y, inf)] G1 strict limbs ((n,) each, a device tensor or
        a host array) and infinity flag; g2s: the matching Fq2 pairs
        ((2, n) limbs).  Pads to the _PAIR_SIZES ladder with infinity,
        masked pairs, and returns the verdict as a device bool — or None
        after feeding the breaker if an injected fault failed the
        dispatch, so callers pair on the host."""
        try:
            self.breaker.raise_if_injected("pairing")
            k = len(g1s)
            size = next((s for s in _PAIR_SIZES if k <= s), k)
            n = dev.FQ.n
            host = {"px": np.zeros((size, n), np.int32),
                    "py": np.zeros((size, n), np.int32),
                    "qx": np.zeros((size, 2, n), np.int32),
                    "qy": np.zeros((size, 2, n), np.int32),
                    "pinf": np.ones(size, bool), "qinf": np.ones(size, bool)}
            on_dev = []
            for i, (g1, g2) in enumerate(zip(g1s, g2s)):
                for keys, pt in ((("px", "py", "pinf"), g1),
                                 (("qx", "qy", "qinf"), g2)):
                    for key, v in zip(keys, pt):
                        if isinstance(v, torch.Tensor):
                            on_dev.append((key, i, v))
                        else:
                            host[key][i] = v
            t = {key: self._to_dev(a) for key, a in host.items()}
            for key, i, v in on_dev:
                t[key][i] = v
            mask = self._to_dev(np.arange(size) < k)
            with annotate("cuda_bls.pairing.dispatch"):
                return self._kernels.multi_pairing(
                    t["px"], t["py"], t["pinf"], t["qx"], t["qy"],
                    t["qinf"], mask)
        except Exception as e:  # noqa: BLE001 — see _injected
            self._pairing_failed(e)
            return None

    @staticmethod
    def _h_limbs(h_pt):
        """Oracle G1 point → (x, y) strict limb arrays for the pairing's
        hash-side pairs."""
        return dev.FQ.from_int(h_pt[0]), dev.FQ.from_int(h_pt[1])

    @_issuing
    def _dispatch_single_hash(self, signatures, h, voters, n, call):
        self._count("verify_batch", "device")
        t0 = time.perf_counter()
        (size, sx, ssign, sinf, sok, wpacked, rows,
         pk_ok) = self._host_prep(signatures, voters, n, call)
        t0 = self._observe_phase("prep", t0, call)
        with annotate("cuda_bls.verify_round.dispatch"):
            out = self._kernels.verify_round(sx, ssign, sinf, sok, wpacked,
                                             rows, *self._pk_device())
        self._observe_phase("dispatch", t0, call)
        h_pt = oracle.hash_to_g1(h, self._common_ref)
        verdict_dev = None
        if self._pairing_on_device:
            # The verdict is enqueued before resolve() runs; only the
            # validity bitmap and one bool cross to the host afterwards.
            verdict_dev = self._dispatch_pairing(
                [(out[0], out[1], out[2]), (*self._h_limbs(h_pt), False)],
                [(_NEG_G2_GEN_X, _NEG_G2_GEN_Y, False),
                 (out[4], out[5], out[6])])

        def host_pairing(flat) -> bool:
            ax, ay, ainf, _, gx, gy, ginf = flat
            return oracle.multi_pairing_is_one([
                (_affine_to_oracle_g1(ax, ay, ainf), _NEG_G2_ORACLE),
                (h_pt, _affine_to_oracle_g2(gx, gy, ginf))])

        return self._batch_resolver(
            out, verdict_dev, size, n, pk_ok, host_pairing, signatures,
            [h] * n, voters, f"single-hash batch n={n}", call)

    @_issuing
    def _dispatch_multi_hash(self, signatures, voters, n,
                             groups: Dict[bytes, List[int]], call):
        self._count("verify_batch", "device")
        t0 = time.perf_counter()
        (size, sx, ssign, sinf, sok, wpacked, rows,
         pk_ok) = self._host_prep(signatures, voters, n, call)
        k = next(s for s in _GROUP_SIZES if len(groups) <= s)
        gmask = np.zeros((k, size), bool)
        ghashes = list(groups)
        for g, h in enumerate(ghashes):
            gmask[g, groups[h]] = True
        t0 = self._observe_phase("prep", t0, call)
        with annotate("cuda_bls.verify_round_multi.dispatch"):
            out = self._kernels.verify_round_multi(
                sx, ssign, sinf, sok, wpacked, rows, self._to_dev(gmask),
                *self._pk_device())
        self._observe_phase("dispatch", t0, call)
        lane_hashes = [b""] * n
        for h, idxs in groups.items():
            for i in idxs:
                lane_hashes[i] = h
        h_pts = [oracle.hash_to_g1(h, self._common_ref) for h in ghashes]
        verdict_dev = None
        if self._pairing_on_device:
            # One pair per hash group and the signature pair.  A group
            # whose aggregate is at infinity (no valid lane voted on its
            # hash) is skipped by the q_inf mask, as the host path skips.
            g1s = [(out[0], out[1], out[2])]
            g2s = [(_NEG_G2_GEN_X, _NEG_G2_GEN_Y, False)]
            for g, h_pt in enumerate(h_pts):
                g1s.append((*self._h_limbs(h_pt), False))
                g2s.append(tuple(out[4 + 3 * g: 7 + 3 * g]))
            verdict_dev = self._dispatch_pairing(g1s, g2s)

        def host_pairing(flat) -> bool:
            pairs = [(_affine_to_oracle_g1(*flat[:3]), _NEG_G2_ORACLE)]
            for g, h_pt in enumerate(h_pts):
                agg_pk = _affine_to_oracle_g2(*flat[4 + 3 * g: 7 + 3 * g])
                if agg_pk is not None:  # else no valid lane voted on it
                    pairs.append((h_pt, agg_pk))
            return oracle.multi_pairing_is_one(pairs)

        return self._batch_resolver(
            out, verdict_dev, size, n, pk_ok, host_pairing, signatures,
            lane_hashes, voters, f"{len(ghashes)}-hash batch n={n}", call)

    def _batch_resolver(self, out, verdict_dev, size, n, pk_ok,
                        host_pairing, signatures, lane_hashes, voters,
                        what: str, call):
        """resolve() of a dispatched verify round: read back the validity
        bitmap (every output when the host pairs), take the device
        verdict or pair on the host, and localize a failed relation lane
        by lane.  A failed readback re-verifies every lane on the host; a
        failed verdict readback pairs the aggregates on the host."""

        def resolve() -> List[bool]:
            t0 = time.perf_counter()
            slim = verdict_dev is not None and not self._pairing_crosscheck
            flat = None
            try:
                if slim:
                    valid = self._watched(_readback, out[3], size=size,
                                          path="verify_batch")
                else:
                    flat = self._watched(_readback, out, size=size,
                                         path="verify_batch")
                    valid = flat[3]
            except Exception as e:  # noqa: BLE001 — see _injected
                call.finish(ok=False)
                self._device_failed("verify_batch", e)
                return self._host_verify(signatures, lane_hashes, voters)
            self._device_succeeded()
            t0 = self._observe_phase("readback", t0, call)
            try:
                v = valid[:n] & pk_ok
                if not v.any():
                    return [False] * n
                paired = None
                if verdict_dev is not None:
                    try:
                        paired = bool(self._watched(
                            _readback, verdict_dev, path="verify_batch"))
                        self._observe_phase("pairing", t0, call)
                    except Exception as e:  # noqa: BLE001 — see _injected
                        self._pairing_failed(e)
                if paired is None:
                    # The host-oracle pairing: the only path when device
                    # pairing is off, the exact fallback when it failed.
                    if flat is None:
                        try:
                            flat = self._watched(_readback, out, size=size,
                                                 path="verify_batch")
                        except Exception as e:  # noqa: BLE001 — _injected
                            self._device_failed("verify_batch", e)
                            return [bool(v[i]) and self._verify_one_cached(
                                        signatures[i], lane_hashes[i],
                                        voters[i]) for i in range(n)]
                    paired = host_pairing(flat)
                    self._observe_phase("pairing", t0, call)
                elif self._pairing_crosscheck:
                    host_p = host_pairing(flat)
                    if host_p != paired:
                        self.pairing_mismatches += 1
                        logger.error("device pairing verdict %s != host "
                                     "oracle %s (%s)", paired, host_p, what)
                if paired:
                    return [bool(b) for b in v]
                # Batch relation failed: exact per-lane localization.
                return [bool(v[i]) and self._verify_one_cached(
                            signatures[i], lane_hashes[i], voters[i])
                        for i in range(n)]
            except BaseException:
                call.finish(ok=False)  # a real device fault propagates
                raise
            finally:
                call.finish()

        return resolve

    def _verify_one_cached(self, sig: bytes, hash32: bytes,
                           voter: bytes) -> bool:
        """One lane on the host oracle against its cached pubkey."""
        pk = self._pk  # one snapshot: load_pubkey_cache swaps the object
        row = pk.index.get(bytes(voter), -1)
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
                                            (h, pk.aff[row])])

    # -- pubkey cache --------------------------------------------------------

    def update_pubkeys(self, voters: Sequence[bytes]) -> None:
        """Validate and cache a validator set's public keys (the analog of
        the reference's pubkey cache refresh on reconfigure,
        src/consensus.rs:131-136, 622-629); a bad key is cached as bad.
        Sets below qc_device_threshold, and every set while the breaker
        fences the device off, validate on the host; a device failure
        falls back to the host before anything is appended.  A set that
        is cached already returns without taking the issue lock: a
        service calls this on every reconfigure and commit, from its
        event loop."""
        voters = [bytes(v) for v in voters]
        index = self._pk.index
        if all(v in index for v in voters):
            return
        self._update_pubkeys(voters)

    @_issuing
    def _update_pubkeys(self, voters: List[bytes]) -> None:
        with self._pk_lock:
            fresh = list(dict.fromkeys(v for v in voters
                                       if v not in self._pk.index))
            if not fresh:
                return
            if (len(fresh) < self._qc_threshold
                    or not self._device_allowed("update_pubkeys")):
                self._count_pubkeys("host")
                self._update_pubkeys_host(fresh)
                return
            n = len(fresh)
            try:
                self.breaker.raise_if_injected("update_pubkeys")
                self._count_pubkeys("device")
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
                px, py, pz, valid = self._kernels.g2_validate(
                    *(self._to_dev(a) for a in (x, sgn, inf, ok)))
                px, py, pz = px[:n], py[:n], pz[:n]
                px, py, pz, valid, ax, ay, ainf = self._watched(
                    _readback, (px, py, pz, valid[:n],
                                *_g2_affine_strict(px, py, pz)),
                    size=size, path="update_pubkeys")
            except Exception as e:  # noqa: BLE001 — see _injected
                self._device_failed("update_pubkeys", e)
                self._update_pubkeys_host(fresh)
                return
            self._device_succeeded()
            self._pk.append(fresh, px, py, pz,
                            _g2_oracle_points(ax, ay, ainf, valid), valid)
            self._pk_dev = None  # the device copy is stale

    def _count_pubkeys(self, where: str) -> None:
        with self._calls_lock:
            self.pubkey_updates[where] += 1

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

    @_issuing
    def _pk_rows_of(self, voters: Sequence[bytes]) -> np.ndarray:
        """Cache rows of the voters (validating unseen keys); bad = −1."""
        with self._pk_lock:
            missing = [v for v in voters if bytes(v) not in self._pk.index]
            if missing:
                self.update_pubkeys(missing)
            return np.fromiter((self._pk.index[bytes(v)] for v in voters),
                               np.int64, len(voters))
