"""CudaBlsCrypto: the device-batched BLS12-381 provider on an NVIDIA GPU.

The counterpart of consensus_overlord_tpu/crypto/tpu_provider.py, on one
card or over a mesh of lanes (``mesh=``, parallel/sharded.py: cards, or
logical lanes of one card).  ``verify_batch`` checks N (signature, hash,
voter) triples with one random-linear-combination relation

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
breaker (crypto/breaker.py) before it dispatches and reports its outcome,
and so does an attached MeshSupervisor (parallel/supervisor.py), whose
ladder swaps the kernel set (apply_mesh_rung: the full mesh, a sub-mesh
without a lost lane, the single card) and routes work to the host on its
last rung.
A chaos fault raised in Python — ``breaker.inject_faults``, a kernel set
whose step raises ``InjectedDeviceFault``, ``inject_device_loss``, or an
``inject_dcn_stall`` that holds a readback past the watchdog's deadline
(``dispatch_deadline_s``) — is logged, counted in ``breaker.status()``
(and in bound metrics), and re-verified on the host oracle with exact
verdicts; a failed device pairing also counts in
``pairing_host_fallbacks``.  An open breaker routes work to the host
until a half-open probe succeeds.  Over a mesh that spans processes the
route is the group's: one all_reduce before each call sends every process
to the device or every one to the host, an injected breaker fault is
taken there, and no supervisor is attached.  Nothing of this hides the
card or a kernel: any other exception of a device step, launch or
readback (a CUDA runtime error, a real watchdog timeout) propagates to
the caller and never reaches the breaker; a provider asked for "cuda" on a machine
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
from ..obs.fleet import current_round_id
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

def _g1_partial(x, sign, inf, ok, wpacked):
    """The G1 half of a verification round up to its sum: weight unpack,
    G1 decompress + validate + per-lane subgroup check, and the G1 MSM
    Σ r_i·S_i as a (1,) point.  Returns (bits, valid, sum)."""
    bits = dev.unpack_weight_bits(wpacked)
    pt, valid = dev.g1_validate_batch(x, sign, inf, ok)
    return bits, valid, dev.G1.msm_bits(pt, bits)


def _g1_outs(agg) -> list:
    """(ax, ay, ainf), strict affine, of one (1,) G1 sum."""
    ax, ay, ainf = dev.G1.to_affine(agg)
    return [dev.FQ.strict(ax[0]), dev.FQ.strict(ay[0]), ainf[0]]


def _g1_half(x, sign, inf, ok, wpacked):
    """The G1 half of a verification round (_g1_partial).  Returns the
    weight bits, the per-lane validity and the round's first outputs:
    (ax, ay, ainf) of the aggregate, strict affine, and the validity."""
    bits, valid, agg = _g1_partial(x, sign, inf, ok, wpacked)
    return bits, valid, _g1_outs(agg) + [valid]


def _group_bits(bits, valid, gmask):
    """(B, k, nbits): each lane's weight bits masked by its validity and
    by the host-computed group membership `gmask` (k, B)."""
    return bits[:, None] * (valid[:, None] & gmask.t())[..., None].to(
        bits.dtype)


def _g2_outs(gagg, groups: int = 0) -> list:
    """(gx, gy, ginf), strict affine, of one G2 sum, or of each of
    `groups` sums of a (1, groups) batch."""
    gx, gy, ginf = dev.G2.to_affine(gagg)
    if not groups:
        return [dev.FQ.strict(gx[0]), dev.FQ.strict(gy[0]), ginf[0]]
    return [t for g in range(groups) for t in (
        dev.FQ.strict(gx[0, g]), dev.FQ.strict(gy[0, g]), ginf[0, g])]


def _g2_partial(bits, valid, rows, pkx, pky, pkz):
    """The pubkey-cache gather and the G2 MSM Σ r_i·P_i with weights
    masked by the validity, as a (1,) point."""
    vbits = bits * valid[..., None].to(bits.dtype)
    return dev.G2.msm_bits(dev.gather_rows(rows, pkx, pky, pkz), vbits)


def _g2_partial_multi(bits, valid, rows, gmask, pkx, pky, pkz):
    """One G2 MSM per hash group as a (1, k) point: the k MSMs run as one
    ladder over (B, k) lanes, so each group's lanes see exactly the ops
    of its own MSM."""
    k = gmask.shape[0]
    pk = dev.gather_rows(rows, pkx, pky, pkz)
    pk = Point(*(c[:, None].expand(c.shape[0], k, *c.shape[1:]) for c in pk))
    return dev.G2.msm_bits(pk, _group_bits(bits, valid, gmask))


def verify_round(x, sign, inf, ok, wpacked, rows, pkx, pky, pkz):
    """One single-hash verification round on the device: the G1 half
    (_g1_half), the pubkey-cache gather, and the G2 MSM Σ r_i·P_i with
    weights masked by the device-computed validity.  Returns strict
    affine coords of both aggregates plus the per-lane validity:
    (ax, ay, ainf, valid, gx, gy, ginf)."""
    bits, valid, outs = _g1_half(x, sign, inf, ok, wpacked)
    return tuple(outs + _g2_outs(_g2_partial(bits, valid, rows,
                                             pkx, pky, pkz)))


def verify_round_multi(x, sign, inf, ok, wpacked, rows, gmask,
                       pkx, pky, pkz):
    """k-hash verification round: one G1 MSM over all lanes plus one G2
    MSM per hash group (weights masked by validity AND the host-computed
    group membership `gmask` (k, B); _g2_partial_multi).  Returns the G1
    aggregate, the validity, then (gx, gy, ginf) per group."""
    bits, valid, outs = _g1_half(x, sign, inf, ok, wpacked)
    gagg = _g2_partial_multi(bits, valid, rows, gmask, pkx, pky, pkz)
    return tuple(outs + _g2_outs(gagg, gmask.shape[0]))


def verify_round_tab(x, sign, inf, ok, wpacked, rows, tx, ty, tz):
    """verify_round with the G2 MSM served from the precomputed per-row
    window tables (ops/curve.py msm_from_tables, tables from
    build_g2_tables) instead of the windowed ladder: the round pays
    gathers and adds only.  The same outputs as verify_round."""
    bits, valid, outs = _g1_half(x, sign, inf, ok, wpacked)
    vbits = bits * valid[..., None].to(bits.dtype)
    gagg = dev.G2.msm_from_tables(Point(tx, ty, tz), rows, vbits)
    return tuple(outs + _g2_outs(gagg))


def verify_round_multi_tab(x, sign, inf, ok, wpacked, rows, gmask,
                           tx, ty, tz):
    """verify_round_multi with each group's G2 MSM from the window
    tables, the k groups as one batch of (B, k) lanes: the gathers, the
    window tree and the tree sum of each group's column see exactly the
    ops of that group's own MSM.  The same outputs as
    verify_round_multi."""
    bits, valid, outs = _g1_half(x, sign, inf, ok, wpacked)
    k = gmask.shape[0]
    gagg = dev.G2.msm_from_tables(Point(tx, ty, tz),
                                  rows[:, None].expand(-1, k),
                                  _group_bits(bits, valid, gmask))
    return tuple(outs + _g2_outs(gagg, k))


def build_g2_tables(px, py, pz):
    """The G2 window tables over the padded device pubkey cache: one
    16-window × 16-digit multiple set a row (ops/curve.py
    msm_table_build)."""
    return tuple(dev.G2.msm_table_build(Point(px, py, pz)))


def g2_validate(x, sign, inf, ok):
    """Decompress + subgroup-check a batch of G2 public keys.  Returns
    projective coords + validity (what fills the pubkey cache)."""
    pt, valid = dev.g2_decompress_device(x, sign, inf, ok)
    valid = valid & ~inf & dev.g2_in_subgroup(pt)
    return pt.x, pt.y, pt.z, valid


def _g1_sum_partial(x, sign, inf, ok):
    """G1 decompression and the tree sum of the valid, finite lanes as a
    (1,) point, and the per-lane validity."""
    pt, valid = dev.g1_decompress_device(x, sign, inf, ok)
    return dev.G1.tree_sum(
        dev.G1.select(valid & ~inf, pt, dev.G1.infinity_like(x))), valid


def g1_validate_sum(x, sign, inf, ok):
    """Decompress a batch of G1 signatures and tree-sum them (the QC
    signature aggregate, reference src/consensus.rs:418-444).  No
    subgroup check, matching the oracle aggregate path; invalid and
    infinity lanes become the identity before the sum.  Returns the
    strict affine sum and the per-lane validity: (ax, ay, ainf, valid)."""
    agg, valid = _g1_sum_partial(x, sign, inf, ok)
    return tuple(_g1_outs(agg) + [valid])


def _g2_rows_partial(rows, mask, pkx, pky, pkz):
    """The tree sum of the masked lanes' cached pubkey rows as a (1,)
    point."""
    pk = dev.gather_rows(rows, pkx, pky, pkz)
    return dev.G2.tree_sum(
        dev.G2.select(mask, pk, dev.G2.infinity_like(pk.x)))


def g2_sum_rows(rows, mask, pkx, pky, pkz):
    """Σ P_i over cached pubkey rows (the QC pubkey aggregate, reference
    src/consensus.rs:365-383), padding lanes masked to the identity.
    Returns the strict affine sum (ax, ay, ainf)."""
    return tuple(_g2_outs(_g2_rows_partial(rows, mask, pkx, pky, pkz)))


class _SingleChipKernels:
    """The device steps above, as the provider's default kernel set: the
    provider calls every device step through ``self._kernels``, so a
    test can swap in a set whose steps fail, and the mesh set
    (_MeshKernels) plugs in at the same point.  `lanes` is the number of
    lanes a batch is split over: one here.  `ship` feeds an operand: a
    host array through the provider's upload (`put`), a device tensor as
    it is; the mesh set overrides it to feed a process its block of
    lanes."""

    verify_round = staticmethod(verify_round)
    verify_round_multi = staticmethod(verify_round_multi)
    verify_round_tab = staticmethod(verify_round_tab)
    verify_round_multi_tab = staticmethod(verify_round_multi_tab)
    build_g2_tables = staticmethod(build_g2_tables)
    g2_validate = staticmethod(g2_validate)
    g1_validate_sum = staticmethod(g1_validate_sum)
    g2_sum_rows = staticmethod(g2_sum_rows)
    multi_pairing = staticmethod(pairing_ops.multi_pairing_is_one_staged)
    ship = staticmethod(lambda arr, put, axis_index=0: arr if isinstance(
        arr, torch.Tensor) else put(arr))
    ship_replicated = staticmethod(lambda arr, put: put(arr))
    lanes = 1


class _MeshKernels:
    """The same kernel surface over a mesh of lanes (parallel/sharded.py):
    signature lanes and pubkey-row indices shard across the lanes, the
    pubkey cache is replicated (one copy per distinct device), partial
    group sums combine once, and the pairing verdict runs as the sharded
    staged pair (per-lane Miller partials, one Fq12 tree product of the
    D partials, one shared final exponentiation).  The provider keeps its
    batch and pair pads a multiple of `lanes`.  Over a mesh of several
    processes every lane-sharded output is gathered whole
    (sharded.gather_lanes), so the provider reads back the whole batch.
    The G2 window tables are single-card only: no table steps here."""

    def __init__(self, mesh):
        from ..parallel import multihost, sharded

        self.mesh = mesh
        self.lanes = mesh.size
        self._host_shard_array = multihost.host_shard_array
        self._gather = functools.partial(sharded.gather_lanes, mesh)
        self._verify_round = sharded.sharded_verify_round(mesh)
        self._verify_round_multi = sharded.sharded_verify_round_multi(mesh)
        self._g2_validate = sharded.sharded_g2_validate(mesh)
        self._g1_validate_sum = sharded.sharded_g1_validate_sum(mesh)
        self.g2_sum_rows = sharded.sharded_g2_sum_rows(mesh)
        self.multi_pairing = sharded.sharded_multi_pairing_is_one(mesh)

    def _whole(self, out, *at):
        return tuple(self._gather(t) if i in at else t
                     for i, t in enumerate(out))

    def verify_round(self, *args):
        return self._whole(self._verify_round(*args), 3)

    def verify_round_multi(self, *args):
        return self._whole(self._verify_round_multi(*args), 3)

    def g2_validate(self, *args):
        return self._whole(self._g2_validate(*args), 0, 1, 2, 3)

    def g1_validate_sum(self, *args):
        return self._whole(self._g1_validate_sum(*args), 3)

    def ship(self, arr, put, axis_index: int = 0):
        """This process's block of a lane-sharded operand (the whole
        operand in a one-process mesh); axis_index picks the lane axis
        (1 for the multi-hash (k, B) group mask)."""
        return self._host_shard_array(self.mesh, arr, axis_index=axis_index,
                                      put=put)

    def ship_replicated(self, arr, put):
        """A host-identical operand on every distinct device of the mesh
        (the replicated pubkey cache)."""
        return self._host_shard_array(self.mesh, arr, replicated=True,
                                      put=put)


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
    default) turns the watchdog off.
    g2_table_msm: serve the verify round's G2 MSM from per-row window
    tables over the device pubkey cache (``build_g2_tables``: 16 windows
    × 16 digits of every cached key, about 240 KB of device memory a
    row, 3.9 GB at the 16,384-row rung), rebuilt at the end of every
    ``update_pubkeys`` that changed the cache, so a round pays gathers
    and adds only (``verify_round_tab``, ``verify_round_multi_tab``).
    None reads CONSENSUS_G2_TABLE_MSM (default off; "0", "off" and
    "false" are off).  Single-card kernel sets only.
    mesh: a parallel/sharded.py Mesh of more than one lane shards every
    batch over its lanes (_MeshKernels: parallel/sharded.py's functions
    on the same kernels), and `device` is then the mesh's first lane's;
    a mesh of one lane is the single-card set on that lane's device.
    A mesh inside one process is the top rung of a MeshSupervisor's
    ladder (attach_supervisor): a lost lane's sub-mesh, the single card,
    the host oracle.  A mesh across processes has no ladder, and its
    route to the device or the host is agreed by the group."""

    def __init__(self, private_key: int, common_ref: bytes = b"",
                 device_threshold: int = 32, device="cuda",
                 device_pairing: Optional[bool] = None,
                 qc_device_threshold: Optional[int] = None,
                 breaker: Optional[CircuitBreaker] = None,
                 dispatch_deadline_s: Optional[float] = None,
                 g2_table_msm: Optional[bool] = None, mesh=None):
        self.device = torch.device(mesh.home if mesh is not None else device)
        if self.device.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError("CudaBlsCrypto: device 'cuda' was asked "
                                   "for but torch.cuda.is_available() is "
                                   "False")
            if self.device.index is None:
                self.device = torch.device("cuda",
                                           torch.cuda.current_device())
            for d in (mesh.physical_devices() if mesh is not None
                      else [self.device]):
                kernels.load_all(d)
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
        #: The configured full mesh (None for a single-card provider): the
        #: ladder's top rung, and the lanes a sub-mesh drops lanes from.
        self._mesh = mesh if mesh is not None and mesh.size > 1 else None
        self._kernels = (_MeshKernels(self._mesh) if self._mesh is not None
                         else _SingleChipKernels)
        #: The full rung's kernel set, reused when the ladder climbs back.
        self._full_kernels = self._kernels
        #: Optional MeshSupervisor (parallel/supervisor.py): fed from
        #: _device_failed/_device_succeeded, consulted in _device_allowed,
        #: swaps kernel sets through apply_mesh_rung.
        self._supervisor = None
        #: The staged mesh probe's functions (profile_sharded_stages),
        #: built on its first call and dropped with the kernel set.
        self._stage_probe = None
        #: Chaos hook: {lane name: seconds} of delay added inside each
        #: lane's timed shard fetch (inject_straggler).
        self._inject_straggler: dict = {}
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
        if g2_table_msm is None:
            g2_table_msm = os.environ.get(
                "CONSENSUS_G2_TABLE_MSM", "0") not in ("0", "off", "false")
        self._use_g2_tables = bool(g2_table_msm) and self._mesh is None
        #: The G2 window tables over _pk_dev (g2_table_msm): dropped with
        #: it on every change of the cache, rebuilt at the end of
        #: update_pubkeys (the reconfigure point).
        self._pk_tab: Optional[Tuple[torch.Tensor, ...]] = None

    # -- observability and the breaker ---------------------------------------

    def bind_metrics(self, metrics) -> None:
        """Attach a metric surface (an object with the JAX package's
        obs.Metrics attribute names), for the provider and its breaker."""
        self.metrics = metrics
        self.breaker.metrics = metrics

    def bind_profiler(self, prof) -> None:
        """Attach a device profiler (obs/prof.py DeviceProfiler): every
        device op then records a staged per-call profile, and the device
        set names the mesh's lanes (or this provider's device)."""
        self.prof = prof
        if prof is None:
            return
        mesh = getattr(self._kernels, "mesh", None)
        try:
            if mesh is not None:
                prof.set_devices(mesh.devices, names=mesh.local_names())
            else:
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
        doc["g2_table_msm"] = self._use_g2_tables
        with self._calls_lock:
            doc["calls"] = {p: dict(c) for p, c in self.calls.items()}
            doc["pubkey_updates"] = dict(self.pubkey_updates)
        return doc

    def _count(self, path: str, where: str) -> None:
        with self._calls_lock:
            self.calls[path][where] += 1

    def _device_allowed(self, path: str) -> bool:
        """Ask the supervisor's ladder gate, then the breaker; count the
        fallback when routed to the host.  On the host_oracle rung the
        supervisor lets one probe through per cooldown.  Over a mesh
        that spans processes the answer is collective (_agree_device):
        every process of the group dispatches, or every one takes the
        host route, so none waits in a collective its peers skipped."""
        sup = self._supervisor
        ok = (sup is None or sup.allow_device()) and self.breaker.allow()
        counted = False
        if self._group_mesh() is not None:
            ok, counted = self._agree_device(path, ok)
        if not ok and not counted and self.metrics is not None:
            self.metrics.host_fallbacks.labels(path=path).inc()
        return ok

    def _group_mesh(self):
        """The configured mesh when it spans processes, else None."""
        mesh = self._mesh
        return mesh if mesh is not None and mesh.group is not None else None

    def _agree_device(self, path: str, ok: bool) -> Tuple[bool, bool]:
        """The group's one decision for a call over a mesh across
        processes: this process's `ok`, less an armed injected fault,
        which is taken here (raised, fed to the breaker and counted) and
        not at the dispatch (_raise_if_injected), then the minimum over
        the group (sharded.agree, one all_reduce).  Returns (the
        decision, whether the host fallback was counted already).  A
        half-open breaker's probe token that the group overrules expires
        after one cooldown (CircuitBreaker.allow)."""
        from ..parallel import sharded

        counted = False
        if ok and self.breaker.fault_injected:
            try:
                self.breaker.raise_if_injected(path)
            except Exception as e:  # noqa: BLE001 — see _injected
                self._device_failed(path, e)
                ok, counted = False, True
        return sharded.agree(self._mesh, ok), counted

    def _raise_if_injected(self, path: str) -> int:
        """breaker.raise_if_injected at a dispatch; over a mesh across
        processes the injected fault was taken collectively in
        _device_allowed, so this is the fault-window epoch alone."""
        if self._group_mesh() is not None:
            return self.breaker.epoch
        return self.breaker.raise_if_injected(path)

    def _device_failed(self, path: str, exc: BaseException) -> None:
        """One injected device dispatch/readback failure: feed the
        breaker and the supervisor's ladder, count it, log it; the caller
        then falls back to the host oracle.  Any other exception is
        re-raised here (see _injected)."""
        if not _injected(exc):
            raise exc
        logger.warning("device path %s failed (%s: %s); host fallback",
                       path, type(exc).__name__, exc)
        self.breaker.record_failure(f"{path}: {type(exc).__name__}")
        sup = self._supervisor
        if sup is not None:
            sup.record_failure(path, exc)
        if self.metrics is not None:
            self.metrics.device_failures.labels(path=path).inc()
            self.metrics.host_fallbacks.labels(path=path).inc()

    def _device_succeeded(self, epoch: int) -> None:
        """A clean device call admitted under fault-window `epoch` (what
        breaker.raise_if_injected returned at its dispatch): the breaker
        counts it, and the supervisor's step-up probe (traffic is the
        probe)."""
        self.breaker.record_success(epoch)
        sup = self._supervisor
        if sup is not None:
            sup.record_success()

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

    # -- the mesh ladder -----------------------------------------------------

    def attach_supervisor(self, supervisor) -> None:
        """Attach a MeshSupervisor (parallel/supervisor.py): from here on
        device outcomes walk its ladder and apply_mesh_rung swaps this
        provider's kernel set on its transitions.  Refused over a mesh
        that spans processes: the ladder steps one process down alone,
        and its peers would wait in collectives it no longer joins."""
        if self._group_mesh() is not None:
            raise ValueError("a MeshSupervisor cannot walk a mesh that "
                             "spans processes: its rungs are one "
                             "process's decision")
        self._supervisor = supervisor

    @property
    def multiprocess_mesh(self) -> bool:
        """Whether this provider's mesh spans processes (no supervisor)."""
        return self._group_mesh() is not None

    def mesh_device_names(self) -> List[str]:
        """The configured full mesh's lane names (what a sub-mesh drops
        quarantined lanes from); empty for a single-card provider, which
        has no sub_mesh rung."""
        return [] if self._mesh is None else self._mesh.names()

    def _current_lane_names(self) -> List[str]:
        """The lanes of the CURRENT kernel set (a sub-mesh has fewer): a
        mesh's lane names, or the single card's "type:index"."""
        mesh = getattr(self._kernels, "mesh", None)
        if mesh is not None:
            return mesh.names()
        return [device_name(self.device)]

    def _lane_name(self, lane) -> str:
        """A chaos target (a lane index or a lane name) as a lane name of
        the full mesh (or of the current kernel set)."""
        names = self.mesh_device_names() or self._current_lane_names()
        if isinstance(lane, int) or (isinstance(lane, str)
                                     and lane.isdigit()):
            return names[int(lane) % len(names)]
        return str(lane)

    def apply_mesh_rung(self, rung: str, quarantined: Sequence[str]) -> None:
        """MeshSupervisor hook: swap the kernel set for a ladder rung.
        full_mesh reuses the constructor's set; sub_mesh builds
        _MeshKernels over the lanes not quarantined (batches then pad to
        the new lane multiple through `lanes`), or the single-card set
        when fewer than two lanes survive; single_chip is the single-card
        set on the mesh's first device; host_oracle changes nothing here:
        the supervisor's allow_device() gate routes work to the host."""
        if rung == "host_oracle":
            return
        if rung == "full_mesh" and self._mesh is not None and not quarantined:
            kernels = self._full_kernels
        elif rung != "single_chip" and self._mesh is not None:
            survivors = self._mesh.without(quarantined)
            kernels = (_MeshKernels(survivors) if survivors.size >= 2
                       else _SingleChipKernels)
        else:
            kernels = _SingleChipKernels
        self._swap_kernels(kernels)
        logger.warning("mesh rung %s applied: %d lane(s)%s", rung,
                       kernels.lanes,
                       f", quarantined={sorted(quarantined)}"
                       if quarantined else "")

    def _swap_kernels(self, kernels) -> None:
        """Install a kernel set and drop what was placed for the old one
        (the device pubkey copy, the G2 tables, the stage probe).  A
        dispatch racing the swap may mix shapes and fail: that lands in
        the failure handling and re-verifies on the host."""
        if kernels is self._kernels:
            return
        with self._pk_lock:
            self._kernels = kernels
            self._pk_dev = None
            self._pk_tab = None
        self._stage_probe = None

    def _pad_to(self, n: int) -> int:
        """The pad ladder's size for n lanes, rounded up to a multiple of
        the kernel set's lanes."""
        size = _pad_to(n)
        lanes = self._kernels.lanes
        return -(-size // lanes) * lanes

    def _ship(self, arr, axis_index: int = 0):
        """A lane-sharded operand through the kernel set's feed."""
        return self._kernels.ship(arr, self._to_dev, axis_index)

    # -- watchdog and chaos hooks --------------------------------------------

    def inject_device_loss(self, lane, seconds: float) -> None:
        """Chaos hook (sim `device_loss`): for `seconds`, every watched
        device call of a kernel set holding the lane `lane` (an index
        into the full mesh's lanes, or a lane name: "cuda:0" for a single
        card, "cuda:0/2" for a logical lane) raises DeviceLossError
        naming it.  Once the supervisor has quarantined it, a sub-mesh
        without it dispatches clean while the window lasts.  seconds <= 0
        clears the lane."""
        name = self._lane_name(lane)
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
        """Raise DeviceLossError while an armed lane loss targets a lane
        of the CURRENT kernel set, matched by its exact name (expired
        windows clear themselves)."""
        if not self._inject_loss:
            return
        now = time.monotonic()
        current = None
        for name, until in list(self._inject_loss.items()):
            if now >= until:
                self._inject_loss.pop(name, None)
                continue
            if current is None:
                current = set(self._current_lane_names())
            if name in current:
                raise DeviceLossError(
                    name, f"{path}: injected loss of lane {name}")

    def inject_straggler(self, lane: str, seconds: float) -> None:
        """Chaos hook: add `seconds` of delay to lane `lane`'s timed shard
        fetches (seconds <= 0 clears it).  The sleep sits inside the
        lane's timing window, so the straggler detector sees what a
        degraded device-to-host path would give."""
        lane = str(lane)
        if seconds > 0:
            self._inject_straggler[lane] = float(seconds)
        else:
            self._inject_straggler.pop(lane, None)

    def _shard_latencies(self, out, sampled: bool = False,
                         stage: str = "readback", mesh=None) -> None:
        """Per-lane fetch timing of a lane-sharded output after it is
        complete: each lane's slice (or, for a list, each lane's tensor)
        is read back alone and timed, and lands in
        DeviceProfiler.device_stage (sharded_device_stage_seconds{device,
        stage} and the straggler detector) under the lane's name.  The
        hot path (a mesh kernel set's validity) is throttled by the
        profiler's sample interval; the probe passes sampled=True."""
        if self.prof is None:
            return
        if mesh is None:
            mesh = getattr(self._kernels, "mesh", None)
        if mesh is None:
            return
        if not sampled and not self.prof.want_device_sample():
            return
        try:
            round_id = current_round_id()
            if isinstance(out, torch.Tensor):
                own = out[mesh.rank * (out.shape[0] // mesh.world):] \
                    if mesh.world > 1 else out
                parts = [own[sl] for _, sl in mesh.shards(
                    out.shape[0] // mesh.world)]
            else:
                parts = list(out)
            for name, part in zip(mesh.local_names(), parts):
                delay = self._inject_straggler.get(name)
                t0 = time.perf_counter()
                if delay:
                    time.sleep(delay)
                part.cpu()
                self.prof.device_stage(name, stage, time.perf_counter() - t0,
                                       round_id=round_id)
        except Exception:  # noqa: BLE001 — profiling never breaks crypto
            logger.warning("per-lane fetch sample failed", exc_info=True)

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

    def _host_verify_aggregated(self, agg_sig: bytes, hash32: bytes,
                                voters: Sequence[bytes]) -> bool:
        """A QC on the host oracle: the voters' cached points (a key not
        seen yet is validated into the cache first, by _pk_rows_of) are
        summed and paired, and a key the cache knows bad fails the QC, as
        CpuBlsCrypto's subgroup check would.  The verdict is
        CpuBlsCrypto's."""
        if not voters:  # as CpuBlsCrypto: an empty QC never verifies
            return False
        rows = self._pk_rows_of(voters)
        aff = self._pk.aff
        if any(r < 0 for r in rows):
            return False
        try:
            sig_pt = oracle.g1_decompress(agg_sig)
        except ValueError:
            return False
        if sig_pt is None or not oracle.g1_in_subgroup(sig_pt):
            return False
        agg_pk = None
        for r in rows:
            agg_pk = oracle.g2_add(agg_pk, aff[r])
        if agg_pk is None:
            return False
        h = oracle.hash_to_g1(hash32, self._common_ref)
        return oracle.multi_pairing_is_one([(sig_pt, _NEG_G2_ORACLE),
                                            (h, agg_pk)])

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
                epoch = self._raise_if_injected("aggregate")
                self._count("aggregate", "device")
                t0 = time.perf_counter()
                size = self._pad_to(n)
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
                        *(self._ship(a) for a in (x, sign_f, inf, ok)))
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
            self._device_succeeded(epoch)
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
            return lambda: self._host_verify_aggregated(
                agg_sig, hash32, voters)
        call = self._prof_begin("verify_aggregated", len(voters))
        with _ISSUE:
            try:
                epoch = self._raise_if_injected("verify_aggregated")
                t0 = time.perf_counter()
                idx = self._pk_rows_of(voters)
                if (idx < 0).any():
                    # A QC over an unknown or bad key never verifies (no
                    # device dispatch happened).
                    call.observe("parse", time.perf_counter() - t0)
                    call.finish(ok=False)
                    return lambda: False
                n = len(voters)
                size = self._pad_to(n)
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
                        self._ship(rows), self._ship(mask), pkx, pky, pkz)
                call.observe("dispatch", time.perf_counter() - t0)
            except Exception as e:  # noqa: BLE001 — see _injected
                call.finish(ok=False)
                self._device_failed("verify_aggregated", e)
                return lambda: self._host_verify_aggregated(
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
                return self._host_verify_aggregated(
                    agg_sig, hash32, voters)
            self._device_succeeded(epoch)
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
                            return self._host_verify_aggregated(
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
            epoch = self._raise_if_injected("verify_batch")
            if len(groups) == 1:
                return self._dispatch_single_hash(
                    signatures, bytes(hashes[0]), voters, n, call, epoch)
            if len(groups) <= _GROUP_SIZES[-1]:
                return self._dispatch_multi_hash(signatures, voters, n,
                                                 groups, call, epoch)
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
        """Host-side prep shared by every batch path (_host_arrays), the
        operands shipped to the kernel set.  Returns (size, x, sign,
        inf, ok, wpacked, rows, pk_ok) with the first seven as device
        tensors."""
        size, *arrays, pk_ok = self._host_arrays(signatures, voters, n, call)
        return (size,) + tuple(self._ship(a) for a in arrays) + (pk_ok,)

    def _host_arrays(self, signatures, voters, n, call=NULL_CALL):
        """Parse + pad the signatures, resolve (validating on first sight)
        pubkey rows, draw packed 64-bit weights.  Returns (size, x, sign,
        inf, ok, wpacked, rows, pk_ok) as host arrays."""
        pk_idx = self._pk_rows_of(voters)
        pk_ok = pk_idx >= 0
        size = self._pad_to(n)
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
        return size, sx, ssign, sinf, sok, wpacked, rows, pk_ok

    @_issuing
    def _dispatch_pairing(self, g1s, g2s) -> Optional[torch.Tensor]:
        """Enqueue the device multi-pairing verdict over a flush's pairs.
        g1s: [(x, y, inf)] G1 strict limbs ((n,) each, a device tensor or
        a host array) and infinity flag; g2s: the matching Fq2 pairs
        ((2, n) limbs).  Pads to the _PAIR_SIZES ladder, rounded up to a
        multiple of the kernel set's lanes, with infinity, masked pairs
        (each contributes one), and returns the verdict as a device bool
        — or None after feeding the breaker if an injected fault failed
        the dispatch, so callers pair on the host."""
        try:
            self._raise_if_injected("pairing")
            k = len(g1s)
            size = next((s for s in _PAIR_SIZES if k <= s), k)
            lanes = self._kernels.lanes
            size = -(-size // lanes) * lanes
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
            t["mask"] = self._to_dev(np.arange(size) < k)
            with annotate("cuda_bls.pairing.dispatch"):
                return self._kernels.multi_pairing(*(
                    self._ship(t[key]) for key in
                    ("px", "py", "pinf", "qx", "qy", "qinf", "mask")))
        except Exception as e:  # noqa: BLE001 — see _injected
            self._pairing_failed(e)
            return None

    @staticmethod
    def _h_limbs(h_pt):
        """Oracle G1 point → (x, y) strict limb arrays for the pairing's
        hash-side pairs."""
        return dev.FQ.from_int(h_pt[0]), dev.FQ.from_int(h_pt[1])

    @_issuing
    def _dispatch_single_hash(self, signatures, h, voters, n, call, epoch):
        self._count("verify_batch", "device")
        t0 = time.perf_counter()
        (size, sx, ssign, sinf, sok, wpacked, rows,
         pk_ok) = self._host_prep(signatures, voters, n, call)
        t0 = self._observe_phase("prep", t0, call)
        with annotate("cuda_bls.verify_round.dispatch"):
            if self._use_g2_tables:
                out = self._kernels.verify_round_tab(
                    sx, ssign, sinf, sok, wpacked, rows, *self._pk_tables())
            else:
                out = self._kernels.verify_round(
                    sx, ssign, sinf, sok, wpacked, rows, *self._pk_device())
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
            [h] * n, voters, f"single-hash batch n={n}", call, epoch)

    @_issuing
    def _dispatch_multi_hash(self, signatures, voters, n,
                             groups: Dict[bytes, List[int]], call, epoch):
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
            if self._use_g2_tables:
                out = self._kernels.verify_round_multi_tab(
                    sx, ssign, sinf, sok, wpacked, rows, self._ship(gmask, 1),
                    *self._pk_tables())
            else:
                out = self._kernels.verify_round_multi(
                    sx, ssign, sinf, sok, wpacked, rows, self._ship(gmask, 1),
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
            lane_hashes, voters, f"{len(ghashes)}-hash batch n={n}", call,
            epoch)

    def _batch_resolver(self, out, verdict_dev, size, n, pk_ok,
                        host_pairing, signatures, lane_hashes, voters,
                        what: str, call, epoch: int):
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
            self._device_succeeded(epoch)
            self._observe_phase("readback", t0, call)
            # Per-lane fetch sample after the readback stage is observed,
            # throttled, so its reads land in no stage.
            self._shard_latencies(out[3])
            t0 = time.perf_counter()
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

    #: Timed calls of each probe stage; the stage's time is their median.
    PROBE_REPS = 5

    @_issuing
    def profile_sharded_stages(self, signatures, voters) -> dict:
        """The staged mesh probe: split a verify round into the lanes' own
        work and the combine, which one round cannot show.  Each half is
        timed alone: sharded_verify_round_local (validate and partial
        MSMs per lane), then verify_round_combine over its partials
        (stacking the D partials, the tree sums and the affine finish),
        beside the full round.  The pairing gets the same split on a
        generator-pair fixture (one pair a lane, every lane live; the
        verdict is not used): sharded_miller_partial_local, then
        miller_combine over its partials, the shared final
        exponentiation left out.  Every stage runs once untimed (the
        first call builds per-shape state), then PROBE_REPS times, each
        call timed on the host clock after synchronizing every device of
        the mesh; a stage reports the median, and its min and max as
        `<stage>_spread_s`.  Each lane's part of the twins is then
        fetched and timed per lane (_shard_latencies), and a bound
        profiler gets the four medians (DeviceProfiler.sharded).  It
        costs real launches, so it runs where sampling is explicit,
        never per batch.  A single-card provider probes a mesh of its
        one device."""
        from ..parallel import multihost, sharded

        n = len(signatures)
        if self._stage_probe is None:
            mesh = getattr(self._kernels, "mesh", None) or sharded.Mesh(
                [self.device])
            self._stage_probe = (
                sharded.sharded_verify_round_local(mesh),
                functools.partial(sharded.verify_round_combine, mesh),
                sharded.sharded_verify_round(mesh),
                sharded.sharded_miller_partial_local(mesh),
                functools.partial(sharded.miller_combine, mesh), mesh)
        (local_fn, combine_fn, full_fn, pair_local_fn, pair_combine_fn,
         mesh) = self._stage_probe
        lanes = mesh.size
        # The probe's batch is not frontier traffic: keep it out of the
        # occupancy and padded-lane metrics.
        metrics, self.metrics = self.metrics, None
        try:
            size, *arrays, _ = self._host_arrays(signatures, voters, n)
        finally:
            self.metrics = metrics
        pad = -(-size // lanes) * lanes - size
        arrays = [np.concatenate([a, np.zeros((pad,) + a.shape[1:], a.dtype)])
                  for a in arrays]
        size += pad

        def ship(a):
            return multihost.host_shard_array(mesh, a, put=self._to_dev)

        spread = {}

        def timed(fn, args, label, stage):
            out = fn(*args)  # builds per-shape state: not a stage
            self._synchronize(mesh)
            times = []
            for _ in range(self.PROBE_REPS):
                t0 = time.perf_counter()
                with annotate(label):
                    out = fn(*args)
                    self._synchronize(mesh)
                times.append(time.perf_counter() - t0)
            spread[f"{stage}_spread_s"] = [min(times), max(times)]
            return out, float(np.median(times))

        args = [ship(a) for a in arrays] + list(self._pk_device())
        local_out, t_local = timed(local_fn, args,
                                   "cuda_bls.probe.partial_reduce",
                                   "partial_reduce")
        _, t_combine = timed(combine_fn, [local_out],
                             "cuda_bls.probe.combine", "allgather")
        _, t_full = timed(full_fn, args, "cuda_bls.probe.full_round", "full")
        g1 = (np.tile(dev.FQ.from_int(oracle.G1_GEN[0]), (lanes, 1)),
              np.tile(dev.FQ.from_int(oracle.G1_GEN[1]), (lanes, 1)))
        g2 = (np.tile(_NEG_G2_GEN_X, (lanes, 1, 1)),
              np.tile(_NEG_G2_GEN_Y, (lanes, 1, 1)))
        no, yes = np.zeros(lanes, bool), np.ones(lanes, bool)
        pair_args = [ship(a) for a in (*g1, no, *g2, no, yes)]
        pair_local_out, t_pair_local = timed(
            pair_local_fn, pair_args, "cuda_bls.probe.pairing_partial",
            "pairing_partial")
        _, t_pair_combine = timed(pair_combine_fn, [pair_local_out],
                                  "cuda_bls.probe.pairing_combine",
                                  "pairing_combine")
        device_stage_s = None
        if self.prof is not None:
            self.prof.sharded("partial_reduce", t_local)
            self.prof.sharded("allgather", t_combine)
            self.prof.sharded("pairing_partial", t_pair_local)
            self.prof.sharded("pairing_combine", t_pair_combine)
            self._shard_latencies([p[1] for p in local_out], sampled=True,
                                  stage="partial_reduce", mesh=mesh)
            self._shard_latencies(pair_local_out, sampled=True,
                                  stage="pairing_partial", mesh=mesh)
            device_stage_s = self.prof.device_stage_totals()
        return {"devices": int(lanes), "batch": n, "padded": int(size),
                "reps": self.PROBE_REPS,
                "partial_reduce_s": t_local, "allgather_s": t_combine,
                "pairing_partial_s": t_pair_local,
                "pairing_combine_s": t_pair_combine, "full_s": t_full,
                **spread, "device_stage_s": device_stage_s}

    @staticmethod
    def _synchronize(mesh) -> None:
        for d in mesh.physical_devices():
            if d.type == "cuda":
                torch.cuda.synchronize(d)

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
        self._validate_pubkeys(voters)
        if self._use_g2_tables:
            # The tables are rebuilt here, at the reconfigure point, so
            # the first round after it pays gathers only.  A build that
            # fails with an injected fault stays lazy: the next round
            # retries it inside its breaker-guarded dispatch.
            try:
                self._pk_tables()
            except Exception as e:  # noqa: BLE001 — see _injected
                self._device_failed("update_pubkeys", e)

    def _validate_pubkeys(self, voters: List[bytes]) -> None:
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
                epoch = self._raise_if_injected("update_pubkeys")
                self._count_pubkeys("device")
                size = self._pad_to(n)
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
                    *(self._ship(a) for a in (x, sgn, inf, ok)))
                px, py, pz = px[:n], py[:n], pz[:n]
                px, py, pz, valid, ax, ay, ainf = self._watched(
                    _readback, (px, py, pz, valid[:n],
                                *_g2_affine_strict(px, py, pz)),
                    size=size, path="update_pubkeys")
            except Exception as e:  # noqa: BLE001 — see _injected
                self._device_failed("update_pubkeys", e)
                self._update_pubkeys_host(fresh)
                return
            self._device_succeeded(epoch)
            self._pk.append(fresh, px, py, pz,
                            _g2_oracle_points(ax, ay, ainf, valid), valid)
            self._pk_dev = self._pk_tab = None  # the device copies are stale

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
        self._pk_dev = self._pk_tab = None

    def load_pubkey_cache(self, cache: PubkeyCache) -> None:
        """Adopt a whole pubkey cache (convert.pubkey_cache_from_jax)."""
        with self._pk_lock:
            self._pk = cache
            self._pk_dev = self._pk_tab = None

    def _pk_device(self) -> Tuple[torch.Tensor, ...]:
        """The device copy of the cache, padded to the capacity ladder
        (on a mesh, one copy per distinct device of its lanes)."""
        with self._pk_lock:
            if self._pk_dev is None:
                cap = _pk_capacity(max(self._pk.px.shape[0], 1))
                pad = [(0, cap - self._pk.px.shape[0]), (0, 0), (0, 0)]
                self._pk_dev = tuple(
                    self._kernels.ship_replicated(np.pad(a, pad),
                                                  self._to_dev)
                    for a in (self._pk.px, self._pk.py, self._pk.pz))
            return self._pk_dev

    def _pk_tables(self) -> Tuple[torch.Tensor, ...]:
        """The G2 window tables over the device copy of the cache
        (g2_table_msm), built when the cache changed since the last
        build.  The device copy's fetch and the staleness check share one
        _pk_lock section, so a concurrent update_pubkeys cannot leave
        tables of the old cache cached as fresh."""
        with self._pk_lock:
            if self._pk_tab is None:
                self._pk_tab = self._kernels.build_g2_tables(
                    *self._pk_device())
            return self._pk_tab

    @_issuing
    def _pk_rows_of(self, voters: Sequence[bytes]) -> np.ndarray:
        """Cache rows of the voters (validating unseen keys); bad = −1."""
        with self._pk_lock:
            missing = [v for v in voters if bytes(v) not in self._pk.index]
            if missing:
                self.update_pubkeys(missing)
            return np.fromiter((self._pk.index[bytes(v)] for v in voters),
                               np.int64, len(voters))
