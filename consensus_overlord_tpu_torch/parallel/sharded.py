"""Mesh kernels: the consensus-round crypto step over a mesh of lanes.

The port's twin of consensus_overlord_tpu/parallel/sharded.py, written in
PyTorch's own idiom instead of shard_map.  A `Mesh` is an ordered list of
lanes, each a name and a torch.device.  Signature and
pubkey lanes split into one contiguous shard per lane; each lane runs the
single-card bodies of crypto/cuda_provider.py and ops/pairing.py on its
shard (on a CUDA tensor every group law, field product and pairing stage
is a launch of the hand-written kernels) and reduces it to one partial
group sum or Miller product.  `_combine_replicated` stacks the D partials
on the mesh's first device — across processes with one
torch.distributed.all_gather — and one tree sum over them finishes the
reduction, so the aggregate is the same in every process while the
per-lane validity stays with its shard.

Lanes may repeat a device.  Such lanes are logical: the CPU tests run 8
of them on the CPU, and the card's smoke runs 4 on one GPU, the port's
counterpart of the 8 virtual CPU devices the JAX tests force.  Each lane
then has its own name ("cuda:0/2"), which the supervisor, the chaos hooks
and the straggler detector share.  Every lane's work is issued from the
calling thread, one lane after the other, under the lane's device: the
provider issues device work under one process-wide issue lock
(crypto/cuda_provider.py), so no thread per lane.  A cache that
every lane reads (the pubkey rows) is held once per distinct physical
device (`Replicated`), not once per logical lane.

Every function here takes the process-local block of the lane axis (the
whole batch in a one-process run; parallel/multihost.py host_shard_array
cuts it) and returns the validity of that block only.  Padding is the
caller's: a batch that is not a multiple of the lanes splits into shards
whose sizes differ by one, and padded lanes must contribute the identity
(weight 0, masked, or flagged invalid).
"""

from __future__ import annotations

from contextlib import nullcontext
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch

from ..crypto import cuda_provider as card
from ..obs.prof import device_name
from ..ops import bls12381_groups as dev
from ..ops import pairing as pairing_ops
from ..ops.curve import Point

class Lane(NamedTuple):
    """One lane of a mesh: its name and its device."""

    name: str
    device: torch.device


def _device(d) -> torch.device:
    """A torch device with its index: "cuda" names the current card."""
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


def lane_names(devices: Sequence[torch.device]) -> List[str]:
    """"type:index" per device; a device that holds several lanes names
    each of them "type:index/k", k counting its lanes from 0."""
    base = [device_name(d) for d in devices]
    seen: Dict[str, int] = {}
    out = []
    for b in base:
        if base.count(b) == 1:
            out.append(b)
            continue
        k = seen.get(b, 0)
        seen[b] = k + 1
        out.append(f"{b}/{k}")
    return out


class Mesh:
    """An ordered list of lanes along one axis, and, for a mesh that spans
    processes (parallel/multihost.py global_mesh), the torch.distributed
    group whose every process holds the same number of lanes: this
    process's lanes then follow the lanes of every lower rank."""

    def __init__(self, devices: Sequence,
                 names: Optional[Sequence[str]] = None, group=None):
        devices = [_device(d) for d in devices]
        if not devices:
            raise ValueError("a mesh needs at least one lane")
        names = list(names) if names is not None else lane_names(devices)
        if len(names) != len(devices) or len(set(names)) != len(names):
            raise ValueError(f"mesh lane names must be distinct, one a lane: "
                             f"{names}")
        self.lanes = tuple(Lane(n, d) for n, d in zip(names, devices))
        self.group = group
        if group is not None:
            import torch.distributed as dist

            self.rank = dist.get_rank(group)
            self.world = dist.get_world_size(group)
        else:
            self.rank, self.world = 0, 1

    @property
    def devices(self) -> List[torch.device]:
        """This process's lanes' devices, in lane order."""
        return [lane.device for lane in self.lanes]

    @property
    def size(self) -> int:
        """Lanes across every process of the mesh."""
        return len(self.lanes) * self.world

    @property
    def home(self) -> torch.device:
        """Where this process stacks the partials and keeps the
        replicated results: its first lane's device."""
        return self.lanes[0].device

    def physical_devices(self) -> List[torch.device]:
        """The distinct devices under this process's lanes."""
        return list(dict.fromkeys(self.devices))

    def names(self) -> List[str]:
        """Every lane's name across the mesh; a lane of another process
        than a one-process mesh's is "p<rank>/<name>"."""
        local = [lane.name for lane in self.lanes]
        if self.world == 1 and self.group is None:
            return local
        return [f"p{r}/{n}" for r in range(self.world) for n in local]

    def local_names(self) -> List[str]:
        names = self.names()
        per = len(self.lanes)
        return names[self.rank * per:(self.rank + 1) * per]

    def without(self, dead: Sequence[str]) -> "Mesh":
        """The mesh of the lanes not named in `dead`, names kept.  Only
        for a mesh inside one process: a sub-mesh across processes would
        need every process to agree on it."""
        if self.group is not None:
            raise ValueError("a sub-mesh of a multi-process mesh is not "
                             "supported")
        dead = set(dead)
        keep = [lane for lane in self.lanes if lane.name not in dead]
        return Mesh([lane.device for lane in keep],
                    names=[lane.name for lane in keep])

    def shards(self, n: int) -> List[Tuple[Lane, slice]]:
        """Each lane with its contiguous slice of an n-lane block: the
        first n mod L lanes take one more."""
        per, extra = divmod(n, len(self.lanes))
        out, start = [], 0
        for i, lane in enumerate(self.lanes):
            stop = start + per + (i < extra)
            out.append((lane, slice(start, stop)))
            start = stop
        return out

    def __repr__(self) -> str:
        return (f"Mesh({[lane.name for lane in self.lanes]}"
                f"{f', rank {self.rank}/{self.world}' if self.group else ''})")


class Replicated(dict):
    """A tensor that every lane reads, held once per distinct device of
    the mesh: {device: tensor}."""


def make_mesh(n_devices: Optional[int] = None, device=None) -> Mesh:
    """A mesh over the first `n_devices` cards ("cuda:i"; every visible
    card by default), or, with `device` given as a device with an index
    or as "cpu", `n_devices` logical lanes (1 by default) on that one
    device."""
    if device is not None and str(device) != "cuda":
        return Mesh([_device(device)] * (n_devices or 1))
    if not torch.cuda.is_available():
        raise RuntimeError("make_mesh: no CUDA device is visible (pass "
                           "device='cpu' for logical lanes on the CPU)")
    count = torch.cuda.device_count()
    n = count if n_devices is None else n_devices
    if n > count:
        raise ValueError(f"make_mesh: {n} cards asked for, {count} visible")
    return Mesh([torch.device("cuda", i) for i in range(n)])


# -- placement -------------------------------------------------------------------

def _on_device(device: torch.device):
    """The lane's device as the current one while its work is issued."""
    return torch.cuda.device(device) if device.type == "cuda" \
        else nullcontext()


def _to(t, device: torch.device):
    """A replicated operand's copy on `device`, or a tensor moved there
    (a no-op on its own device)."""
    if isinstance(t, Replicated):
        return t[device]
    return t.to(device, non_blocking=True)


def _shard(t: torch.Tensor, sl: slice, device: torch.device,
           axis_index: int = 0) -> torch.Tensor:
    """A lane's contiguous shard of a block along `axis_index`."""
    if axis_index:
        t = t.narrow(axis_index, sl.start, sl.stop - sl.start).contiguous()
    else:
        t = t[sl]
    return t.to(device, non_blocking=True)


def gather_lanes(mesh: Mesh, t: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """`t` of every process of the mesh, concatenated along `dim` in rank
    order: one torch.distributed.all_gather (NCCL on CUDA tensors, gloo
    on the CPU); `t` itself in a mesh of one process without a group."""
    if mesh.group is None:
        return t
    import torch.distributed as dist

    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(mesh.world)]
    dist.all_gather(parts, t, group=mesh.group)
    return torch.cat(parts, dim)


def agree(mesh: Mesh, ok: bool) -> bool:
    """Whether `ok` holds in every process of the mesh: one
    torch.distributed all_reduce (MIN) of a flag on the mesh's first
    device; `ok` itself in a mesh of one process without a group."""
    if mesh.group is None:
        return ok
    import torch.distributed as dist

    flag = torch.tensor([int(ok)], dtype=torch.int32, device=mesh.home)
    dist.all_reduce(flag, op=dist.ReduceOp.MIN, group=mesh.group)
    return bool(flag.item())


def _cat_home(mesh: Mesh, parts: Sequence[torch.Tensor]) -> torch.Tensor:
    """Per-lane outputs as one block on the mesh's first device."""
    return torch.cat([p.to(mesh.home, non_blocking=True) for p in parts])


def _combine_replicated(mesh: Mesh, curve, partials: Sequence[Point]
                        ) -> Point:
    """Stack the lanes' partial sums (each with a leading axis of 1) on
    the first device, gather every process's (one all_gather of the
    stacked coordinates), and finish with one tree sum: the same sum in
    every process."""
    stacked = torch.stack([_cat_home(mesh, [p[i] for p in partials])
                           for i in range(3)])
    flat = gather_lanes(mesh, stacked, dim=1)
    return curve.tree_sum(Point(flat[0], flat[1], flat[2]))


def _lanes_run(mesh: Mesh, n: int, body, sharded: Sequence[torch.Tensor],
               replicated: Sequence = (), axis1: Sequence[torch.Tensor] = ()):
    """body(lane shards..., axis-1 shards..., replicated operands...) on
    each lane, under its device, one lane after the other.  Returns the
    per-lane results."""
    out = []
    for lane, sl in mesh.shards(n):
        dev_ = lane.device
        with _on_device(dev_):
            args = [_shard(t, sl, dev_) for t in sharded]
            args += [_shard(t, sl, dev_, 1) for t in axis1]
            args += [_to(t, dev_) for t in replicated]
            out.append(body(*args))
    return out


# -- per-lane bodies (the single-card bodies without their affine finish) -------

def _verify_partials(x, sign, inf, ok, wpacked, rows, pkx, pky, pkz):
    bits, valid, g1 = card._g1_partial(x, sign, inf, ok, wpacked)
    return g1, valid, card._g2_partial(bits, valid, rows, pkx, pky, pkz)


def _verify_multi_partials(x, sign, inf, ok, wpacked, rows, gmask,
                           pkx, pky, pkz):
    bits, valid, g1 = card._g1_partial(x, sign, inf, ok, wpacked)
    return g1, valid, card._g2_partial_multi(bits, valid, rows, gmask,
                                             pkx, pky, pkz)


# -- the sharded functions ---------------------------------------------------------

def verify_round_combine(mesh: Mesh, parts, groups: int = 0) -> tuple:
    """The combine half of a verify round: the D lanes' (G1 partial,
    validity, G2 partial), as sharded_verify_round_local returns them,
    as the round's outputs.  Each group's partials stack on the first
    device (one all_gather across processes) and tree-sum once, the
    validity gathers there, and the sums leave as strict affine limbs
    (`groups` G2 sums of a k-hash round, else one)."""
    g1 = _combine_replicated(mesh, dev.G1, [p[0] for p in parts])
    g2 = _combine_replicated(mesh, dev.G2, [p[2] for p in parts])
    valid = _cat_home(mesh, [p[1] for p in parts])
    return tuple(card._g1_outs(g1) + [valid] + card._g2_outs(g2, groups))


def sharded_verify_round(mesh: Mesh):
    """The fused verification round over the mesh (the sharded twin of
    crypto/cuda_provider.py verify_round): signature lanes, packed
    weights and pubkey-row indices shard, the pubkey cache is replicated
    so each lane gathers its rows locally, and the D partial MSM points
    of each group combine once.  Returns strict replicated aggregates
    and the block's validity: (ax, ay, ainf, valid, gx, gy, ginf)."""
    local = sharded_verify_round_local(mesh)

    def fn(*args):
        return verify_round_combine(mesh, local(*args))

    return fn


def sharded_verify_round_local(mesh: Mesh):
    """The collective-free twin of sharded_verify_round: the same per-lane
    work (weight unpack, G1 validate and partial MSM, pubkey gather and
    partial G2 MSM) and no combine.  Returns each lane's (G1 partial,
    validity, G2 partial), on its lane's device; verify_round_combine
    finishes them into sharded_verify_round's outputs.  The pair exists
    for the staged mesh probe (crypto/cuda_provider.py
    profile_sharded_stages), which times each half alone."""

    def fn(x, sign, inf, ok, wpacked, rows, pkx, pky, pkz):
        return _lanes_run(mesh, x.shape[0], _verify_partials,
                          (x, sign, inf, ok, wpacked, rows),
                          (pkx, pky, pkz))

    return fn


def sharded_verify_round_multi(mesh: Mesh):
    """The k-hash verification round over the mesh (the sharded twin of
    crypto/cuda_provider.py verify_round_multi): the (k, B) group mask
    shards along its lane axis with the batch, and the (1, k) G2 partials
    combine as one stack.  One function serves every k."""

    def fn(x, sign, inf, ok, wpacked, rows, gmask, pkx, pky, pkz):
        k = gmask.shape[0]
        parts = _lanes_run(mesh, x.shape[0], _verify_multi_partials,
                           (x, sign, inf, ok, wpacked, rows),
                           (pkx, pky, pkz), axis1=(gmask,))
        return verify_round_combine(mesh, parts, k)

    return fn


def _miller_partial(px, py, p_inf, qx, qy, q_inf, mask):
    if px.shape[0] == 0:  # fewer pairs than lanes: this lane adds one
        return pairing_ops.FQ12.one(px.device)
    return pairing_ops.miller_product(px, py, p_inf, qx, qy, q_inf, mask)


def _miller_partials(mesh: Mesh, pairs: Sequence[torch.Tensor]):
    """Each lane's Fq12 partial with a leading axis of 1."""
    return [p[None] for p in _lanes_run(mesh, pairs[0].shape[0],
                                        _miller_partial, pairs)]


def miller_combine(mesh: Mesh, parts) -> torch.Tensor:
    """The combine half of sharded_miller_product: stack the D Miller
    partials (sharded_miller_partial_local's) on the first device (one
    all_gather across processes) and tree-multiply them (fq12_mul)."""
    g = gather_lanes(mesh, torch.cat(
        [p.to(mesh.home, non_blocking=True) for p in parts]))
    return pairing_ops.fq12_tree_product(g, pairing_ops.fq12_mul)


def sharded_miller_product(mesh: Mesh):
    """Stage 1 of the mesh pairing verdict (the sharded twin of
    ops/pairing.py miller_product): pairs shard over the lanes, each lane
    runs the Miller loops of its shard and tree-multiplies them to one
    Fq12 partial, and the D partials stack (one all_gather across
    processes) into one Fq12 tree product (fq12_mul).  Masked and
    infinity pairs contribute one."""

    def fn(px, py, p_inf, qx, qy, q_inf, mask):
        return miller_combine(mesh, _miller_partials(
            mesh, (px, py, p_inf, qx, qy, q_inf, mask)))

    return fn


def sharded_final_is_one(mesh: Mesh):
    """Stage 2 of the mesh pairing verdict (the sharded twin of
    ops/pairing.py final_is_one): one shared final exponentiation and the
    == 1 test over the combined Miller product, on the mesh's first
    device; no collective."""

    def fn(f):
        with _on_device(mesh.home):
            return pairing_ops.final_is_one(f.to(mesh.home))

    return fn


def sharded_multi_pairing_is_one(mesh: Mesh):
    """The mesh twin of ops/pairing.py multi_pairing_is_one_staged: the
    two stages above back to back — the kernel pair _MeshKernels hands
    the provider."""
    miller = sharded_miller_product(mesh)
    final = sharded_final_is_one(mesh)

    def fn(px, py, p_inf, qx, qy, q_inf, mask):
        return final(miller(px, py, p_inf, qx, qy, q_inf, mask))

    return fn


def sharded_miller_partial_local(mesh: Mesh):
    """The collective-free twin of sharded_miller_product: each lane's
    Miller loops and local Fq12 tree product, no combine and no final
    exponentiation.  Returns the per-lane partials, each (1, 2, 3, 2, n)
    on its lane's device; miller_combine finishes them into
    sharded_miller_product's output.  For the staged mesh probe."""

    def fn(px, py, p_inf, qx, qy, q_inf, mask):
        return _miller_partials(mesh, (px, py, p_inf, qx, qy, q_inf, mask))

    return fn




def sharded_g2_sum_rows(mesh: Mesh):
    """Σ P_i over cached pubkey rows (the QC pubkey aggregate, the sharded
    twin of crypto/cuda_provider.py g2_sum_rows): row indices and mask
    shard, the cache is replicated, the partial sums combine once.
    Returns the strict replicated sum (ax, ay, ainf)."""

    def fn(rows, mask, pkx, pky, pkz):
        parts = _lanes_run(mesh, rows.shape[0], card._g2_rows_partial,
                           (rows, mask), (pkx, pky, pkz))
        return tuple(card._g2_outs(
            _combine_replicated(mesh, dev.G2, parts)))

    return fn


def sharded_g2_validate(mesh: Mesh):
    """Decompress and subgroup-check a G2 pubkey batch with lanes sharded
    over the mesh: data-parallel, no combine.  (x, sign, inf, ok) →
    (px, py, pz, valid) of the block, on the mesh's first device."""

    def fn(x, sign, inf, ok):
        parts = _lanes_run(mesh, x.shape[0], card.g2_validate,
                           (x, sign, inf, ok))
        return tuple(_cat_home(mesh, [p[i] for p in parts])
                     for i in range(4))

    return fn


def sharded_g1_validate_sum(mesh: Mesh):
    """Decompress a G1 signature batch and tree-sum it (the QC signature
    aggregate, the sharded twin of crypto/cuda_provider.py
    g1_validate_sum) over the mesh.  Returns the strict replicated sum
    and the block's validity: (ax, ay, ainf, valid)."""

    def fn(x, sign, inf, ok):
        parts = _lanes_run(mesh, x.shape[0], card._g1_sum_partial,
                           (x, sign, inf, ok))
        agg = _combine_replicated(mesh, dev.G1, [p[0] for p in parts])
        return tuple(card._g1_outs(agg)
                     + [_cat_home(mesh, [p[1] for p in parts])])

    return fn


def round_step(sx, ssign, sinf, sok, px, py, pz, bits):
    """The full per-round crypto step on one device (the body of the JAX
    package's sharded_round_step): validate N vote signatures, reduce
    Σ r_i·S_i (G1) and Σ r_i·P_i (G2) for the batch relation, and the
    plain signature sum for the QC (reference src/consensus.rs:418-462).
    Returns (g1_rlc, g2_rlc, qc_agg) as strict affine triples and the
    validity; the JAX step returns its affine coordinates unreduced."""
    return sharded_round_step(Mesh([sx.device]))(
        sx, ssign, sinf, sok, px, py, pz, bits)


def _round_partials(sx, ssign, sinf, sok, px, py, pz, bits):
    pt, valid = dev.g1_decompress_device(sx, ssign, sinf, sok)
    valid = valid & ~sinf & dev.g1_in_subgroup(pt)
    pt = dev.G1.select(valid, pt, dev.G1.infinity_like(sx))
    return (dev.G1.msm_bits(pt, bits),
            dev.G2.msm_bits(Point(px, py, pz), bits),
            dev.G1.tree_sum(pt), valid)


def sharded_round_step(mesh: Mesh):
    """round_step over the mesh: every operand shards (the pubkeys arrive
    per lane here, not as a cache), and the three sums combine once each.
    (sig_x, sig_sign, sig_inf, sig_ok, pk_x, pk_y, pk_z, bits) →
    (g1_rlc, g2_rlc, qc_agg as strict affine (x, y, inf), valid)."""

    def fn(sx, ssign, sinf, sok, px, py, pz, bits):
        parts = _lanes_run(mesh, sx.shape[0], _round_partials,
                           (sx, ssign, sinf, sok, px, py, pz, bits))
        g1 = _combine_replicated(mesh, dev.G1, [p[0] for p in parts])
        g2 = _combine_replicated(mesh, dev.G2, [p[1] for p in parts])
        qc = _combine_replicated(mesh, dev.G1, [p[2] for p in parts])
        valid = _cat_home(mesh, [p[3] for p in parts])
        return tuple(card._g1_outs(g1) + card._g2_outs(g2)
                     + card._g1_outs(qc) + [valid])

    return fn
