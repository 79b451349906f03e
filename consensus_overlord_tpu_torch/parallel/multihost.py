"""Multi-process initialization for the crypto mesh, on torch.distributed.

The port's twin of consensus_overlord_tpu/parallel/multihost.py.  The
reference scales across machines by running one validator process per
node and exchanging BFT messages through its network microservice (no
collectives).  This package keeps that shape and adds a second,
device-level axis: one verification service's crypto batch sharded over
the cards of several processes.

* Within a process, lanes shard over its cards (or logical lanes of one
  card) and the partial group sums stack on its first card
  (parallel/sharded.py).
* Across processes, `init_multihost` joins one torch.distributed process
  group (NCCL on CUDA, gloo on the CPU) and `global_mesh` orders the
  lanes rank-major, so each combine gathers within a process first and
  then takes one cross-process all_gather.

A deployment that gives each validator its own card needs none of this.
A process group enters when one verification service (a 10k-validator
fleet's QC audit) owns several processes' cards.

Nothing in a machine's environment names a cluster here: the coordinator
address (a `host:port` or `tcp://host:port`), the process count and this
process's rank come from the caller or from CONSENSUS_COORDINATOR_ADDRESS,
CONSENSUS_NUM_PROCESSES and CONSENSUS_PROCESS_ID.  A coordinator without
the other two, or a group that fails to form, raises.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import numpy as np
import torch

from .sharded import Mesh, Replicated, make_mesh


def init_multihost(coordinator_address: Optional[str] = None,
                   num_processes: Optional[int] = None,
                   process_id: Optional[int] = None,
                   backend: Optional[str] = None,
                   timeout_s: float = 300.0) -> bool:
    """Join (or skip joining) a multi-process group.

    Returns True once this process is in a torch.distributed group (also
    when it already was), False for a one-process run (no coordinator
    configured): callers build their mesh with the same functions either
    way.  backend: "nccl" where a card is visible, else "gloo"."""
    import torch.distributed as dist

    coordinator_address = (coordinator_address
                           or os.environ.get("CONSENSUS_COORDINATOR_ADDRESS"))
    if coordinator_address is None:
        return False
    if dist.is_initialized():
        return True
    num_processes = (num_processes if num_processes is not None else
                     _env_int("CONSENSUS_NUM_PROCESSES"))
    process_id = (process_id if process_id is not None else
                  _env_int("CONSENSUS_PROCESS_ID"))
    if num_processes is None or process_id is None:
        raise ValueError(
            f"init_multihost: coordinator {coordinator_address!r} needs the "
            "process count and this process's rank (arguments, or "
            "CONSENSUS_NUM_PROCESSES and CONSENSUS_PROCESS_ID)")
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    init = (coordinator_address if "://" in coordinator_address
            else f"tcp://{coordinator_address}")
    dist.init_process_group(backend, init_method=init,
                            world_size=int(num_processes),
                            rank=int(process_id),
                            timeout=datetime.timedelta(seconds=timeout_s))
    return True


def _env_int(name: str) -> Optional[int]:
    v = os.environ.get(name)
    return int(v) if v else None


def global_mesh(n_devices: Optional[int] = None, device=None) -> Mesh:
    """This process's lanes (make_mesh's arguments) in a mesh over every
    process of the group, rank-major, so the combine gathers within a
    process and then across processes once.  Without a group it is
    make_mesh's mesh."""
    import torch.distributed as dist

    local = make_mesh(n_devices, device)
    if not dist.is_initialized():
        return local
    return Mesh(local.devices,
                names=[lane.name for lane in local.lanes],
                group=dist.group.WORLD)


def process_count() -> int:
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_initialized() else 1


def host_shard_array(mesh: Mesh, local, replicated: bool = False,
                     axis_index: int = 0, put=None):
    """Feed one operand to the mesh's functions.  `local` is the whole
    host-identical array (numpy, or a tensor already on the card), the
    same in every process.  A lane-sharded operand becomes this process's
    contiguous block of its lanes along `axis_index` (1 for the (k, B)
    group mask); replicated=True keeps the whole array, one copy per
    distinct device of the mesh's lanes (a `Replicated`).  `put` uploads
    a host array to the mesh's first device (a plain `.to` by default);
    a tensor moves there with `.to`.  In a one-process mesh a sharded
    operand is one plain device put."""
    if put is None:
        def put(a):
            return torch.as_tensor(a).to(mesh.home)

    def upload(a):
        if isinstance(a, torch.Tensor):
            return a.to(mesh.home, non_blocking=True)
        return put(a)

    if replicated:
        home = upload(local)
        return Replicated({d: home if d == mesh.home
                           else home.to(d, non_blocking=True)
                           for d in mesh.physical_devices()})
    if mesh.world > 1:
        size = local.shape[axis_index]
        if size % mesh.world:
            raise ValueError(f"host_shard_array: {size} lanes do not split "
                             f"over {mesh.world} processes")
        block = size // mesh.world
        index = [slice(None)] * local.ndim
        index[axis_index] = slice(mesh.rank * block, (mesh.rank + 1) * block)
        local = local[tuple(index)]
        if isinstance(local, np.ndarray):
            local = np.ascontiguousarray(local)
        else:
            local = local.contiguous()
    return upload(local)
