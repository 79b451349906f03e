"""Mesh parallelism for the crypto hot path.

The port's twin of consensus_overlord_tpu/parallel/: signature lanes
shard over a mesh of lanes (parallel/sharded.py `Mesh`: cards, or logical
lanes of one card), each lane validates and locally reduces its shard on
the single-card kernels, and the partial group sums combine once — on one
device within a process, with one torch.distributed.all_gather across
processes (parallel/multihost.py).  The MeshSupervisor
(parallel/supervisor.py) walks a provider's kernel sets down and up a
ladder of meshes when lanes fail.
"""

from .multihost import (  # noqa: F401
    global_mesh,
    host_shard_array,
    init_multihost,
)

_SHARDED = (
    "make_mesh",
    "sharded_final_is_one",
    "sharded_g1_validate_sum",
    "sharded_g2_sum_rows",
    "sharded_g2_validate",
    "sharded_miller_partial_local",
    "sharded_miller_product",
    "sharded_multi_pairing_is_one",
    "sharded_round_step",
    "sharded_verify_round",
    "sharded_verify_round_local",
    "sharded_verify_round_multi",
)

__all__ = ["global_mesh", "host_shard_array", "init_multihost", *_SHARDED]


def __getattr__(name):
    """The sharded functions, from parallel/sharded.py (imported with
    multihost, which builds meshes)."""
    if name in _SHARDED:
        from . import sharded

        return getattr(sharded, name)
    raise AttributeError(name)
