"""The port's multi-process mesh (consensus_overlord_tpu_torch/parallel/
multihost.py): the one-process contract of the JAX package's
tests/test_multihost.py (no coordinator → one process, the global mesh is
make_mesh's, a provider over either gives the same verdicts), and a
two-process run on the gloo backend: two OS processes, two logical CPU
lanes each, join one torch.distributed group over a local coordinator and
run sharded_verify_round over a batch spanning both, each holding the
combined aggregates against the host oracle; and a fault on one rank of
such a group (an injected breaker fault, a lost lane), after which both
ranks finish with the exact verdicts.  This file is also the worker:
`python test_torch_multihost.py round|faults RANK WORLD HOST:PORT`.
Tolerance: none (exact)."""

import os
import socket
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def worker(rank: int, world: int, coordinator: str) -> None:
    sys.path.insert(0, REPO)
    import numpy as np
    import torch

    torch.set_num_threads(1)
    from consensus_overlord_tpu_torch.core.sm3 import sm3_hash
    from consensus_overlord_tpu_torch.crypto import bls12381 as oracle
    from consensus_overlord_tpu_torch.ops import bls12381_groups as dev
    from consensus_overlord_tpu_torch.parallel import (
        global_mesh, host_shard_array, init_multihost, multihost,
        sharded_verify_round)

    assert init_multihost(coordinator, world, rank, timeout_s=60.0)
    assert multihost.process_count() == world
    mesh = global_mesh(2, device="cpu")
    assert mesh.size == 2 * world and mesh.rank == rank
    assert mesh.names()[2 * rank] == f"p{rank}/cpu:0/0"
    # Both processes build the same batch; each feeds its own block.
    batch = 4 * world
    h = sm3_hash(b"two-process-block")
    sks = [9000 + 17 * i for i in range(batch)]
    sigs = [oracle.sign(sk, h) for sk in sks]
    pks_aff = [oracle.g2_decompress(oracle.sk_to_pk(sk)) for sk in sks]
    parsed = dev.parse_g1_compressed(sigs)
    scalars = [(0x9E3779B9 * (i + 1)) | (1 << 63) for i in range(batch)]
    wpacked = np.frombuffer(b"".join(s.to_bytes(8, "big") for s in scalars),
                            np.uint8).reshape(batch, 8).copy()
    pk = dev.g2_from_oracle(pks_aff)

    def shard(a):
        return host_shard_array(mesh, a)

    out = sharded_verify_round(mesh)(
        shard(parsed.x), shard(parsed.sign), shard(parsed.infinity),
        shard(parsed.wellformed), shard(wpacked),
        shard(np.arange(batch, dtype=np.int64)),
        *(host_shard_array(mesh, c.numpy(), replicated=True) for c in pk))
    ax, ay, ainf, valid, gx, gy, ginf = out
    assert valid.tolist() == [True] * (batch // world)  # this block only
    want = None
    for s, r in zip(sigs, scalars):
        want = oracle.g1_add(want, oracle.g1_mul(oracle.g1_decompress(s), r))
    assert (dev.FQ.ints_from_strict(ax.numpy())[0],
            dev.FQ.ints_from_strict(ay.numpy())[0]) == want
    want2 = None
    for p, r in zip(pks_aff, scalars):
        want2 = oracle.g2_add(want2, oracle.g2_mul(p, r))
    assert (tuple(dev.FQ.ints_from_strict(gx.numpy())),
            tuple(dev.FQ.ints_from_strict(gy.numpy()))) == want2
    torch.distributed.destroy_process_group()
    print("GROUP-OK", flush=True)


def fault_worker(rank: int, world: int, coordinator: str) -> None:
    """A provider over a 2-process global mesh (one CPU lane each): an
    injected fault on rank 1 alone sends the whole group to the host for
    that call (the route is agreed, so rank 0 never waits in a
    collective rank 1 skipped), clearing it brings both back to the
    mesh, and a lane lost on rank 1 fails only its readback, after the
    collectives, so rank 1 re-verifies on the host and rank 0 takes the
    device's verdicts.  The ladder is refused on such a mesh."""
    sys.path.insert(0, REPO)
    import torch

    torch.set_num_threads(1)
    from consensus_overlord_tpu_torch.core.sm3 import sm3_hash
    from consensus_overlord_tpu_torch.crypto import bls12381 as oracle
    from consensus_overlord_tpu_torch.crypto import cuda_provider
    from consensus_overlord_tpu_torch.parallel import (
        global_mesh, init_multihost)

    cuda_provider._SCALAR_BITS = 8
    assert init_multihost(coordinator, world, rank, timeout_s=60.0)
    mesh = global_mesh(1, device="cpu")
    prov = cuda_provider.CudaBlsCrypto(
        0xD1CE, device_threshold=1, qc_device_threshold=10**9, mesh=mesh)
    assert prov.multiprocess_mesh
    try:
        prov.attach_supervisor(object())
        raise AssertionError("a supervisor was attached to a group mesh")
    except ValueError:
        pass
    batch = 4
    h = sm3_hash(b"two-process-faults")
    sks = [5000 + 11 * i for i in range(batch)]
    sigs = [oracle.sign(sk, h) for sk in sks]
    pks = [oracle.sk_to_pk(sk) for sk in sks]
    sigs[1] = oracle.sign(sks[1], sm3_hash(b"tampered"))
    want = [i != 1 for i in range(batch)]
    prov.update_pubkeys(pks)

    def step(device: int, host: int, failures: int) -> None:
        assert prov.verify_batch(sigs, [h] * batch, pks) == want
        assert prov.degraded_status()["calls"]["verify_batch"] == {
            "device": device, "host": host}
        assert prov.breaker.status()["total_failures"] == failures

    if rank == 1:
        prov.breaker.inject_faults(60.0)
    step(0, 1, rank)
    prov.breaker.clear_injected_faults()
    step(1, 1, rank)
    if rank == 1:
        prov.inject_device_loss("p1/cpu:0", 60.0)
    step(2, 1, 2 * rank)
    torch.distributed.destroy_process_group()
    print("GROUP-OK", flush=True)


if __name__ == "__main__":
    {"round": worker, "faults": fault_worker}[sys.argv[1]](
        int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
    sys.exit(0)

import pytest  # noqa: E402
import torch  # noqa: E402

from consensus_overlord_tpu_torch.core.sm3 import sm3_hash  # noqa: E402
from consensus_overlord_tpu_torch.crypto import bls12381 as oracle  # noqa
from consensus_overlord_tpu_torch.crypto import cuda_provider  # noqa: E402
from consensus_overlord_tpu_torch.parallel import (  # noqa: E402
    global_mesh, init_multihost, make_mesh, multihost)


def test_init_without_coordinator_is_single_process(monkeypatch):
    monkeypatch.delenv("CONSENSUS_COORDINATOR_ADDRESS", raising=False)
    assert init_multihost() is False
    assert multihost.process_count() == 1
    assert not torch.distributed.is_initialized()


def test_coordinator_without_its_process_count_fails_loudly(monkeypatch):
    monkeypatch.delenv("CONSENSUS_NUM_PROCESSES", raising=False)
    monkeypatch.delenv("CONSENSUS_PROCESS_ID", raising=False)
    with pytest.raises(ValueError, match="CONSENSUS_NUM_PROCESSES"):
        init_multihost("127.0.0.1:1")


def test_global_mesh_is_make_meshs_mesh_in_one_process():
    glob, local = global_mesh(4, device="cpu"), make_mesh(4, device="cpu")
    assert glob.group is None
    assert glob.names() == local.names() == [f"cpu:0/{i}" for i in range(4)]
    assert glob.devices == local.devices and list(glob.lanes) == list(
        local.lanes)


def test_provider_verdicts_identical_over_global_mesh(monkeypatch):
    """A provider over global_mesh() and one over make_mesh() (one
    process: the same lanes) give the same verdicts, a forged lane
    localized."""
    monkeypatch.setattr(cuda_provider, "_SCALAR_BITS", 8)
    torch.set_num_threads(1)
    batch = 4
    h = sm3_hash(b"global-mesh-degenerate")
    sks = [7000 + 13 * i for i in range(batch)]
    sigs = [oracle.sign(sk, h) for sk in sks]
    pks = [oracle.sk_to_pk(sk) for sk in sks]
    sigs[1] = oracle.sign(sks[1], sm3_hash(b"tampered"))
    verdicts = []
    for mesh in (global_mesh(2, device="cpu"), make_mesh(2, device="cpu")):
        provider = cuda_provider.CudaBlsCrypto(
            0xD1CE, device_threshold=1, qc_device_threshold=10**9,
            mesh=mesh)
        provider.update_pubkeys(pks)
        verdicts.append(provider.verify_batch(sigs, [h] * batch, pks))
        assert provider.degraded_status()["calls"]["verify_batch"] == {
            "device": 1, "host": 0}
    assert verdicts[0] == verdicts[1] == [i != 1 for i in range(batch)]


def _run_group(mode: str) -> None:
    """Two worker processes of this file in one gloo group over a local
    coordinator; both must exit 0 with GROUP-OK."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=REPO, CUDA_VISIBLE_DEVICES="")
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), mode, str(i), "2",
         f"127.0.0.1:{port}"], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, env=env) for i in range(2)]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=240)
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, f"worker failed:\n{out[-4000:]}"
        assert "GROUP-OK" in out


def test_two_process_group_verify_round():
    """Two processes × 2 logical CPU lanes in one gloo group: the
    rank-major global mesh, each process feeding its block, one
    all_gather a combine, and both processes' aggregates the oracle's."""
    _run_group("round")


def test_two_process_group_survives_a_fault_on_one_rank():
    """A provider over a two-process gloo mesh with a fault on rank 1
    alone (fault_worker): both ranks finish every call with the exact
    verdicts, none waiting on a collective its peer skipped."""
    _run_group("faults")
