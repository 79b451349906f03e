"""CudaBlsCrypto (consensus_overlord_tpu_torch/crypto/cuda_provider.py) on
the CPU against the JAX package's CpuBlsCrypto: verdict for verdict on
valid, invalid, malformed, unknown-voter, wrong-signer, order-3 and
mixed-hash batches; the pubkey cache carried over from a JAX provider;
and the port's import boundary (no jax, nothing of the JAX package).

device_threshold=1 sends every batch through the device path, which on
CPU tensors runs each kernel's plain version."""

import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from consensus_overlord_tpu.core.sm3 import sm3_hash
from consensus_overlord_tpu.crypto import bls12381 as joracle
from consensus_overlord_tpu.crypto.provider import CpuBlsCrypto
from consensus_overlord_tpu_torch.convert import pubkey_cache_from_jax
from consensus_overlord_tpu_torch.crypto.cuda_provider import CudaBlsCrypto

# One intra-op thread: several worker processes share the cores.
torch.set_num_threads(1)

N = 8
KEYS = [0x1111 * (i + 1) + 7 for i in range(N)]
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def cpus():
    return [CpuBlsCrypto(k) for k in KEYS]


@pytest.fixture(scope="module")
def port(cpus):
    p = CudaBlsCrypto(KEYS[0], device_threshold=1, device="cpu")
    p.update_pubkeys([c.pub_key for c in cpus])  # device-path validation
    return p


def votes(cpus, msg=b"block-hash-1"):
    h = sm3_hash(msg)
    return [c.sign(h) for c in cpus], [h] * len(cpus), [c.pub_key
                                                         for c in cpus]


def reference(cpus, sigs, hashes, voters):
    return [cpus[0].verify_signature(s, h, v)
            for s, h, v in zip(sigs, hashes, voters)]


def torsion_lane(sig: bytes) -> bytes:
    """sig + (0, 2): the order-3 component a batched-by-linearity
    subgroup check would let through (TestSubgroupAttack)."""
    return joracle.g1_compress(joracle.g1_add(joracle.g1_decompress(sig),
                                              (0, 2)))


def test_valid_and_invalid_lanes_pipelined(cpus, port):
    """Two batches in flight: all valid, and one whose invalid lanes the
    device masks (malformed, short, undecodable voter, order-3
    component) so the batch relation still holds."""
    sigs, hashes, voters = votes(cpus)
    bad_sigs, bad_voters = list(sigs), list(voters)
    bad_sigs[0] = b"\x00" * 48           # compressed flag missing
    bad_sigs[1] = b"short"
    bad_voters[3] = b"\x01" * 96         # not a pubkey encoding
    bad_sigs[6] = torsion_lane(sigs[6])
    r1 = port.verify_batch_async(sigs, hashes, voters)
    r2 = port.verify_batch_async(bad_sigs, hashes, bad_voters)
    assert r1() == [True] * N
    got = r2()
    assert got == reference(cpus, bad_sigs, hashes, bad_voters)
    assert got == [False, False, True, False, True, True, False, True]


def test_failed_relation_localizes_exactly(cpus, port):
    """Wrong signers and a wrong-message lane break the batch relation;
    the per-lane fallback must give the oracle's verdicts."""
    sigs, hashes, voters = votes(cpus, b"block-hash-2")
    sigs[4], sigs[5] = sigs[5], sigs[4]
    sigs[2] = cpus[2].sign(sm3_hash(b"other"))
    sigs[7] = torsion_lane(sigs[7])
    got = port.verify_batch(sigs, hashes, voters)
    assert got == reference(cpus, sigs, hashes, voters)
    assert got == [True, True, False, True, False, False, True, False]


def test_three_hash_batch(cpus, port):
    h1, h2, h3 = (sm3_hash(m) for m in (b"y1", b"y2", b"y3"))
    hashes = [h1, h1, h2, h2, h3, h3, h1, h2]
    sigs = [c.sign(h) for c, h in zip(cpus, hashes)]
    sigs[3] = cpus[3].sign(sm3_hash(b"evil"))
    voters = [c.pub_key for c in cpus]
    got = port.verify_batch(sigs, hashes, voters)
    assert got == reference(cpus, sigs, hashes, voters)
    assert got.count(False) == 1


def test_many_hashes_split_and_threshold(cpus):
    """More hashes than the fused ladder split into single-hash
    sub-batches; below device_threshold the host oracle answers."""
    p = CudaBlsCrypto(KEYS[0], device_threshold=2, device="cpu")
    hashes = [sm3_hash(bytes([i])) for i in range(5)]
    sigs = [c.sign(h) for c, h in zip(cpus, hashes)]
    sigs[2] = sigs[3]
    voters = [c.pub_key for c in cpus[:5]]
    got = p.verify_batch(sigs, hashes, voters)
    assert got == reference(cpus, sigs, hashes, voters)
    assert got == [True, True, False, True, True]
    assert p.verify_batch([], [], []) == []


def test_pubkey_cache_from_jax(cpus):
    """A JAX provider's host-validated cache carries over bit for bit and
    gives the same verdicts, a known-bad key included."""
    from consensus_overlord_tpu.crypto.tpu_provider import TpuBlsCrypto

    voters = [c.pub_key for c in cpus] + [b"\x02" * 96]
    jax_prov = TpuBlsCrypto(KEYS[0], device_threshold=10**6)
    jax_prov._update_pubkeys_host(voters)
    cache = pubkey_cache_from_jax(jax_prov._pk_px, jax_prov._pk_py,
                                  jax_prov._pk_pz, jax_prov._pk_index)
    assert cache.aff == jax_prov._pk_aff
    p = CudaBlsCrypto(KEYS[0], device_threshold=1, device="cpu")
    p.load_pubkey_cache(cache)
    sigs, hashes, _ = votes(cpus, b"carried")
    sigs = sigs + [sigs[0]]
    hashes = hashes + [hashes[0]]
    sigs[1] = sigs[0]
    got = p.verify_batch(sigs, hashes, voters)
    assert got == reference(cpus, sigs, hashes, voters)
    assert p._pk.index == jax_prov._pk_index  # nothing was re-validated


@pytest.mark.parametrize("text", ["0x{:064x}\n", "{:064x}"])
def test_cpu_provider_from_file_matches_jax(tmp_path, text):
    """CpuBlsCrypto.from_file reads the reference's hex key file (with or
    without 0x) into the same key as the JAX package's from_file."""
    from consensus_overlord_tpu_torch.crypto.provider import (
        CpuBlsCrypto as PortCpuBlsCrypto)

    path = tmp_path / "private_key"
    path.write_text(text.format(KEYS[3]))
    port = PortCpuBlsCrypto.from_file(str(path))
    assert port.pub_key == CpuBlsCrypto.from_file(str(path)).pub_key
    assert port.pub_key == PortCpuBlsCrypto(KEYS[3]).pub_key


def test_cuda_device_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        CudaBlsCrypto(KEYS[0])


def test_port_imports_neither_jax_nor_the_jax_package():
    """Importing every module of the port leaves jax and the JAX package
    out of sys.modules, and no source file names them in an import; nor
    prometheus_client or google.protobuf, and grpc only inside a function
    of service/rpc.py (the gRPC wire, built on demand).  Every module
    imports with grpc, prometheus_client and google.protobuf blocked."""
    pkg = os.path.join(REPO, "consensus_overlord_tpu_torch")
    rpc = os.path.join(pkg, "service", "rpc.py")
    modules = []
    for root, dirs, files in os.walk(pkg):
        dirs[:] = [d for d in dirs if d != "_build"]  # build outputs
        for f in files:
            if not f.endswith(".py"):
                continue
            path = os.path.join(root, f)
            rel = os.path.relpath(path, REPO)[:-3].replace(os.sep, ".")
            modules.append(rel.removesuffix(".__init__"))
            with open(path, encoding="utf-8") as fh:
                tree = ast.parse(fh.read())
            top_level = set(map(id, tree.body))
            for node in ast.walk(tree):
                names = ([a.name for a in node.names]
                         if isinstance(node, ast.Import) else
                         [node.module or ""]
                         if isinstance(node, ast.ImportFrom) else [])
                for name in names:
                    top = name.split(".")[0]
                    assert top not in ("jax", "jaxlib", "consensus_overlord_tpu",
                                       "prometheus_client", "google"), (
                        path, name)
                    if top == "grpc":
                        assert path == rpc and id(node) not in top_level, (
                            path, name)
    for module in ("consensus_overlord_tpu_torch.analysis",
                   "consensus_overlord_tpu_torch.analysis.__main__",
                   "consensus_overlord_tpu_torch.analysis.core",
                   "consensus_overlord_tpu_torch.analysis.rules_conc",
                   "consensus_overlord_tpu_torch.analysis.rules_cuda",
                   "consensus_overlord_tpu_torch.analysis.rules_obs",
                   "consensus_overlord_tpu_torch.analysis.rules_sim",
                   "consensus_overlord_tpu_torch.compile_cache",
                   "consensus_overlord_tpu_torch.crypto.breaker",
                   "consensus_overlord_tpu_torch.crypto.cuda_provider",
                   "consensus_overlord_tpu_torch.crypto.ecdsa_cuda",
                   "consensus_overlord_tpu_torch.crypto.ed25519_cuda",
                   "consensus_overlord_tpu_torch.crypto.tenancy",
                   "consensus_overlord_tpu_torch.ops.edwards",
                   "consensus_overlord_tpu_torch.ops.weierstrass",
                   "consensus_overlord_tpu_torch.engine.smr",
                   "consensus_overlord_tpu_torch.obs.anomaly",
                   "consensus_overlord_tpu_torch.obs.causal",
                   "consensus_overlord_tpu_torch.obs.fleet",
                   "consensus_overlord_tpu_torch.obs.ledger",
                   "consensus_overlord_tpu_torch.obs.logctx",
                   "consensus_overlord_tpu_torch.obs.metrics",
                   "consensus_overlord_tpu_torch.obs.prof",
                   "consensus_overlord_tpu_torch.obs.telemetry",
                   "consensus_overlord_tpu_torch.parallel",
                   "consensus_overlord_tpu_torch.parallel.multihost",
                   "consensus_overlord_tpu_torch.parallel.sharded",
                   "consensus_overlord_tpu_torch.parallel.supervisor",
                   "consensus_overlord_tpu_torch.service.brain",
                   "consensus_overlord_tpu_torch.service.config",
                   "consensus_overlord_tpu_torch.service.consensus",
                   "consensus_overlord_tpu_torch.service.main",
                   "consensus_overlord_tpu_torch.service.pb."
                   "consensus_overlord_pb2",
                   "consensus_overlord_tpu_torch.service.rpc",
                   "consensus_overlord_tpu_torch.service.server",
                   "consensus_overlord_tpu_torch.sim.chaos",
                   "consensus_overlord_tpu_torch.sim.grpc_fakes",
                   "consensus_overlord_tpu_torch.sim.harness",
                   "consensus_overlord_tpu_torch.sim.multichain",
                   "consensus_overlord_tpu_torch.sim.run"):
        assert module in modules, module
    code = ("import importlib, sys\n"
            "for m in ('grpc', 'prometheus_client', 'google.protobuf'):\n"
            "    sys.modules[m] = None\n"
            f"for m in {sorted(modules)!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = [m for m, v in sys.modules.items() if v is not None and "
            "(m.split('.')[0] in ('jax', 'jaxlib', 'consensus_overlord_tpu',"
            " 'grpc', 'prometheus_client') or "
            "m.startswith('google.protobuf'))]\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_provider_satisfies_the_crypto_provider_protocol():
    """CudaBlsCrypto has every member of the port's CryptoProvider (the
    JAX package's crypto/provider.py:31-52, copied), each method with the
    same signature, and the port's protocol names the JAX one's members."""
    import inspect

    from consensus_overlord_tpu.crypto import provider as jprovider
    from consensus_overlord_tpu_torch.crypto.provider import CryptoProvider

    members = [m for m in vars(CryptoProvider)
               if not m.startswith("_")]
    assert sorted(members) == sorted(
        m for m in vars(jprovider.CryptoProvider) if not m.startswith("_"))
    assert len(members) == 6
    for m in members:
        want = getattr(CryptoProvider, m)
        got = getattr(CudaBlsCrypto, m)
        if isinstance(want, property):
            assert isinstance(got, property), m
        else:
            assert inspect.signature(got) == inspect.signature(want), m
    assert isinstance(CudaBlsCrypto(KEYS[0], device="cpu"), CryptoProvider)


@pytest.mark.slow
def test_verify_round_matches_jax_verify_round_fn(cpus, port):
    """The device round, output for output, against the JAX package's
    verify_round_fn at B = 8 on the same inputs, run op by op (its whole
    CPU compile as one jit costs more than that run; integer results do
    not depend on the mode)."""
    import jax.numpy as jnp

    from consensus_overlord_tpu.crypto.tpu_provider import verify_round_fn
    from consensus_overlord_tpu_torch.crypto.cuda_provider import (
        verify_round)

    sigs, _, voters = votes(cpus, b"round")
    sigs[2] = torsion_lane(sigs[2])
    (_, sx, ssign, sinf, sok, wpacked, rows,
     _) = port._host_prep(sigs, voters, N)
    pk = port._pk_device()
    ins = (sx, ssign, sinf, sok, wpacked, rows) + pk
    want = verify_round_fn(*(jnp.asarray(t.numpy()) for t in ins))
    got = verify_round(*ins)
    for w, g in zip(want, got):
        assert np.array_equal(np.asarray(w), g.numpy())


def _off_subgroup_points(rng, group):
    """Seeded points on the curve (G1: y² = x³ + 4 over Fq; G2: the
    twist over Fq2) that are almost surely outside the prime-order
    subgroup: x drawn at random until x³ + b is a square."""
    pts = []
    while len(pts) < 3:
        if group == "g1":
            x = int(rng.integers(1, 2**62)) * 7919
            y = joracle.fq_sqrt((x ** 3 + 4) % joracle.P)
        else:
            x = (int(rng.integers(1, 2**62)), int(rng.integers(1, 2**62)))
            b = joracle.fq2_mul_xi((4, 0))
            y = joracle.fq2_sqrt(joracle.fq2_add(
                joracle.fq2_mul(joracle.fq2_sq(x), x), b))
        if y is not None:
            pts.append((x, y))
    return pts


@pytest.mark.parametrize("group", ["g1", "g2"])
def test_oracle_scalar_multiply_matches_the_jax_oracle(group):
    """The port's oracle multiplies by a Jacobian ladder (one inversion a
    multiply); its products, generators' multiples and subgroup verdicts
    equal the JAX package's affine double-and-add, at edge scalars
    (0, 1, r − 1, r, r + 1, negative) and seeded ones, on points in and
    outside the subgroup and at infinity."""
    from consensus_overlord_tpu_torch.crypto import bls12381 as oracle

    rng = np.random.default_rng(21 if group == "g1" else 22)
    mul, jmul = getattr(oracle, f"{group}_mul"), getattr(joracle,
                                                        f"{group}_mul")
    ops = oracle._FQ_OPS if group == "g1" else oracle._FQ2_OPS
    gen = getattr(joracle, f"{group.upper()}_GEN")
    off = _off_subgroup_points(rng, group)
    scalars = [0, 1, 2, oracle.R - 1, oracle.R, oracle.R + 1, -3] + [
        int.from_bytes(rng.bytes(32), "big") for _ in range(4)]
    for k in scalars:
        assert mul(gen, k) == jmul(gen, k), k
        for pt in off + [None]:
            assert oracle._pt_mul(pt, k, ops) == \
                oracle._pt_mul_affine(pt, k, ops), k
    in_sub = getattr(oracle, f"{group}_in_subgroup")
    j_in_sub = getattr(joracle, f"{group}_in_subgroup")
    for pt in off + [gen, jmul(gen, 77), None]:
        assert in_sub(pt) == j_in_sub(pt)
    assert not any(in_sub(pt) for pt in off)
