"""The port's mesh (consensus_overlord_tpu_torch/parallel/sharded.py) on
8 logical lanes of the CPU, at the JAX package's test_parallel.py shapes
(B = 16, 32-bit scalars): every sharded function against the port's
one-card function on the same inputs (torch.equal: the canonical limbs of
every strict output, and every validity mask) and against the host
oracle, with a batch that splits unevenly and padding that is not a
multiple of the lanes; one of them against the JAX package's sharded
function on conftest's 8 virtual devices.  Then CudaBlsCrypto over a
4-lane mesh against CpuBlsCrypto, the MeshSupervisor's ladder walk over
it, and the service's `mesh` knob.  Tolerance: none (integer
arithmetic, exact verdicts)."""

import random

import numpy as np
import pytest
import torch

from consensus_overlord_tpu_torch.core.sm3 import sm3_hash
from consensus_overlord_tpu_torch.crypto import bls12381 as oracle
from consensus_overlord_tpu_torch.crypto import cuda_provider as card
from consensus_overlord_tpu_torch.crypto.cuda_provider import CudaBlsCrypto
from consensus_overlord_tpu_torch.crypto.provider import CpuBlsCrypto
from consensus_overlord_tpu_torch.ops import bls12381_groups as dev
from consensus_overlord_tpu_torch.ops import pairing as pairing_ops
from consensus_overlord_tpu_torch.ops.curve import int_to_bits_msb_np
from consensus_overlord_tpu_torch.parallel import sharded
from consensus_overlord_tpu_torch.parallel.supervisor import MeshSupervisor

B = 16
NBITS = 32  # short scalars keep the CPU cost down; the code is width-generic
NEG_G2 = (oracle.G2_GEN[0], oracle.fq2_neg(oracle.G2_GEN[1]))


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Plain kernels on tiny tensors: one intra-op thread is fastest."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def mesh8():
    mesh = sharded.make_mesh(8, device="cpu")
    assert mesh.size == 8 and mesh.names()[2] == "cpu:0/2"
    return mesh


@pytest.fixture(scope="module")
def data():
    rng = random.Random(0x5A)
    sks = [rng.randrange(2, oracle.R) for _ in range(B)]
    msgs = [sm3_hash(b"round-msg"), sm3_hash(b"round-msg-2")]
    # Even lanes sign the first message, odd lanes the second.
    sigs = [oracle.sign(sk, msgs[i % 2]) for i, sk in enumerate(sks)]
    pks = [oracle.sk_to_pk(sk) for sk in sks]
    scalars = [rng.randrange(1, 1 << NBITS) for _ in range(B)]
    pks_aff = [oracle.g2_decompress(p) for p in pks]
    return dict(sks=sks, msgs=msgs, sigs=sigs, pks=pks, pks_aff=pks_aff,
                sigs_aff=[oracle.g1_decompress(s) for s in sigs],
                scalars=scalars, pk=dev.g2_from_oracle(pks_aff))


def _g1_ins(sigs):
    parsed = dev.parse_g1_compressed(sigs)
    return [torch.as_tensor(a) for a in (parsed.x, parsed.sign,
                                         parsed.infinity, parsed.wellformed)]


def _wpacked(scalars):
    """32-bit weights packed big-endian, 4 bytes a lane."""
    return torch.as_tensor(np.frombuffer(
        b"".join(r.to_bytes(NBITS // 8, "big") for r in scalars),
        np.uint8).reshape(len(scalars), NBITS // 8).copy())


def _equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def _g1_int(ax, ay, ainf):
    if bool(ainf):
        return None
    return (dev.FQ.ints_from_strict(ax.numpy())[0],
            dev.FQ.ints_from_strict(ay.numpy())[0])


def _g2_int(gx, gy, ginf):
    if bool(ginf):
        return None
    return (tuple(dev.FQ.ints_from_strict(gx.numpy())),
            tuple(dev.FQ.ints_from_strict(gy.numpy())))


def _rlc(add, mul, points, scalars):
    acc = None
    for p, r in zip(points, scalars):
        acc = add(acc, mul(p, r))
    return acc


# -- the sharded functions, 8 lanes --------------------------------------------

def test_sharded_verify_round(data, mesh8):
    """The fused round: 13 live lanes and 3 padding lanes (weight 0,
    disabled) over 8 lanes of 2 — the last two lanes' shards are partly
    and wholly padding."""
    live = 13
    x, sign, inf, ok = _g1_ins(data["sigs"])
    ok[live:] = False
    scalars = data["scalars"][:live] + [0] * (B - live)
    pk = data["pk"]
    ins = (x, sign, inf, ok, _wpacked(scalars), torch.arange(B),
           pk.x, pk.y, pk.z)
    got = sharded.sharded_verify_round(mesh8)(*ins)
    _equal(got, card.verify_round(*ins))
    assert got[3].tolist() == [True] * live + [False] * (B - live)
    assert _g1_int(*got[:3]) == _rlc(oracle.g1_add, oracle.g1_mul,
                                     data["sigs_aff"][:live], scalars)
    assert _g2_int(*got[4:]) == _rlc(oracle.g2_add, oracle.g2_mul,
                                     data["pks_aff"][:live], scalars)


def test_sharded_verify_round_multi(data, mesh8):
    """The 2-hash round over 13 lanes: shards of 2, 2, 2, 2, 2, 1, 1, 1,
    the (k, B) group mask split along its lane axis."""
    n = 13
    ins = _g1_ins(data["sigs"][:n])
    gmask = torch.zeros((2, n), dtype=torch.bool)
    gmask[0, 0::2] = True
    gmask[1, 1::2] = True
    pk = data["pk"]
    args = (*ins, _wpacked(data["scalars"][:n]), torch.arange(n), gmask,
            pk.x, pk.y, pk.z)
    got = sharded.sharded_verify_round_multi(mesh8)(*args)
    _equal(got, card.verify_round_multi(*args))
    assert got[3].all()
    sc = data["scalars"][:n]
    assert _g1_int(*got[:3]) == _rlc(oracle.g1_add, oracle.g1_mul,
                                     data["sigs_aff"][:n], sc)
    for g in range(2):
        assert _g2_int(*got[4 + 3 * g:7 + 3 * g]) == _rlc(
            oracle.g2_add, oracle.g2_mul, data["pks_aff"][g:n:2], sc[g::2])


def test_sharded_round_step(data, mesh8):
    """The full round step: RLC sums of both groups and the plain QC
    signature sum; the lane carrying an infinity signature is invalid."""
    sigs = list(data["sigs"])
    sigs[5] = oracle.g1_compress(None)
    ins = _g1_ins(sigs)
    pk = data["pk"]
    bits = torch.as_tensor(int_to_bits_msb_np(data["scalars"], NBITS))
    args = (*ins, pk.x, pk.y, pk.z, bits)
    got = sharded.sharded_round_step(mesh8)(*args)
    _equal(got, sharded.round_step(*args))
    valid = [i != 5 for i in range(B)]
    assert got[9].tolist() == valid
    sc = [r if v else 0 for r, v in zip(data["scalars"], valid)]
    assert _g1_int(*got[0:3]) == _rlc(oracle.g1_add, oracle.g1_mul,
                                      data["sigs_aff"], sc)
    assert _g2_int(*got[3:6]) == _rlc(oracle.g2_add, oracle.g2_mul,
                                      data["pks_aff"], data["scalars"])
    assert _g1_int(*got[6:9]) == _rlc(oracle.g1_add, oracle.g1_mul,
                                      data["sigs_aff"], [int(v)
                                                         for v in valid])


def test_sharded_g2_validate(data, mesh8):
    """Pubkey validation, data-parallel: a key with a flipped byte is
    invalid, the others decompress to the oracle's points."""
    pks = list(data["pks"])
    pks[9] = pks[9][:20] + bytes([pks[9][20] ^ 1]) + pks[9][21:]
    parsed = dev.parse_g2_compressed(pks)
    ins = [torch.as_tensor(a) for a in (parsed.x, parsed.sign,
                                        parsed.infinity, parsed.wellformed)]
    got = sharded.sharded_g2_validate(mesh8)(*ins)
    _equal(got, card.g2_validate(*ins))
    want_valid = []
    for p in pks:
        try:
            pt = oracle.g2_decompress(p)
        except ValueError:
            pt = None
        want_valid.append(pt is not None and oracle.g2_in_subgroup(pt))
    assert got[3].tolist() == want_valid
    pts = dev.g2_to_oracle(dev.Point(*got[:3]))
    assert [p for p, v in zip(pts, want_valid) if v] == [
        a for a, v in zip(data["pks_aff"], want_valid) if v]


@pytest.fixture(scope="module")
def g1_sum(data, mesh8):
    """The QC signature aggregate's inputs, with a malformed and an
    infinity lane, and the port's sharded output on them (shared by the
    oracle test and the JAX one)."""
    sigs = list(data["sigs"])
    sigs[2] = b"\x00" * 48
    sigs[11] = oracle.g1_compress(None)
    ins = _g1_ins(sigs)
    return ins, sharded.sharded_g1_validate_sum(mesh8)(*ins)


def test_sharded_g1_validate_sum(data, g1_sum):
    """The QC signature aggregate with a malformed and an infinity lane
    (both skipped, as the oracle's sum skips them)."""
    ins, got = g1_sum
    _equal(got, card.g1_validate_sum(*ins))
    want = None
    for i, s in enumerate(data["sigs_aff"]):
        if i not in (2, 11):
            want = oracle.g1_add(want, s)
    assert _g1_int(*got[:3]) == want
    assert not bool(got[3][2])


def test_sharded_g2_sum_rows(data, mesh8):
    """The QC pubkey aggregate over cached rows, rows gathered out of
    order and three lanes masked."""
    rows = torch.as_tensor([(7 * i) % B for i in range(B)])
    mask = torch.as_tensor([i % 5 != 4 for i in range(B)])
    pk = data["pk"]
    args = (rows, mask, pk.x, pk.y, pk.z)
    got = sharded.sharded_g2_sum_rows(mesh8)(*args)
    _equal(got, card.g2_sum_rows(*args))
    want = None
    for r, m in zip(rows.tolist(), mask.tolist()):
        if m:
            want = oracle.g2_add(want, data["pks_aff"][r])
    assert _g2_int(*got) == want


def _pairing_args(pairs, size):
    pad = [None] * (size - len(pairs))
    px, py, pinf = pairing_ops.g1_affine_from_oracle(
        [p for p, _ in pairs] + pad)
    qx, qy, qinf = pairing_ops.g2_affine_from_oracle(
        [q for _, q in pairs] + pad)
    mask = np.arange(size) < len(pairs)
    return [torch.as_tensor(a) for a in (px, py, pinf, qx, qy, qinf, mask)]


@pytest.mark.parametrize("forged", [False, True])
def test_sharded_pairing_verdicts(data, mesh8, forged):
    """The mesh pairing verdict over 8 lanes on 4 pair lanes, so that
    four lanes hold no pair and add one: a signature pair and its hash
    pair, an infinity pair (on the G1 side, or on the G2 side with the
    forged signature) and a padding lane.  Equal to the one-card staged
    pair and to the oracle's multi-pairing."""
    sk = data["sks"][0]
    h = data["msgs"][0]
    sig = data["sigs_aff"][0]
    if forged:
        sig = oracle.g1_mul(sig, 7)  # on the curve, wrong signature
    pk = oracle.g2_decompress(oracle.sk_to_pk(sk))
    h_pt = oracle.hash_to_g1(h, b"")
    pairs = [(sig, NEG_G2), (h_pt, pk),
             (h_pt, None) if forged else (None, pk)]
    args = _pairing_args(pairs, 4)
    got = sharded.sharded_multi_pairing_is_one(mesh8)(*args)
    assert bool(got) == bool(
        pairing_ops.multi_pairing_is_one_staged(*args))
    assert bool(got) is oracle.multi_pairing_is_one(pairs) is (not forged)


def test_local_twins_run(data):
    """The probe's collective-free twins on 2 lanes: per-lane partials on
    their lanes, the validity per lane, and each combine half over them
    gives the full sharded function's outputs."""
    mesh = sharded.make_mesh(2, device="cpu")
    x, sign, inf, ok = _g1_ins(data["sigs"][:2])
    pk = data["pk"]
    args = (x, sign, inf, ok, torch.full((2, 1), 0x81, dtype=torch.uint8),
            torch.arange(2), pk.x, pk.y, pk.z)
    parts = sharded.sharded_verify_round_local(mesh)(*args)
    assert [p[0].x.shape[0] for p in parts] == [1] * 2
    assert [p[2].x.shape[0] for p in parts] == [1] * 2
    assert torch.cat([p[1] for p in parts]).tolist() == [True] * 2
    got = sharded.verify_round_combine(mesh, parts)
    want = sharded.sharded_verify_round(mesh)(*args)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    pargs = _pairing_args([(data["sigs_aff"][0], NEG_G2)], 2)
    parts = sharded.sharded_miller_partial_local(mesh)(*pargs)
    assert [tuple(p.shape[:4]) for p in parts] == [(1, 2, 3, 2)] * 2
    assert torch.equal(sharded.miller_combine(mesh, parts),
                       sharded.sharded_miller_product(mesh)(*pargs))


def test_g1_validate_sum_equals_the_jax_sharded_function(g1_sum):
    """parallel/sharded.py sharded_g1_validate_sum of the JAX package on
    make_mesh(8) (conftest's 8 virtual CPU devices) and the port's on 8
    logical lanes, over the same inputs with a malformed and an infinity
    lane: the same strict limbs and validity."""
    import jax
    import jax.numpy as jnp

    from consensus_overlord_tpu.parallel import make_mesh
    from consensus_overlord_tpu.parallel import (
        sharded_g1_validate_sum as jax_validate_sum)

    assert len(jax.devices()) >= 8
    ins, got = g1_sum
    want = jax_validate_sum(make_mesh(8))(
        *(jnp.asarray(t.numpy()) for t in ins))
    for w, g in zip(want, got):
        assert np.array_equal(np.asarray(w), g.numpy())


# -- the provider over a 4-lane mesh ---------------------------------------------

BATCH = 8
SKS = [7000 + 13 * i for i in range(BATCH)]


@pytest.fixture(scope="module")
def votes():
    h = sm3_hash(b"mesh-provider-block")
    sigs = [oracle.sign(sk, h) for sk in SKS]
    pks = [oracle.sk_to_pk(sk) for sk in SKS]
    bad = list(sigs)
    bad[3] = oracle.sign(SKS[3], sm3_hash(b"other message"))
    return h, sigs, pks, bad


@pytest.fixture(scope="module")
def mesh_provider(votes):
    """CudaBlsCrypto over 4 logical CPU lanes, every key validated on the
    device path (g2_validate over the mesh)."""
    mesh = sharded.make_mesh(4, device="cpu")
    p = CudaBlsCrypto(0xD1CE, device_threshold=1, qc_device_threshold=1,
                      mesh=mesh)
    p.update_pubkeys(votes[2])
    return p


@pytest.fixture
def short_weights(monkeypatch):
    """8-bit batch weights keep CPU rounds short; a single forged lane
    still fails the relation under any nonzero weight."""
    monkeypatch.setattr(card, "_SCALAR_BITS", 8)


def test_provider_over_a_four_lane_mesh(votes, mesh_provider,
                                        short_weights):
    """CudaBlsCrypto(mesh=...) verifies, localizes a bad lane, aggregates
    and audits a QC over 4 logical lanes, every answer CpuBlsCrypto's,
    with every call on the device path."""
    h, sigs, pks, bad = votes
    p = mesh_provider
    cpu = CpuBlsCrypto(0xD1CE)
    assert p._kernels.lanes == 4
    assert p.mesh_device_names() == [f"cpu:0/{i}" for i in range(4)]
    assert p.verify_batch(sigs, [h] * BATCH, pks) == [True] * BATCH
    assert p.verify_batch(bad, [h] * BATCH, pks) == [
        cpu.verify_signature(s, h, v) for s, v in zip(bad, pks)]
    agg = p.aggregate_signatures(sigs, pks)
    assert agg == cpu.aggregate_signatures(sigs, pks)
    assert p.verify_aggregated_signature(agg, h, pks)
    assert not p.verify_aggregated_signature(agg, sm3_hash(b"x"), pks)
    st = p.degraded_status()
    assert st["calls"] == {"verify_batch": {"device": 2, "host": 0},
                           "aggregate": {"device": 1, "host": 0},
                           "verify_aggregated": {"device": 2, "host": 0}}
    assert st["pubkey_updates"] == {"device": 1, "host": 0}
    assert st["total_failures"] == 0


def test_ladder_walk_at_four_lanes(votes, mesh_provider, short_weights):
    """The JAX package's ladder walk (tests/test_mesh_resilience.py
    TestMeshLadderEndToEnd) at 4 lanes: a lost lane gives a 3-lane
    sub-mesh that dispatches clean while the lane stays lost, an
    unattributed fault the single-card set, and clearing it climbs back
    to the full mesh; every verdict is the host oracle's."""
    h, _, pks, bad = votes
    n = 4
    provider = mesh_provider
    sup = MeshSupervisor(provider, step_threshold=1, probe_successes=1,
                         probe_cooldown_s=60.0)
    provider.attach_supervisor(sup)
    want = [i != 3 for i in range(n)]

    def verify():
        return provider.verify_batch(bad[:n], [h] * n, pks[:n])

    assert sup.rung == "full_mesh" and provider._kernels.lanes == 4
    lane = provider.mesh_device_names()[2]
    assert lane == "cpu:0/2"
    provider.inject_device_loss(2, seconds=3600.0)  # by index
    assert verify() == want  # lost at the readback: host re-verify
    assert sup.rung == "sub_mesh"
    assert sup.quarantined_devices() == [lane]
    assert provider._kernels.lanes == 3
    assert lane not in provider._current_lane_names()
    failures0 = provider.breaker.total_failures
    assert verify() == want  # the sub-mesh dispatches clean
    assert provider.breaker.total_failures == failures0
    provider.breaker.inject_faults(0.001, min_faults=1)
    assert verify() == want
    provider.breaker.clear_injected_faults()
    assert sup.rung == "single_chip" and provider._kernels.lanes == 1
    assert verify() == want
    provider.inject_device_loss(lane, seconds=0.0)
    sup.probe_cooldown_s = 0.0
    for _ in range(4):
        assert verify() == want
        if sup.rung == "full_mesh":
            break
    assert sup.rung == "full_mesh" and provider._kernels.lanes == 4
    assert provider._kernels is provider._full_kernels
    walked = [(t["from"], t["to"]) for t in sup.statusz()["recent"]]
    assert walked == [("full_mesh", "sub_mesh"), ("sub_mesh", "single_chip"),
                      ("single_chip", "sub_mesh"), ("sub_mesh", "full_mesh")]


# -- the service's mesh knob ------------------------------------------------------

def test_mesh_config_values_validate():
    from consensus_overlord_tpu_torch.service.config import ConsensusConfig

    for mode in ("off", "local", "global"):
        assert ConsensusConfig(mesh=mode).mesh == mode
    with pytest.raises(ValueError):
        ConsensusConfig(mesh="ici")


def test_make_mesh_modes():
    """"off" builds no mesh; "local" is every lane of the process (on the
    CPU one lane); "global" without a coordinator is the same lanes."""
    from consensus_overlord_tpu_torch.service.consensus import _make_mesh

    assert _make_mesh("off", "cpu") is None
    local = _make_mesh("local", "cpu")
    assert local.names() == ["cpu:0"] and local.group is None
    glob = _make_mesh("global", "cpu")
    assert glob.names() == local.names() and glob.group is None
