"""The port's CUDA kernels on the card, against their plain PyTorch
versions (tolerance 0: integer arithmetic), and CudaBlsCrypto on the card
against the host oracle.  Every test here needs a GPU and skips without
one.  This file imports no JAX, so on the machine with the card (which
has none) it runs without the JAX-bound tests/conftest.py:

    python -m pytest --noconftest -q tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from consensus_overlord_tpu_torch.crypto import bls12381 as oracle
from consensus_overlord_tpu_torch.ops import bls12381_groups as dev
from consensus_overlord_tpu_torch.ops import kernels

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run on the card")
    return torch.device("cuda")


def test_fq_mul_kernel_matches_plain(cuda):
    rng = np.random.default_rng(51)
    x, y = (torch.from_numpy(rng.integers(
        0, dev.FQ.loose_max + 1, size=(3000, dev.FQ.n),
        dtype=np.int32)).to(cuda) for _ in range(2))
    x[:7] = dev.FQ.loose_max  # limbs at the loose bound; a ragged block
    before = kernels.FQ_MUL.launches
    got = dev.FQ.mul(x, y)
    assert kernels.FQ_MUL.launches == before + 1
    assert torch.equal(got, dev.FQ.mul_plain(x, y))


def test_g1_kernels_match_plain_and_oracle(cuda):
    pts = [oracle.g1_mul(oracle.G1_GEN, k) for k in range(1, 70)]
    p_aff = pts[:67] + [None, pts[3]]
    q_aff = pts[2:] + [pts[0], oracle.g1_neg(pts[3])]
    p = dev.g1_from_oracle(p_aff, cuda)
    q = dev.g1_from_oracle(q_aff, cuda)
    added = dev.G1.add(p, q)
    doubled = dev.G1.dbl(p)
    assert all(torch.equal(a, b) for a, b in
               zip(added, dev.G1.add_plain(p, q)))
    assert all(torch.equal(a, b) for a, b in
               zip(doubled, dev.G1.dbl_plain(p)))
    assert dev.g1_to_oracle(added) == [oracle.g1_add(a, b)
                                       for a, b in zip(p_aff, q_aff)]


#: Ragged batch sizes: one lane, a partial warp, one lane short of four
#: lane groups of each kernel's size, one either side of 8192.
RAGGED = (1, 3, *(4 * g - 1 for g in kernels.GROUP_SIZES), 8191, 8193)


def _loose(rng, batch):
    """Random loose limbs, with every 7th lane at the loose bound."""
    x = rng.integers(0, dev.FQ.loose_max + 1, size=(batch, dev.FQ.n),
                     dtype=np.int32)
    x[::7] = dev.FQ.loose_max
    return torch.from_numpy(x)


@pytest.mark.parametrize("batch", RAGGED)
def test_fq_mul_matches_plain_at_ragged_sizes(cuda, batch):
    rng = np.random.default_rng(batch)
    x, y = _loose(rng, batch).to(cuda), _loose(rng, batch).to(cuda)
    y[1::5] = dev.FQ.loose_max
    assert torch.equal(kernels.fq_mul(dev.FQ, x, y), dev.FQ.mul_plain(x, y))


_G1_CACHE = {}


def _g1_points():
    if "pts" not in _G1_CACHE:
        rng = np.random.default_rng(61)
        _G1_CACHE["pts"] = [oracle.g1_mul(oracle.G1_GEN,
                                          int(rng.integers(1, 2**62)))
                            for _ in range(24)]
    return _G1_CACHE["pts"]


def _g1_inputs(batch, device):
    """(P, Q) lane pairs of three kinds: random points with the identity
    on every 5th lane of P and on other lanes of Q; P + P and P + (−P)
    on alternate lanes; off-curve coordinates with every 7th lane's limbs
    at the loose bound (the formulas are polynomials, so kernel and plain
    version agree on any loose input)."""
    pts = _g1_points()
    p = [pts[i % len(pts)] for i in range(batch)]
    q = [pts[(7 * i + 3) % len(pts)] for i in range(batch)]
    pairs = [([None if i % 5 == 2 else a for i, a in enumerate(p)],
              [None if i % 5 == 4 else b for i, b in enumerate(q)]),
             (p, [a if i % 2 else oracle.g1_neg(a) for i, a in enumerate(p)])]
    out = [(dev.g1_from_oracle(a, device), dev.g1_from_oracle(b, device))
           for a, b in pairs]
    rng = np.random.default_rng(batch + 1)
    out.append(tuple(dev.Point(*(_loose(rng, batch).to(device)
                                 for _ in range(3))) for _ in range(2)))
    return out


@pytest.mark.parametrize("op", ("add", "dbl"))
@pytest.mark.parametrize("batch", RAGGED)
def test_g1_kernels_match_plain_at_ragged_sizes(cuda, batch, op):
    for p, q in _g1_inputs(batch, cuda):
        if op == "add":
            got = kernels.g1_add(dev.FQ, tuple(p), tuple(q))
            want = dev.G1.add_plain(p, q)
        else:
            got, want = kernels.g1_dbl(dev.FQ, tuple(p)), dev.G1.dbl_plain(p)
        assert all(torch.equal(a, b) for a, b in zip(got, want))


_G2_CACHE = {}


def _g2_inputs(batch, device):
    """G2 (P, Q) lane pairs of _g1_inputs' three kinds over Fq2: random
    points with identities, P + P and P + (−P), loose off-curve limbs;
    and a fourth, every limb of every coordinate at the loose bound."""
    if "pts" not in _G2_CACHE:
        rng = np.random.default_rng(62)
        _G2_CACHE["pts"] = [oracle.g2_mul(oracle.G2_GEN,
                                          int(rng.integers(1, 2**62)))
                            for _ in range(12)]
    pts = _G2_CACHE["pts"]
    p = [pts[i % len(pts)] for i in range(batch)]
    q = [pts[(5 * i + 3) % len(pts)] for i in range(batch)]
    neg = [a if i % 2 else (a[0], oracle.fq2_neg(a[1]))
           for i, a in enumerate(p)]
    pairs = [([None if i % 5 == 2 else a for i, a in enumerate(p)],
              [None if i % 5 == 4 else b for i, b in enumerate(q)]),
             (p, neg)]
    out = [(dev.g2_from_oracle(a, device), dev.g2_from_oracle(b, device))
           for a, b in pairs]
    rng = np.random.default_rng(batch + 2)
    out.append(tuple(dev.Point(*(_loose(rng, 2 * batch).reshape(
        batch, 2, dev.FQ.n).to(device) for _ in range(3))) for _ in range(2)))
    top = torch.full((batch, 2, dev.FQ.n), dev.FQ.loose_max,
                     dtype=torch.int32, device=device)
    out.append((dev.Point(top, top, top), dev.Point(top, top, top)))
    return out


def _same_elements(got, want):
    """Each output coordinate the same field elements as the plain
    version's (the kernels choose their own limbs), every limb loose."""
    assert all(0 <= int(a.min()) and int(a.max()) <= dev.FQ.loose_max
               for a in got)
    return all(torch.equal(dev.FQ.strict(a), dev.FQ.strict(b))
               for a, b in zip(got, want))


@pytest.mark.parametrize("op", ("add", "dbl"))
@pytest.mark.parametrize("batch", RAGGED)
def test_g2_kernels_match_plain_at_ragged_sizes(cuda, batch, op):
    for p, q in _g2_inputs(batch, cuda):
        before = kernels.counts()[f"g2_{op}"]
        if op == "add":
            got, want = dev.G2.add(p, q), dev.G2.add_plain(p, q)
        else:
            got, want = dev.G2.dbl(p), dev.G2.dbl_plain(p)
        assert kernels.counts()[f"g2_{op}"] == before + 1
        assert _same_elements(got, want)


def test_g2_kernels_at_the_grouped_ladder_shape(cuda):
    """(B, k) lanes, as verify_round_multi's ladder launches them, and the
    oracle's sums."""
    p, q = _g2_inputs(24, cuda)[0]
    pk = dev.Point(*(c.reshape(8, 3, 2, dev.FQ.n) for c in p))
    qk = dev.Point(*(c.reshape(8, 3, 2, dev.FQ.n) for c in q))
    for got, want in ((dev.G2.add(pk, qk), dev.G2.add_plain(pk, qk)),
                      (dev.G2.dbl(pk), dev.G2.dbl_plain(pk))):
        assert got.x.shape == (8, 3, 2, dev.FQ.n)
        assert _same_elements(got, want)
    pts = _G2_CACHE["pts"]
    a = dev.g2_from_oracle(pts[:6], cuda)
    b = dev.g2_from_oracle(pts[6:], cuda)
    assert dev.g2_to_oracle(dev.G2.add(a, b)) == [
        oracle.g2_add(x, y) for x, y in zip(pts[:6], pts[6:])]


def test_table_provider_on_the_card_matches_the_ladder(cuda):
    """CudaBlsCrypto(g2_table_msm=True) on the card: single- and 3-hash
    verdicts equal to the ladder provider's and the oracle's."""
    from consensus_overlord_tpu_torch.core.sm3 import sm3_hash
    from consensus_overlord_tpu_torch.crypto.cuda_provider import (
        CudaBlsCrypto)
    from consensus_overlord_tpu_torch.crypto.provider import CpuBlsCrypto

    cpus = [CpuBlsCrypto(0x3000 + 7919 * i) for i in range(40)]
    voters = [c.pub_key for c in cpus]
    tab = CudaBlsCrypto(0x3000, device_threshold=1, device=cuda,
                        g2_table_msm=True)
    ladder = CudaBlsCrypto(0x3000, device_threshold=1, device=cuda)
    for p in (tab, ladder):
        p.update_pubkeys(voters)
    assert tab._pk_tab is not None
    hs = [sm3_hash(b"card-tables-%d" % g) for g in range(3)]
    for hashes in ([hs[0]] * 40, [hs[i % 3] for i in range(40)]):
        sigs = [c.sign(h) for c, h in zip(cpus, hashes)]
        sigs[5] = sigs[6]  # a wrong signer
        want = [c.verify_signature(s, h, v) for c, s, h, v in
                zip(cpus, sigs, hashes, voters)]
        before = kernels.counts()
        assert tab.verify_batch(sigs, hashes, voters) == want
        after = kernels.counts()
        assert after["g2_add"] > before["g2_add"]
        assert after["g2_dbl"] == before["g2_dbl"]  # no ladder on the path
        assert ladder.verify_batch(sigs, hashes, voters) == want
    assert tab.breaker.status()["total_failures"] == 0


def test_kernel_wrapper_rejects_bad_operands(cuda):
    x = torch.zeros((8, dev.FQ.n), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="int32"):
        kernels.fq_mul(dev.FQ, x, x.long())
    with pytest.raises(ValueError, match="contiguous"):
        kernels.fq_mul(dev.FQ, x, x.t().contiguous().t())
    with pytest.raises(ValueError, match="shape"):
        kernels.fq_mul(dev.FQ, x, x[:4])


def test_provider_on_the_card_matches_the_oracle(cuda):
    from consensus_overlord_tpu_torch.core.sm3 import sm3_hash
    from consensus_overlord_tpu_torch.crypto.cuda_provider import (
        CudaBlsCrypto)
    from consensus_overlord_tpu_torch.crypto.provider import CpuBlsCrypto

    cpus = [CpuBlsCrypto(0x1111 * (i + 1) + 7) for i in range(6)]
    prov = CudaBlsCrypto(0x1111 + 7, device_threshold=1, device=cuda)
    prov.update_pubkeys([c.pub_key for c in cpus])
    h = sm3_hash(b"on-the-card")
    sigs = [c.sign(h) for c in cpus]
    sigs[2] = cpus[2].sign(sm3_hash(b"other"))
    voters = [c.pub_key for c in cpus]
    want = [c.verify_signature(s, h, v) for c, s, v in
            zip(cpus, sigs, voters)]
    assert prov.verify_batch(sigs, [h] * 6, voters) == want


def test_mesh_on_the_card_matches_the_single_card_and_oracle(cuda):
    """4 logical lanes of one card: the sharded round equals the
    single-card round output for output at a batch that splits unevenly
    (13 lanes), and the mesh provider's verdicts, device pairing on, are
    CpuBlsCrypto's."""
    from consensus_overlord_tpu_torch.core.sm3 import sm3_hash
    from consensus_overlord_tpu_torch.crypto import cuda_provider as card
    from consensus_overlord_tpu_torch.crypto.provider import CpuBlsCrypto
    from consensus_overlord_tpu_torch.parallel import sharded

    mesh = sharded.make_mesh(4, device=torch.device("cuda", 0))
    cpus = [CpuBlsCrypto(0x2222 * (i + 1) + 5) for i in range(13)]
    prov = card.CudaBlsCrypto(5, device_threshold=1, mesh=mesh)
    voters = [c.pub_key for c in cpus]
    prov.update_pubkeys(voters)
    h = sm3_hash(b"mesh-on-the-card")
    sigs = [c.sign(h) for c in cpus]
    sigs[7] = cpus[7].sign(sm3_hash(b"other"))
    want = [c.verify_signature(s, h, v) for c, s, v in
            zip(cpus, sigs, voters)]
    assert prov.verify_batch(sigs, [h] * 13, voters) == want
    assert prov.pairing_host_fallbacks == 0
    _, *arrays, _ = prov._host_arrays(sigs, voters, 13)
    ins = [prov._to_dev(a[:13]) for a in arrays] + [
        t[mesh.home] for t in prov._pk_device()]
    got = sharded.sharded_verify_round(mesh)(*ins)
    for g, w in zip(got, card.verify_round(*ins)):
        assert torch.equal(g, w)


# -- the pairing kernels (csrc/pairing.cu) -----------------------------------------

def _tower_loose(rng, *shape):
    x = rng.integers(0, dev.FQ.loose_max + 1, size=shape + (dev.FQ.n,),
                     dtype=np.int32)
    x.reshape((shape[0], -1, dev.FQ.n))[0] = dev.FQ.loose_max
    return torch.from_numpy(x)


@pytest.mark.parametrize("pairs", (1, 2, 5, 8))
def test_miller_product_kernel_matches_plain(cuda, pairs):
    from consensus_overlord_tpu_torch.ops import pairing as pr
    rng = np.random.default_rng(100 + pairs)
    px, py = (_tower_loose(rng, pairs).to(cuda) for _ in range(2))
    qx, qy = (_tower_loose(rng, pairs, 2).to(cuda) for _ in range(2))
    skip = torch.arange(pairs, device=cuda) % 3 == 1
    before = kernels.MILLER_PRODUCT.launches
    got = kernels.miller_product(dev.FQ, px, py, qx, qy, skip)
    assert kernels.MILLER_PRODUCT.launches == before + 1
    f = pr.miller_loop(px, py, qx, qy)
    assert torch.equal(got, pr.FQ12.where(skip, pr.FQ12.one_like(f), f))


@pytest.mark.parametrize("batch", (1, 2, 5, 8))
def test_fq12_mul_kernel_matches_plain(cuda, batch):
    from consensus_overlord_tpu_torch.ops import pairing as pr
    rng = np.random.default_rng(200 + batch)
    x, y = (_tower_loose(rng, batch, 2, 3, 2).to(cuda) for _ in range(2))
    assert torch.equal(pr.fq12_mul(x, y), pr.FQ12.mul(x, y))


@pytest.mark.parametrize("batch", (1, 3))
def test_final_exp_kernel_matches_plain(cuda, batch):
    from consensus_overlord_tpu_torch.ops import pairing as pr
    f = _tower_loose(np.random.default_rng(300 + batch), batch, 2, 3,
                     2).to(cuda)
    assert torch.equal(pr.final_exponentiation(f),
                       pr.FQ12.final_exponentiation(f))


@pytest.mark.parametrize("count", (1, 12, 13, 100))
def test_fq_inv_kernel_matches_the_chain(cuda, count):
    """FieldSpec.inv on the card is one fq_inv launch (final_exp_kernel on
    the fq_inv12 program, twelve elements a lane) and no fq_mul launch,
    equal to the plain chain (pow_static over mul_plain); inv(0) = 0."""
    from consensus_overlord_tpu_torch.ops import pairing as pr
    x = _tower_loose(np.random.default_rng(350 + count), count).to(cuda)
    x[count // 2] = 0
    before = kernels.counts()
    got = dev.FQ.inv(x)
    after = kernels.counts()
    assert after["fq_inv"] == before["fq_inv"] + 1
    assert after["fq_mul"] == before["fq_mul"]
    assert torch.equal(got, pr.FQ.inv(x))
    assert not got[count // 2].any()


def test_device_pairing_verdicts_on_the_card(cuda):
    """The staged pair on the card (all three kernels) against the host
    oracle: a true and a forged relation at the 2-pair rung."""
    from consensus_overlord_tpu_torch.ops import pairing as pr
    sk, h = 0xBEEF, oracle.hash_to_g1(b"\x09" * 32)
    pk, sig = oracle.g2_mul(oracle.G2_GEN, sk), oracle.g1_mul(h, sk)
    neg_g2 = (oracle.G2_GEN[0], oracle.fq2_neg(oracle.G2_GEN[1]))
    for s, want in ((sig, True), (oracle.g1_mul(sig, 3), False)):
        g1 = [torch.from_numpy(a).to(cuda)
              for a in pr.g1_affine_from_oracle([s, h])]
        g2 = [torch.from_numpy(a).to(cuda)
              for a in pr.g2_affine_from_oracle([neg_g2, pk])]
        mask = torch.ones(2, dtype=torch.bool, device=cuda)
        before = kernels.counts()
        got = pr.multi_pairing_is_one_staged(*g1, *g2, mask)
        after = kernels.counts()
        assert bool(got) is want is oracle.multi_pairing_is_one(
            [(s, neg_g2), (h, pk)])
        assert all(after[k.name] == before[k.name] + 1
                   for k in kernels.PAIRING_KERNELS)


# -- the provider's construction and its QC device steps ---------------------------

def test_provider_raises_when_the_kernel_build_fails(cuda, monkeypatch,
                                                     tmp_path):
    """On a CUDA device the constructor builds and loads every kernel
    library first: with nvcc pointing at a missing binary and an empty
    build directory, CudaBlsCrypto raises (nothing reaches the
    breaker)."""
    from consensus_overlord_tpu_torch.crypto.cuda_provider import (
        CudaBlsCrypto)

    monkeypatch.setattr(kernels, "_nvcc", lambda: str(tmp_path / "nvcc"))
    monkeypatch.setenv("CONSENSUS_TORCH_BUILD_ROOT", str(tmp_path / "_build"))
    monkeypatch.setattr(kernels, "_loaded", {})
    monkeypatch.setattr(kernels, "_tables_set", set())
    with pytest.raises((RuntimeError, OSError)):
        CudaBlsCrypto(0x1111 + 7, device=cuda)


def _qc_inputs(lanes: int):
    """Signature fields of `lanes` lanes (1024 distinct signatures tiled,
    every 97th lane off-curve, every 101st at infinity) and a 1024-row
    pubkey cache with `lanes` row indices, the last 5 lanes masked."""
    rng = np.random.default_rng(71)
    h = oracle.hash_to_g1(b"\x05" * 32)
    sig, pk = oracle.g1_mul(h, 0x51), oracle.g2_mul(oracle.G2_GEN, 0x51)
    sigs, pks = [], []
    for _ in range(1024):
        sigs.append(oracle.g1_compress(sig))
        pks.append(pk)
        sig, pk = oracle.g1_add(sig, h), oracle.g2_add(pk, oracle.G2_GEN)
    blobs = [sigs[i % 1024] for i in range(lanes)]
    x = 1
    while pow(x ** 3 + 4, (oracle.P - 1) // 2, oracle.P) == 1:
        x += 1
    for i in range(0, lanes, 97):
        blobs[i] = bytes([0x80]) + x.to_bytes(48, "big")[1:]
    for i in range(50, lanes, 101):
        blobs[i] = bytes([0xC0]) + b"\x00" * 47
    parsed = dev.parse_g1_compressed(blobs)
    g1 = tuple(torch.from_numpy(a) for a in (
        parsed.x, parsed.sign, parsed.infinity, parsed.wellformed))
    rows = torch.from_numpy(rng.integers(0, 1024, lanes))
    mask = torch.arange(lanes) < lanes - 5
    return g1, (rows, mask) + tuple(dev.g2_from_oracle(pks))


def test_qc_device_steps_on_the_card_match_the_cpu(cuda):
    """g1_validate_sum and g2_sum_rows at B = 8192 on the card (fq_mul,
    g1_add and g2_add kernels) are torch.equal to their run on the CPU
    (the plain versions): both return canonical limbs."""
    from consensus_overlord_tpu_torch.crypto import cuda_provider as cp

    g1, g2 = _qc_inputs(8192)
    before = kernels.counts()
    for step, ins in ((cp.g1_validate_sum, g1), (cp.g2_sum_rows, g2)):
        got = step(*(t.to(cuda) for t in ins))
        want = step(*ins)
        assert all(torch.equal(a.cpu(), b) for a, b in zip(got, want))
    after = kernels.counts()
    assert after["fq_mul"] > before["fq_mul"]
    assert after["g1_add"] > before["g1_add"]
    assert after["g2_add"] > before["g2_add"]


def _signed_votes(n: int, h: bytes):
    from consensus_overlord_tpu_torch.crypto.provider import CpuBlsCrypto

    cpus = [CpuBlsCrypto(0x2000 + 7919 * i) for i in range(n)]
    sigs = [c.sign(h) for c in cpus]
    sigs[1] = sigs[0]  # a wrong signer
    return sigs, [c.pub_key for c in cpus], cpus


def test_providers_built_while_a_batch_is_in_flight(cuda):
    """Providers built (on other threads too) while another provider's
    device batch is in flight upload no field tables again, and every
    verdict stays exact."""
    import threading

    from consensus_overlord_tpu_torch.crypto.cuda_provider import (
        CudaBlsCrypto)

    h = b"\x0b" * 32
    sigs, pks, cpus = _signed_votes(48, h)
    want = [cpus[0].verify_signature(s, h, v) for s, v in zip(sigs, pks)]
    first = CudaBlsCrypto(0x1000, device=cuda, device_threshold=8)
    first.update_pubkeys(pks)
    tables = set(kernels._tables_set)
    resolve = first.verify_batch_async(sigs, [h] * 48, pks)
    built = []
    threads = [threading.Thread(target=lambda i=i: built.append(
        CudaBlsCrypto(0x1000 + 7919 * i, device=cuda, device_threshold=8)))
        for i in range(1, 5)]
    for t in threads:
        t.start()
    built.append(CudaBlsCrypto(0x1000 + 7919 * 5, device=cuda,
                               device_threshold=8))
    for t in threads:
        t.join()
    assert resolve() == want
    assert kernels._tables_set == tables
    for p in built:
        assert p.verify_batch(sigs, [h] * 48, pks) == want
        assert p.calls["verify_batch"] == {"device": 1, "host": 0}


def test_upload_after_a_launch_does_not_wait_for_the_card(cuda):
    """_to_dev copies an upload above _PAGEABLE_MAX_BYTES through pinned
    memory: a 10-MB upload issued behind ~200 ms of queued work returns
    at once (from pageable memory a copy this large waits for the work),
    and the data arrives intact."""
    import time

    from consensus_overlord_tpu_torch.crypto.cuda_provider import (
        CudaBlsCrypto)

    p = CudaBlsCrypto(0x1000, device=cuda)
    arr = np.arange(65536 * 39, dtype=np.int32).reshape(65536, 39)
    p._to_dev(arr)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    torch.cuda._sleep(400_000_000)  # 0.2 s at 1,980 MHz, more if slower
    got = p._to_dev(arr)
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    assert host_s < 0.05
    assert torch.equal(got.cpu(), torch.as_tensor(arr))


def test_bls_fleet_on_the_card_commits_a_height(cuda):
    """An 8-validator fleet of the port on CudaBlsCrypto("cuda") commits
    height 1 with vote batches on the device and an audited proof."""
    import asyncio
    import time

    from consensus_overlord_tpu_torch.core.bitmap import extract_voters
    from consensus_overlord_tpu_torch.core.sm3 import sm3_hash
    from consensus_overlord_tpu_torch.core.types import (
        Proof, Vote, VoteType)
    from consensus_overlord_tpu_torch.crypto.cuda_provider import (
        CudaBlsCrypto)
    from consensus_overlord_tpu_torch.crypto.provider import CpuBlsCrypto
    from consensus_overlord_tpu_torch.sim import SimNetwork
    from consensus_overlord_tpu_torch.sim.run import sum_status

    async def main():
        net = SimNetwork(
            n_validators=8, block_interval_ms=2000, use_frontier=True,
            frontier_linger_s=0.05, sim_device_crypto=True,
            crypto_factory=lambda i: CudaBlsCrypto(
                0x1000 + 7919 * i, device=cuda, device_threshold=2))
        net.start(init_height=1)
        try:
            await net.run_until_height(1, timeout=120)
        finally:
            await net.stop()
        return net

    t0 = time.perf_counter()
    net = asyncio.run(main())
    print(f"8-validator fleet, height 1: {time.perf_counter() - t0:.3f} s")
    st = sum_status(n.crypto.degraded_status() for n in net.nodes)
    assert st["calls"]["verify_batch"]["device"] > 0
    assert st["total_failures"] == 0 and st["pairing_host_fallbacks"] == 0
    proof = Proof.decode(net.controller.proofs[1])
    voters = extract_voters(net.controller.authority_list(),
                            proof.signature.address_bitmap)
    vote = Vote(1, proof.round, VoteType.PRECOMMIT, proof.block_hash)
    assert CpuBlsCrypto(0x1000).verify_aggregated_signature(
        proof.signature.signature, sm3_hash(vote.encode()), voters)


# -- the 26-limb fields: Ed25519, secp256k1, SM2 ----------------------------------

def _curve_fields():
    from consensus_overlord_tpu_torch.ops import field
    return (field.ED25519_FQ, field.SECP256K1_FQ, field.SM2_FQ)


def _loose26(rng, spec, batch):
    """Random loose limbs of a 26-limb field, every 7th lane at the loose
    bound (the group laws are polynomials: kernel and plain version agree
    on any loose input)."""
    x = rng.integers(0, spec.loose_max + 1, size=(batch, spec.n),
                     dtype=np.int32)
    x[::7] = spec.loose_max
    return torch.from_numpy(x)


@pytest.mark.parametrize("field_index", (0, 1, 2))
@pytest.mark.parametrize("batch", RAGGED)
def test_fq_mul_26_limbs_matches_plain(cuda, batch, field_index):
    spec = _curve_fields()[field_index]
    rng = np.random.default_rng(400 + batch + field_index)
    x, y = (_loose26(rng, spec, batch).to(cuda) for _ in range(2))
    k = [k for k in kernels.KERNELS if k.name.startswith("fq_mul")
         and k.spec == spec.name][0]
    before = k.launches
    assert torch.equal(spec.mul(x, y), spec.mul_plain(x, y))
    assert k.launches == before + 1


@pytest.mark.parametrize("batch", RAGGED)
def test_ed_add_matches_plain(cuda, batch):
    from consensus_overlord_tpu_torch.ops import edwards as ed
    rng = np.random.default_rng(500 + batch)
    pts = [ed.EdPoint(*(_loose26(rng, ed.FE, batch).to(cuda)
                        for _ in range(4))) for _ in range(2)]
    base = ed.base_point(batch, cuda)
    for p, q in ((pts[0], pts[1]), (base, base),
                 (base, ed.identity_like(base.x)), (base, ed.neg(base))):
        before = kernels.ED_ADD.launches
        got = ed.add(p, q)
        assert kernels.ED_ADD.launches == before + 1
        assert all(torch.equal(a, b) for a, b in zip(got, ed.add_plain(p, q)))


@pytest.mark.parametrize("batch", RAGGED)
def test_secp_and_sm2_kernels_match_plain(cuda, batch):
    from consensus_overlord_tpu_torch.ops import weierstrass as w
    for ops, spec in ((w.SECP, w.FQ_SECP), (w.SM2, w.FQ_SM2)):
        rng = np.random.default_rng(600 + batch)
        p, q = (w.Point(*(_loose26(rng, spec, batch).to(cuda)
                          for _ in range(3))) for _ in range(2))
        assert all(torch.equal(a, b) for a, b in
                   zip(ops.add(p, q), ops.add_plain(p, q)))
        if ops is w.SECP:
            assert all(torch.equal(a, b) for a, b in
                       zip(ops.dbl(p), ops.dbl_plain(p)))


@pytest.mark.parametrize("batch", RAGGED)
def test_ed_ladder_matches_plain_and_the_steps(cuda, batch):
    """ed_ladder (one launch) against ladder_plain and against the
    step-by-step route (one ed_add launch an add), at 64 bits: two packed
    words a lane."""
    from consensus_overlord_tpu_torch.ops import edwards as ed
    rng = np.random.default_rng(700 + batch)
    p = ed.EdPoint(*(_loose26(rng, ed.FE, batch).to(cuda) for _ in range(4)))
    bits = torch.from_numpy(rng.integers(0, 2, size=(batch, 64),
                                         dtype=np.int32)).to(cuda)
    packed = ed.pack_bits(bits)
    before = kernels.ED_LADDER.launches
    got = ed.scalar_mul_bits(p, bits)
    assert kernels.ED_LADDER.launches == before + 1
    assert all(torch.equal(a, b) for a, b in
               zip(got, ed.ladder_plain(p, packed, 64)))
    assert all(torch.equal(a, b) for a, b in
               zip(got, ed.scalar_mul_steps(p, bits)))


@pytest.mark.parametrize("batch", RAGGED)
def test_wp_dual_ladder_matches_plain_and_the_steps(cuda, batch):
    """wp_dual_ladder (one launch after the table builds) against
    dual_ladder_plain and the step-by-step route, at 64 bits (16
    windows), with SM2's base point as G and loose limbs as Q."""
    from consensus_overlord_tpu_torch.ops import weierstrass as w
    rng = np.random.default_rng(800 + batch)
    f = w.FQ_SM2
    g = w.SM2.from_affine(f.constant(w.SM2_GX, cuda)[None],
                          f.constant(w.SM2_GY, cuda)[None])
    q = w.Point(*(_loose26(rng, f, batch).to(cuda) for _ in range(3)))
    u1, u2 = (torch.from_numpy(rng.integers(0, 2, size=(batch, 64),
                                            dtype=np.int32)).to(cuda)
              for _ in range(2))
    before = kernels.WP_DUAL_LADDER.launches
    got = w.dual_scalar_mul_bits(w.SM2, g, u1, q, u2)
    assert kernels.WP_DUAL_LADDER.launches == before + 1
    tg, tq = w._tables(w.SM2, g, q, 4)
    packed = w.pack_digits(w._window_digits(u1, 4), w._window_digits(u2, 4))
    assert all(torch.equal(a, b) for a, b in
               zip(got, w.dual_ladder_plain(tg, tq, packed, 16)))
    assert all(torch.equal(a, b) for a, b in
               zip(got, w.dual_scalar_mul_steps(w.SM2, g, u1, q, u2)))


def test_curve_providers_on_the_card_match_the_host_rule(cuda):
    """Each provider's verify_batch on the card against its own host rule
    on a batch with a wrong signer and a malformed lane."""
    from consensus_overlord_tpu_torch.crypto.ecdsa_cuda import (
        Secp256k1Crypto, Sm2Crypto)
    from consensus_overlord_tpu_torch.crypto.ed25519_cuda import (
        Ed25519CudaCrypto)

    h = b"\x0b" * 32
    for make in (lambda i: Ed25519CudaCrypto(bytes([i + 1]) * 32,
                                             device_threshold=1, device=cuda),
                 lambda i: Secp256k1Crypto(0x2000 + i, device_threshold=1,
                                           device=cuda),
                 lambda i: Sm2Crypto(0x3000 + i, device_threshold=1,
                                     device=cuda)):
        provs = [make(i) for i in range(6)]
        sigs = [p.sign(h) for p in provs]
        voters = [p.pub_key for p in provs]
        sigs[1], sigs[4] = sigs[2], sigs[4][:-1]
        want = [provs[0].verify_signature(s, h, v)
                for s, v in zip(sigs, voters)]
        assert want == [True, False, True, True, False, True]
        assert provs[0].verify_batch(sigs, [h] * 6, voters) == want
