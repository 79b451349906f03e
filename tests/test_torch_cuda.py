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
    monkeypatch.setattr(kernels, "BUILD_DIR", str(tmp_path / "_build"))
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
    """g1_validate_sum and g2_sum_rows at B = 8192 on the card (fq_mul and
    g1_add kernels) are torch.equal to their run on the CPU (the plain
    versions)."""
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
