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
