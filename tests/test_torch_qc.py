"""The QC paths of CudaBlsCrypto (consensus_overlord_tpu_torch/crypto/
cuda_provider.py) on the CPU against the JAX package: the two QC device
steps against the JAX jits they port (tolerance 0: canonical integers and
flags), and the provider's aggregate_signatures and
verify_aggregated_signature byte for byte and verdict for verdict against
the JAX package's CpuBlsCrypto — twins of tests/test_tpu_provider.py
TestAggregate, TestAsyncPipeline::test_async_aggregate_and_verify_aggregated
and TestThresholdKnobs, and of tests/test_pairing.py test_verify_aggregated.

device_threshold=1 sends every batch through the device path, which on
CPU tensors runs each kernel's plain version; the device pairing runs the
plain tower (about 2.5 s a flush), so only one test turns it on.  The JAX
jits run op by op (their Python functions, `__wrapped__`): compiling one
whole costs more on the CPU than running it, and integer results do not
depend on the mode."""

import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from consensus_overlord_tpu.core.sm3 import sm3_hash
from consensus_overlord_tpu.crypto import bls12381 as joracle
from consensus_overlord_tpu.crypto import tpu_provider
from consensus_overlord_tpu.crypto.provider import CpuBlsCrypto
from consensus_overlord_tpu.crypto.provider import CryptoError as JaxCryptoError
from consensus_overlord_tpu.ops import bls12381_groups as jdev
from consensus_overlord_tpu_torch.crypto import cuda_provider
from consensus_overlord_tpu_torch.crypto.cuda_provider import CudaBlsCrypto
from consensus_overlord_tpu_torch.crypto.provider import CryptoError
from consensus_overlord_tpu_torch.ops import bls12381_groups as dev

# One intra-op thread: several worker processes share the cores.
torch.set_num_threads(1)

N = 8
KEYS = [0x4B1D * (i + 1) + 13 for i in range(N)]


@pytest.fixture(scope="module")
def cpus():
    return [CpuBlsCrypto(k) for k in KEYS]


@pytest.fixture(scope="module")
def port(cpus):
    p = CudaBlsCrypto(KEYS[0], device_threshold=1, device="cpu",
                      device_pairing=False)
    p.update_pubkeys([c.pub_key for c in cpus])  # device-path validation
    return p


def signed(cpus, msg):
    h = sm3_hash(msg)
    return [c.sign(h) for c in cpus], h, [c.pub_key for c in cpus]


def off_curve_x() -> int:
    """The least x ≥ 1 with no point on y² = x³ + 4: a well-formed
    encoding that fails decompression on the device."""
    x = 1
    while pow(x ** 3 + 4, (joracle.P - 1) // 2, joracle.P) == 1:
        x += 1
    return x


# -- the QC device steps against the JAX jits ------------------------------------

def test_g1_validate_sum_matches_jax(cpus):
    """g1_validate_sum vs tpu_provider._g1_validate_sum at B = 8: six
    signatures, an off-curve lane (invalid, masked out) and an infinity
    lane (valid, the identity).  Strict limbs, flags and validity equal;
    the sum is the oracle's sum of the valid lanes."""
    sigs, _, _ = signed(cpus, b"qc-g1-sum")
    sigs = sigs[:6] + [bytes([0x80]) + off_curve_x().to_bytes(48, "big")[1:],
                       bytes([0xC0]) + b"\x00" * 47]
    parsed = dev.parse_g1_compressed(sigs)
    ins = (parsed.x, parsed.sign, parsed.infinity, parsed.wellformed)
    want = tpu_provider._g1_validate_sum.__wrapped__(
        *(jnp.asarray(a) for a in ins))
    got = cuda_provider.g1_validate_sum(*(torch.from_numpy(a) for a in ins))
    for w, g in zip(want, got):
        assert np.array_equal(np.asarray(w), g.numpy())
    assert got[3].tolist() == [True] * 6 + [False, True]
    total = None
    for s in sigs[:6]:
        total = joracle.g1_add(total, joracle.g1_decompress(s))
    assert not bool(got[2])
    assert (dev.FQ.ints_from_strict(got[0].numpy())
            + dev.FQ.ints_from_strict(got[1].numpy())) == list(total)


def test_g2_sum_rows_matches_jax(cpus):
    """g2_sum_rows vs tpu_provider._g2_sum_rows at B = 8 over a 16-row
    cache built from oracle points at z = 1 (JAX's g2_from_oracle, the
    port's own twin giving the same limbs): a repeated row (a doubling
    inside the complete add) and three padding lanes masked out."""
    pts = [joracle.g2_decompress(c.pub_key) for c in cpus]
    rows_pts = pts + [None] * 8
    jx, jy, jz = jdev.g2_from_oracle(rows_pts)
    px, py, pz = dev.g2_from_oracle(rows_pts)
    for j, p in zip((jx, jy, jz), (px, py, pz)):
        assert np.array_equal(np.asarray(j), p.numpy())
    rows = np.array([3, 1, 4, 1, 5, 0, 0, 0], np.int64)
    mask = np.arange(8) < 5
    want = tpu_provider._g2_sum_rows.__wrapped__(
        jnp.asarray(rows), jnp.asarray(mask), jx, jy, jz)
    got = cuda_provider.g2_sum_rows(torch.from_numpy(rows),
                                    torch.from_numpy(mask), px, py, pz)
    for w, g in zip(want, got):
        assert np.array_equal(np.asarray(w), g.numpy())
    total = None
    for r in rows[:5]:
        total = joracle.g2_add(total, pts[r])
    assert cuda_provider._affine_to_oracle_g2(*(g.numpy() for g in got)) \
        == total


# -- provider twins of tests/test_tpu_provider.py --------------------------------

@pytest.mark.parametrize("case", ["all_valid", "infinity_lane", "cancelling"])
def test_aggregate_matches_oracle(cpus, port, case):
    sigs, _, voters = signed(cpus, b"agg")
    if case == "infinity_lane":
        sigs[2] = bytes([0xC0]) + b"\x00" * 47
    elif case == "cancelling":  # the sum is the identity
        sigs = [sigs[0], joracle.g1_compress(joracle.g1_neg(
            joracle.g1_decompress(sigs[0])))]
        voters = voters[:2]
    got = port.aggregate_signatures(sigs, voters)
    assert got == cpus[0].aggregate_signatures(sigs, voters)


def test_aggregate_rejects_garbage(cpus, port):
    sigs, _, voters = signed(cpus, b"agg")
    sigs[1] = b"\xff" * 48
    with pytest.raises(JaxCryptoError):
        cpus[0].aggregate_signatures(sigs, voters)
    with pytest.raises(CryptoError, match="invalid signature"):
        port.aggregate_signatures(sigs, voters)


def test_length_mismatch(cpus, port):
    with pytest.raises(CryptoError):
        port.aggregate_signatures([b"x"], [c.pub_key for c in cpus])


def test_verify_aggregated(cpus, port):
    sigs, h, voters = signed(cpus, b"qc")
    agg = cpus[0].aggregate_signatures(sigs, voters)
    cases = [(agg, h, voters), (agg, sm3_hash(b"no"), voters),
             (agg, h, voters[:4])]  # a subset: the full set's aggregate fails
    got = [port.verify_aggregated_signature(*c) for c in cases]
    assert got == [cpus[0].verify_aggregated_signature(*c) for c in cases]
    assert got == [True, False, False]


def test_verify_aggregated_bad_voter(cpus, port):
    sigs, h, voters = signed(cpus, b"qc2")
    agg = cpus[0].aggregate_signatures(sigs, voters)
    bad_voters = voters[:-1] + [b"\x02" * 96]
    assert not cpus[0].verify_aggregated_signature(agg, h, bad_voters)
    assert not port.verify_aggregated_signature(agg, h, bad_voters)


def test_async_aggregate_and_verify_aggregated(cpus, port):
    """The async forms dispatch now and resolve later to the same results
    as the sync forms."""
    sigs, h, voters = signed(cpus, b"qc-async")
    r_agg = port.aggregate_signatures_async(sigs, voters)
    agg = r_agg()
    assert agg == port.aggregate_signatures(sigs, voters)
    assert agg == cpus[0].aggregate_signatures(sigs, voters)
    r_ok = port.verify_aggregated_async(agg, h, voters)
    r_bad = port.verify_aggregated_async(agg, sm3_hash(b"no"), voters)
    assert r_ok() is True
    assert r_bad() is False


def test_pad_min_floor(monkeypatch):
    """CONSENSUS_PAD_MIN pins the bottom of the pad ladder, rung for rung
    as in the JAX package."""
    for floor in (None, "32", "8192", "9000"):
        if floor is None:
            monkeypatch.delenv("CONSENSUS_PAD_MIN", raising=False)
        else:
            monkeypatch.setenv("CONSENSUS_PAD_MIN", floor)
        for n in (1, 5, 8, 32, 33, 4097, 8192, 8193, 20000):
            assert cuda_provider._pad_to(n) == tpu_provider._pad_to(n)
    monkeypatch.setenv("CONSENSUS_PAD_MIN", "32")
    assert [cuda_provider._pad_to(n) for n in (5, 32, 33)] == [32, 32, 128]
    monkeypatch.setenv("CONSENSUS_PAD_MIN", "9000")
    assert cuda_provider._pad_to(5) == 16384  # above the ladder


def test_pad_ladder_has_4096_rung():
    assert [cuda_provider._pad_to(n) for n in (2049, 4096, 4097)] == [
        4096, 4096, 8192]


def test_pk_capacity_floor(monkeypatch):
    """CONSENSUS_PK_CAP_MIN pins the pubkey-cache capacity ladder, rung
    for rung as in the JAX package."""
    for floor in (None, "16384", "20000"):
        if floor is None:
            monkeypatch.delenv("CONSENSUS_PK_CAP_MIN", raising=False)
        else:
            monkeypatch.setenv("CONSENSUS_PK_CAP_MIN", floor)
        for n in (1, 10, 257, 16384, 16385):
            assert (cuda_provider._pk_capacity(n)
                    == tpu_provider._pk_capacity(n))
    monkeypatch.setenv("CONSENSUS_PK_CAP_MIN", "20000")
    assert cuda_provider._pk_capacity(10) == 32768


def test_qc_threshold_splits_paths(cpus, monkeypatch):
    """qc_device_threshold routes the QC paths and pubkey validation to
    the host while verifies stay on the device: no QC device step runs,
    and the results are the oracle's."""
    t = CudaBlsCrypto(KEYS[0], device_threshold=1, device="cpu",
                      qc_device_threshold=10**9, device_pairing=False)
    for step in ("g2_validate", "g1_validate_sum", "g2_sum_rows"):
        monkeypatch.setattr(t._kernels, step, staticmethod(_never))
    t.update_pubkeys([c.pub_key for c in cpus])  # host-validated
    sigs, h, voters = signed(cpus, b"split-thresh")
    assert t.verify_batch(sigs, [h] * N, voters) == [True] * N
    agg = t.aggregate_signatures(sigs, voters)
    assert agg == cpus[0].aggregate_signatures(sigs, voters)
    assert t.verify_aggregated_signature(agg, h, voters)
    assert t.breaker.status()["total_failures"] == 0


def _never(*_a):
    raise AssertionError("a QC device step ran below qc_device_threshold")


# -- the device pairing (tests/test_pairing.py test_verify_aggregated) -----------

def test_verify_aggregated_pairs_on_the_device(cpus, port, monkeypatch):
    """With device pairing on, both verdicts come from the device tower:
    the host oracle pairs nothing (the two flushes of this file)."""
    calls = []
    real = cuda_provider.oracle.multi_pairing_is_one

    def counted(pairs):
        calls.append(sys._getframe(1).f_code.co_name)
        return real(pairs)
    monkeypatch.setattr(cuda_provider.oracle, "multi_pairing_is_one", counted)
    t = CudaBlsCrypto(KEYS[0], device_threshold=1, device="cpu",
                      device_pairing=True)
    t.load_pubkey_cache(port._pk)
    sigs, h, voters = signed(cpus, b"qc-dev-pairing")
    agg = t.aggregate_signatures(sigs, voters)
    assert t.verify_aggregated_signature(agg, h, voters)
    assert not t.verify_aggregated_signature(agg, sm3_hash(b"other"), voters)
    assert calls == []
    assert t.degraded_status()["pairing_host_fallbacks"] == 0
