"""CudaBlsCrypto's device-pairing verdict on the CPU (the plain tower of
consensus_overlord_tpu_torch/ops/pairing.py) against the JAX package's
CpuBlsCrypto: good, bad-lane and 3-hash batches verdict for verdict, the
CONSENSUS_DEVICE_PAIRING knob, and the CONSENSUS_PAIRING_CROSSCHECK twin.

device_threshold=1 sends every batch through the device path; with
device_pairing=True its pairing runs on the device tensors (here the
CPU), so the host oracle is asked only to localize a failed relation's
lanes."""

import logging
import sys

import pytest
import torch

from consensus_overlord_tpu.core.sm3 import sm3_hash
from consensus_overlord_tpu.crypto import bls12381 as joracle
from consensus_overlord_tpu.crypto.provider import CpuBlsCrypto
from consensus_overlord_tpu_torch.crypto import cuda_provider
from consensus_overlord_tpu_torch.crypto.cuda_provider import CudaBlsCrypto

# One intra-op thread: several worker processes share the cores.
torch.set_num_threads(1)

N = 8
KEYS = [0x3333 * (i + 1) + 11 for i in range(N)]


@pytest.fixture(scope="module")
def cpus():
    return [CpuBlsCrypto(k) for k in KEYS]


@pytest.fixture(scope="module")
def port(cpus):
    p = CudaBlsCrypto(KEYS[0], device_threshold=1, device="cpu",
                      device_pairing=True)
    p.update_pubkeys([c.pub_key for c in cpus])
    return p


@pytest.fixture
def no_host_pairing(monkeypatch):
    """Host-oracle pairings made by the provider, by caller: a relation
    must be paired on the device; the oracle may only localize lanes."""
    calls = []
    real = cuda_provider.oracle.multi_pairing_is_one

    def counted(pairs):
        calls.append(sys._getframe(1).f_code.co_name)
        return real(pairs)
    monkeypatch.setattr(cuda_provider.oracle, "multi_pairing_is_one", counted)
    return calls


def votes(cpus, msg):
    h = sm3_hash(msg)
    return [c.sign(h) for c in cpus], [h] * N, [c.pub_key for c in cpus]


def reference(cpus, sigs, hashes, voters):
    return [cpus[0].verify_signature(s, h, v)
            for s, h, v in zip(sigs, hashes, voters)]


def test_good_batch_pairs_on_the_device(cpus, port, no_host_pairing):
    sigs, hashes, voters = votes(cpus, b"device-pairing-good")
    assert port.verify_batch(sigs, hashes, voters) == [True] * N
    assert no_host_pairing == []


def test_bad_lanes_localize_exactly(cpus, port, no_host_pairing):
    """The device verdict is False; the host oracle localizes the lanes
    (one pairing per valid lane, nothing else)."""
    sigs, hashes, voters = votes(cpus, b"device-pairing-bad")
    sigs[2], sigs[5] = sigs[5], sigs[2]  # wrong signers
    sigs[6] = joracle.g1_compress(joracle.g1_add(
        joracle.g1_decompress(sigs[6]), (0, 2)))  # order-3 component
    want = reference(cpus, sigs, hashes, voters)
    assert port.verify_batch(sigs, hashes, voters) == want
    assert want.count(True) == 5
    assert set(no_host_pairing) == {"_verify_one_cached"}


def test_three_hash_batch(cpus, port, no_host_pairing):
    """Three hash groups pair 4 pairs, padded to the 5-pair rung."""
    hashes = [sm3_hash(b"device-pairing-m%d" % (i % 3)) for i in range(N)]
    sigs = [c.sign(h) for c, h in zip(cpus, hashes)]
    voters = [c.pub_key for c in cpus]
    sigs[4] = cpus[4].sign(hashes[0])  # signed another group's hash
    want = reference(cpus, sigs, hashes, voters)
    assert port.verify_batch(sigs, hashes, voters) == want
    assert want.count(False) == 1


@pytest.mark.parametrize("mode,want", [("1", True), ("on", True),
                                       ("0", False), ("off", False),
                                       ("false", False), ("auto", False)])
def test_device_pairing_knob(monkeypatch, mode, want):
    """CONSENSUS_DEVICE_PAIRING: 1/0 force it; auto is off on the CPU; an
    argument overrides the environment."""
    monkeypatch.setenv("CONSENSUS_DEVICE_PAIRING", mode)
    assert CudaBlsCrypto(KEYS[0], device="cpu")._pairing_on_device is want
    assert CudaBlsCrypto(KEYS[0], device="cpu",
                         device_pairing=not want)._pairing_on_device is (
                             not want)


def test_crosscheck_logs_no_mismatch(cpus, port, monkeypatch, caplog,
                                    no_host_pairing):
    """CONSENSUS_PAIRING_CROSSCHECK=1: the device verdict (False here) is
    paired on the host too, and the two agree."""
    monkeypatch.setenv("CONSENSUS_PAIRING_CROSSCHECK", "1")
    twin = CudaBlsCrypto(KEYS[0], device_threshold=1, device="cpu",
                         device_pairing=True)
    twin.load_pubkey_cache(port._pk)
    sigs, hashes, voters = votes(cpus, b"device-pairing-crosscheck")
    sigs[1] = sigs[0]
    with caplog.at_level(logging.ERROR, logger=cuda_provider.__name__):
        got = twin.verify_batch(sigs, hashes, voters)
    assert got == reference(cpus, sigs, hashes, voters)
    assert twin.pairing_mismatches == 0
    assert "host_pairing" in no_host_pairing
    assert not [r for r in caplog.records if r.levelno >= logging.ERROR]
