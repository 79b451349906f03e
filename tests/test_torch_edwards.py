"""The port's Ed25519 slice (ops/edwards.py, crypto/ed25519_cuda.py)
against the JAX package's (ops/edwards.py, crypto/ed25519_tpu.py): the
26-limb field's tables and plans, the point ops on the same numpy-seeded
inputs (bit-identical limbs: integer arithmetic, tolerance 0), the host
keys, signatures and cofactored rule, and the provider's verdicts on
adversarial batches.  The batch relation (the JAX jit
_ed_msm_is_identity) is held against the host oracle on fixed bits;
its CPU compile is not worth the suite's time."""

import functools
import hashlib
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from consensus_overlord_tpu.crypto.ed25519_tpu import Ed25519TpuCrypto
from consensus_overlord_tpu.ops import edwards as jed
from consensus_overlord_tpu_torch.crypto import ed25519_cuda
from consensus_overlord_tpu_torch.crypto.ed25519_cuda import (
    Ed25519CudaCrypto)
from consensus_overlord_tpu_torch.ops import edwards as ed
from consensus_overlord_tpu_torch.ops import kernels

torch.set_num_threads(1)

B = 8
SEEDS = [bytes([i + 1]) * 32 for i in range(B)]
MSG = hashlib.sha256(b"ed25519 slice").digest()


def _limbs(rng, batch):
    x = rng.integers(0, ed.FE.loose_max + 1, size=(batch, ed.FE.n),
                     dtype=np.int32)
    x[0] = ed.FE.loose_max
    return x


def _points(ks):
    """[k]B for each k, as numpy (x, y, z, t) limb rows."""
    aff = [ed._affine(ed._base_mul(k)) for k in ks]
    x = ed.FE.from_ints([a[0] for a in aff])
    y = ed.FE.from_ints([a[1] for a in aff])
    return x, y


def _torsion8():
    """A point of order 8: [L]·P for a curve point P, as extended ints."""
    for y in range(3, 200):
        x = ed._xrecover(y, 0)
        if x is None:
            continue
        t = ed._ext_mul_ext(ed._ext_of((x, y)), ed.L)
        four = ed._ext_mul_ext(t, 4)
        if (four[1] + four[2]) % ed.P == 0:  # [4]T = (0, −1): order 8
            return t
    raise AssertionError("no order-8 point found")


def test_field_matches_jax():
    """Fold rows, pad and every reduction plan of 2^255 − 19, limb for
    limb and step for step."""
    assert ed.FE.n == jed.FE.n == 26
    assert np.array_equal(ed.FE._fold_np, jed.FE._fold_np)
    assert np.array_equal(ed.FE._pad_np, jed.FE._pad_np)
    for name in kernels.plan_names(ed.FE):
        bounds = kernels.plan_bounds(ed.FE, name)
        assert ed.FE._plan(list(bounds)) == jed.FE._plan(list(bounds))


def test_add_neg_mul8_identity_match_jax():
    """add on loose limbs and on curve points, neg, mul8 and is_identity:
    the port's limbs equal the JAX package's."""
    rng = np.random.default_rng(91)
    loose = [_limbs(rng, B) for _ in range(8)]
    xs, ys = _points([rng.integers(1, 2**60) for _ in range(B)])
    tp = ed.from_affine(torch.from_numpy(xs), torch.from_numpy(ys))
    jp = jed.from_affine(jnp.asarray(xs), jnp.asarray(ys))
    cases = [(ed.EdPoint(*map(torch.from_numpy, loose[:4])),
              ed.EdPoint(*map(torch.from_numpy, loose[4:])),
              jed.EdPoint(*map(jnp.asarray, loose[:4])),
              jed.EdPoint(*map(jnp.asarray, loose[4:]))),
             (tp, ed.neg(tp), jp, jed.neg(jp)),
             (tp, tp, jp, jp)]
    for tp1, tq1, jp1, jq1 in cases:
        got, want = ed.add(tp1, tq1), jed.add(jp1, jq1)
        assert all(np.array_equal(np.asarray(w), g.numpy())
                   for g, w in zip(got, want))
        assert np.array_equal(np.asarray(jed.is_identity(want)),
                              ed.is_identity(got).numpy())
    got, want = ed.mul8(tp), jed.mul8(jp)
    assert all(np.array_equal(np.asarray(w), g.numpy())
               for g, w in zip(got, want))
    assert not ed.is_identity(got).any()


def test_decompress_matches_jax():
    """Valid points of both signs, a y with no x (y = 2), x = 0 with the
    sign bit set (y = 1), and y = 0 (x = √−1): limbs and flags equal."""
    rng = np.random.default_rng(92)
    blobs = [ed._encode_point(ed._affine(ed._base_mul(
        int(rng.integers(1, 2**60))))) for _ in range(4)]
    blobs += [(2).to_bytes(32, "little"),
              (1 | 1 << 255).to_bytes(32, "little"),
              (0).to_bytes(32, "little"), (1).to_bytes(32, "little")]
    parsed = ed.parse_points(blobs)
    jparsed = jed.parse_points(blobs)
    assert all(np.array_equal(a, b) for a, b in zip(parsed, jparsed))
    pt, valid = ed.decompress(torch.from_numpy(parsed.y),
                              torch.from_numpy(parsed.sign))
    jpt, jvalid = jed.decompress(jnp.asarray(parsed.y),
                                 jnp.asarray(parsed.sign))
    assert valid.tolist() == np.asarray(jvalid).tolist() == [
        True] * 4 + [False, False, True, True]
    for g, w in zip(pt, jpt):
        assert np.array_equal(np.asarray(w), g.numpy())


def test_msm_is_identity_matches_the_host_oracle():
    """msm_is_identity (the JAX jit _ed_msm_is_identity's port) on fixed
    scalars: a combination that cancels, with a small-torsion lane that
    [8] clears, is the identity; changing one scalar makes it not."""
    ks = [3, 5, 7]
    xs, ys = _points(ks)
    t = _torsion8()
    tx, ty = ed._affine(t)
    xs = np.concatenate([xs, ed.FE.from_ints([tx])])
    ys = np.concatenate([ys, ed.FE.from_ints([ty])])
    pts = ed.from_affine(torch.from_numpy(xs), torch.from_numpy(ys))
    # 3·10 + 5·1 + 7·(−5) ≡ 0 mod L; the torsion lane's weight is free.
    scalars = [10, 1, ed.L - 5, 3]
    affine = [ed._affine(ed._base_mul(k)) for k in ks] + [(tx, ty)]
    for sc, want in ((scalars, True), ([11, 1, ed.L - 5, 3], False)):
        bits = torch.from_numpy(ed.int_to_bits_msb(sc, 256))
        got = bool(ed25519_cuda.msm_is_identity(pts, bits))
        acc = (0, 1)  # the JAX package's affine host oracle
        for k, pt in zip(sc, affine):
            acc = jed._host_add(acc, jed._host_mul(pt, k))
        assert got is want is (jed._host_mul(acc, 8) == (0, 1))


def test_keys_and_signatures_equal_the_jax_providers():
    for seed in SEEDS[:3]:
        port = Ed25519CudaCrypto(seed, device="cpu")
        ref = Ed25519TpuCrypto(seed)
        assert port.pub_key == ref.pub_key == jed.host_pub_key(seed)
        assert port.sign(MSG) == ref.sign(MSG) == jed.host_sign(seed, MSG)


@functools.lru_cache(maxsize=None)
def _adversarial_batch():
    """Eight lanes: valid, a wrong signer, s ≥ L, R with y ≥ p, an
    undecodable R, a torsion component in R (accepted by the cofactored
    rule), a torsion component in A (accepted), and a short signature."""
    keys = [ed._expand_seed(s) for s in SEEDS]
    pks = [ed.host_pub_key(s) for s in SEEDS]
    sigs = [ed.host_sign(s, MSG) for s in SEEDS]
    sigs[1] = ed.host_sign(SEEDS[0], MSG)  # signed by another key
    r2, s2 = sigs[2][:32], int.from_bytes(sigs[2][32:], "little")
    sigs[2] = r2 + (s2 + ed.L).to_bytes(32, "little")
    sigs[3] = (ed.P + 3).to_bytes(32, "little") + sigs[3][32:]
    sigs[4] = (2).to_bytes(32, "little") + sigs[4][32:]
    t = _torsion8()

    def sign_with(i, r, r_pt, pk):
        r_enc = ed._encode_point(ed._affine(r_pt))
        h = int.from_bytes(hashlib.sha512(r_enc + pk + MSG).digest(),
                           "little") % ed.L
        return r_enc + ((r + h * keys[i][0]) % ed.L).to_bytes(32, "little")

    sigs[5] = sign_with(5, 12345, ed._ext_add(ed._base_mul(12345), t),
                        pks[5])
    pks[6] = ed._encode_point(ed._affine(ed._ext_add(
        ed._base_mul(keys[6][0]), t)))
    sigs[6] = sign_with(6, 999, ed._base_mul(999), pks[6])
    sigs[7] = sigs[7][:63]
    return tuple(sigs), tuple(pks)


def test_cofactored_oracle_gives_the_jax_verdicts():
    sigs, pks = _adversarial_batch()
    want = [jed.host_verify_cofactored(s, MSG, p) for s, p in
            zip(sigs, pks)]
    assert want == [True, False, False, False, False, True, True, False]
    assert [ed.host_verify_cofactored(s, MSG, p)
            for s, p in zip(sigs, pks)] == want


def test_provider_verdicts_equal_the_jax_providers():
    """The device path (plain kernels on the CPU, seeded weights), the
    host path and the JAX provider's verdicts on the adversarial batch;
    then an all-valid batch passes the relation without localization."""
    sigs, pks = _adversarial_batch()
    ref = Ed25519TpuCrypto(SEEDS[0], device_threshold=10**9)
    want = ref.verify_batch(sigs, [MSG] * B, pks)
    port = Ed25519CudaCrypto(SEEDS[0], device="cpu", device_threshold=1,
                             rng=random.Random(5))
    assert port.verify_batch(sigs, [MSG] * B, pks) == want
    host = Ed25519CudaCrypto(SEEDS[0], device="cpu")
    assert host.verify_batch(sigs, [MSG] * B, pks) == want
    assert port.calls["verify_batch"] == {"device": 1, "host": 0}
    assert host.calls["verify_batch"] == {"device": 0, "host": 1}
    assert port.verify_aggregated_signature(
        b"".join(sigs[5:7]), MSG, pks[5:7]) is True


def test_device_fault_raises_from_the_provider(monkeypatch):
    """A device step raising a RuntimeError (as a CUDA error would)
    reaches the caller: nothing re-verifies on the host."""
    def broken(*a, **k):
        raise RuntimeError("msm: device fault")

    monkeypatch.setattr(ed25519_cuda, "msm_is_identity", broken)
    port = Ed25519CudaCrypto(SEEDS[0], device="cpu", device_threshold=1)
    sigs = [ed.host_sign(s, MSG) for s in SEEDS[:2]]
    with pytest.raises(RuntimeError, match="device fault"):
        port.verify_batch(sigs, [MSG] * 2,
                          [ed.host_pub_key(s) for s in SEEDS[:2]])


def test_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="is_available"):
        Ed25519CudaCrypto(SEEDS[0])
