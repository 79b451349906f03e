"""The port's secp256k1 and SM2 slice (ops/weierstrass.py,
crypto/ecdsa_cuda.py) against the JAX package's (ops/weierstrass.py,
crypto/ecdsa_tpu.py): the two 26-limb fields' tables and plans, the
group laws on the same numpy-seeded inputs (bit-identical limbs:
integer arithmetic, tolerance 0), the per-lane verify (the JAX jit
_verify_kernel's port) against the JAX package's host oracle
HostCurve.mul_add on fixed scalars (exact), keys and signatures byte
for byte, the providers' verdicts on adversarial batches, and the
pubkey cache carried over from a JAX provider
(convert.ecdsa_pubkeys_from_jax)."""

import hashlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from consensus_overlord_tpu.crypto import ecdsa_tpu as jecdsa
from consensus_overlord_tpu.ops import weierstrass as jw
from consensus_overlord_tpu.ops.curve import Point as JPoint
from consensus_overlord_tpu_torch.convert import ecdsa_pubkeys_from_jax
from consensus_overlord_tpu_torch.crypto import ecdsa_cuda
from consensus_overlord_tpu_torch.crypto.ecdsa_cuda import (
    Secp256k1Crypto, Sm2Crypto)
from consensus_overlord_tpu_torch.ops import kernels
from consensus_overlord_tpu_torch.ops import weierstrass as w
from consensus_overlord_tpu_torch.ops.curve import Point, int_to_bits_msb_np

torch.set_num_threads(1)

B = 8
MSG = hashlib.sha256(b"ecdsa slice").digest()
CURVES = {"secp256k1": (w.SECP, jw.SECP, Secp256k1Crypto,
                        jecdsa.Secp256k1Crypto, 0x2000),
          "sm2": (w.SM2, jw.SM2, Sm2Crypto, jecdsa.Sm2Crypto, 0x3000)}


def _same(jax_pt, torch_pt):
    return all(np.array_equal(np.asarray(a), b.numpy())
               for a, b in zip(jax_pt, torch_pt))


@pytest.mark.parametrize("curve", sorted(CURVES))
def test_field_matches_jax(curve):
    ops, jops = CURVES[curve][:2]
    f, jf = ops.f, jops.f
    assert f.n == jf.n == 26 and f.p == jf.p
    assert np.array_equal(f._fold_np, jf._fold_np)
    assert np.array_equal(f._pad_np, jf._pad_np)
    for name in kernels.plan_names(f):
        bounds = kernels.plan_bounds(f, name)
        assert f._plan(list(bounds)) == jf._plan(list(bounds))


@pytest.mark.parametrize("curve", sorted(CURVES))
def test_group_law_matches_jax(curve):
    """add (and secp256k1's dedicated doubling) on loose limbs and on
    curve points, and on_curve: the port's limbs equal the JAX
    package's."""
    ops, jops, prov = CURVES[curve][:3]
    f = ops.f
    rng = np.random.default_rng(81)
    loose = [rng.integers(0, f.loose_max + 1, size=(B, f.n), dtype=np.int32)
             for _ in range(6)]
    host = prov.host
    aff = [host.mul(int(rng.integers(1, 2**60)), host.g) for _ in range(B)]
    aff[3] = aff[2]  # a doubling lane inside the add
    xs = f.from_ints([a[0] for a in aff])
    ys = f.from_ints([a[1] for a in aff])
    pts = (ops.from_affine(torch.from_numpy(xs), torch.from_numpy(ys)),
           jops.from_affine(jnp.asarray(xs), jnp.asarray(ys)))
    for tp, tq, jp, jq in (
            (Point(*map(torch.from_numpy, loose[:3])),
             Point(*map(torch.from_numpy, loose[3:])),
             JPoint(*map(jnp.asarray, loose[:3])),
             JPoint(*map(jnp.asarray, loose[3:]))),
            (pts[0], Point(*(c.roll(1, 0) for c in pts[0])), pts[1],
             JPoint(*(jnp.roll(c, 1, 0) for c in pts[1])))):
        assert _same(jops.add(jp, jq), ops.add(tp, tq))
        assert _same(jops.dbl(jp), ops.dbl(tp))
    assert np.array_equal(np.asarray(jops.on_curve(pts[1])),
                          ops.on_curve(pts[0]).numpy())
    assert ops.on_curve(pts[0]).all()


@pytest.mark.parametrize("curve", sorted(CURVES))
def test_verify_lanes_matches_the_host_oracle(curve):
    """verify_lanes on fixed scalars: R = u1·G + u2·Q against the JAX
    package's HostCurve.mul_add, with x-lifts that hit, miss, and a lane flagged
    invalid whose coordinates are garbage."""
    ops = CURVES[curve][0]
    f = ops.f
    host = {"secp256k1": jecdsa.SECP_HOST, "sm2": jecdsa.SM2_HOST}[curve]
    qs = [host.mul(k, host.g) for k in (11, 12, 13, 14)]
    u1 = [5, 2**200 + 17, host.n - 1, 9]
    u2 = [7, 3, 2**255 % host.n, 1]
    want_x = [host.mul_add(a, b, q)[0] for a, b, q in zip(u1, u2, qs)]
    c1 = [want_x[0], want_x[1] ^ 1, want_x[2], want_x[3]]
    qx = f.from_ints([q[0] for q in qs])
    qx[3] = f.loose_max  # garbage on the invalid lane
    got = ecdsa_cuda.verify_lanes(
        curve, torch.from_numpy(qx),
        torch.from_numpy(f.from_ints([q[1] for q in qs])),
        torch.tensor([True, True, True, False]),
        torch.from_numpy(int_to_bits_msb_np(u1, 256)),
        torch.from_numpy(int_to_bits_msb_np(u2, 256)),
        torch.from_numpy(f.from_ints(c1)), torch.from_numpy(f.from_ints(c1)))
    assert got.tolist() == [True, False, True, False]


@pytest.mark.parametrize("curve", sorted(CURVES))
def test_keys_and_signatures_equal_the_jax_providers(curve):
    prov, jprov, base = CURVES[curve][2:]
    for k in (base, base + 7919):
        port, ref = prov(k, device="cpu"), jprov(k)
        assert port.pub_key == ref.pub_key
        assert port.sign(MSG) == ref.sign(MSG)


def _adversarial_batch(curve):
    """Eight lanes: valid ones, a wrong signer, a wrong hash, r = 0, an
    undecodable voter, and the scheme's own rule (secp256k1: high s;
    SM2: r + s ≡ 0 mod n)."""
    prov, _, base = CURVES[curve][2:]
    provs = [prov(base + 7919 * i, device="cpu") for i in range(B)]
    sigs = [p.sign(MSG) for p in provs]
    pks = [p.pub_key for p in provs]
    n = prov.host.n
    sigs[1] = provs[0].sign(MSG)
    sigs[2] = provs[2].sign(hashlib.sha256(b"other").digest())
    sigs[3] = bytes(32) + sigs[3][32:]
    pks[4] = b"\x02" + bytes(32)
    r = int.from_bytes(sigs[5][:32], "big")
    s = int.from_bytes(sigs[5][32:], "big")
    s_bad = n - s if curve == "secp256k1" else n - r
    sigs[5] = sigs[5][:32] + s_bad.to_bytes(32, "big")
    return sigs, pks


@pytest.mark.parametrize("curve", sorted(CURVES))
def test_provider_verdicts_equal_the_jax_providers(curve):
    """The device path (plain kernels on the CPU), the host path, the
    JAX provider and the QC path on one adversarial batch."""
    prov, jprov, base = CURVES[curve][2:]
    sigs, pks = _adversarial_batch(curve)
    want = jprov(base, device_threshold=10**9).verify_batch(
        sigs, [MSG] * B, pks)
    assert want == [True, False, False, False, False, False, True, True]
    port = prov(base, device="cpu", device_threshold=1)
    assert port.verify_batch(sigs, [MSG] * B, pks) == want
    assert prov(base, device="cpu").verify_batch(sigs, [MSG] * B,
                                                 pks) == want
    assert port.calls["verify_batch"] == {"device": 1, "host": 0}
    agg = port.aggregate_signatures(sigs[6:], pks[6:])
    assert port.verify_aggregated_signature(agg, MSG, pks[6:]) is True
    assert port.calls["verify_batch"] == {"device": 2, "host": 0}


def test_pubkey_cache_carries_over_from_jax():
    """A JAX Secp256k1Crypto's validated keys (rows and index, an
    undecodable voter at −1) load into the port's provider as they are
    and serve its device path."""
    sigs, pks = _adversarial_batch("secp256k1")
    ref = jecdsa.Secp256k1Crypto(0x2000, device_threshold=10**9)
    ref._pk_rows_of(pks)
    cache = ecdsa_pubkeys_from_jax(ref._pk_x, ref._pk_y, ref._pk_index)
    assert cache.index[pks[4]] == -1
    port = Secp256k1Crypto(0x2000, device="cpu", device_threshold=1)
    port.load_pubkey_cache(cache)
    assert np.array_equal(port._pk_x, ref._pk_x)
    assert port.verify_batch(sigs, [MSG] * B, pks) == ref.verify_batch(
        sigs, [MSG] * B, pks)
    assert port._pk_x.shape[0] == ref._pk_x.shape[0]  # nothing re-added
    with pytest.raises(ValueError, match="past the cached rows"):
        ecdsa_pubkeys_from_jax(ref._pk_x[:2], ref._pk_y[:2], ref._pk_index)


@pytest.mark.parametrize("curve", sorted(CURVES))
def test_device_fault_raises_from_the_provider(curve, monkeypatch):
    """A device step raising a RuntimeError (as a CUDA error would)
    reaches the caller: nothing re-verifies on the host."""
    def broken(*a, **k):
        raise RuntimeError("verify_lanes: device fault")

    monkeypatch.setattr(ecdsa_cuda, "verify_lanes", broken)
    prov, _, base = CURVES[curve][2:]
    port = prov(base, device="cpu", device_threshold=1)
    with pytest.raises(RuntimeError, match="device fault"):
        port.verify_batch([port.sign(MSG)], [MSG], [port.pub_key])
