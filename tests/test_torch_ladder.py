"""The one-launch scalar-multiplication ladders' CPU routes: Ed25519's
(ops/edwards.py ``scalar_mul_bits`` → ``ladder`` → ``ladder_plain``) and
SM2's (ops/weierstrass.py ``dual_scalar_mul_bits`` → ``dual_ladder`` →
``dual_ladder_plain``).  Their packed inputs unpack to exactly the bits
and window digits the step-by-step loops take, invalid lanes' zeroed
scalars included; at 8 bits (a cheap JAX compile) each gives the JAX
package's coordinates (ops/edwards.py and ops/weierstrass.py, window 4)
as canonical integers; at 256 bits, on each provider's device path with
the adversarial batches of tests/test_torch_edwards.py and
tests/test_torch_ecdsa.py (built once a process), each lane matches the
JAX package's host oracle (``_host_mul``, ``HostCurve.mul_add``).
Integer arithmetic: tolerance 0.  The kernels themselves are held to these routes on the
card (tests/test_torch_cuda.py)."""

import random

import jax.numpy as jnp
import numpy as np
import torch

from consensus_overlord_tpu.crypto import ecdsa_tpu as jecdsa
from consensus_overlord_tpu.ops import edwards as jed
from consensus_overlord_tpu.ops import weierstrass as jw
from consensus_overlord_tpu_torch.crypto.ecdsa_cuda import Sm2Crypto
from consensus_overlord_tpu_torch.crypto.ed25519_cuda import (
    Ed25519CudaCrypto)
from consensus_overlord_tpu_torch.ops import edwards as ed
from consensus_overlord_tpu_torch.ops import weierstrass as w

import test_torch_ecdsa
import test_torch_edwards
from test_torch_ecdsa import MSG as MSG_ECDSA
from test_torch_edwards import MSG, SEEDS, _limbs

torch.set_num_threads(1)

B = 4
SM2_HOST = jecdsa.SM2_HOST
#: SM2 points k·G and their (x, y) limb rows.
SM2_QS = [SM2_HOST.mul(k, SM2_HOST.g) for k in (11, 12, 13, 14)]
SM2_QX = w.FQ_SM2.from_ints([q[0] for q in SM2_QS])
SM2_QY = w.FQ_SM2.from_ints([q[1] for q in SM2_QS])
SM2_G = (w.FQ_SM2.from_ints([SM2_HOST.g[0]]),
         w.FQ_SM2.from_ints([SM2_HOST.g[1]]))


def _ints(f, coords):
    """Canonical integers of each coordinate (torch or JAX limbs)."""
    return [f.to_ints(torch.as_tensor(np.array(c))) for c in coords]


def _affine(f, x, y, z):
    """(x/z, y/z) per lane from canonical coordinates, None at z = 0."""
    return [None if zz == 0 else (xx * pow(zz, -1, f.p) % f.p,
                                  yy * pow(zz, -1, f.p) % f.p)
            for xx, yy, zz in zip(*_ints(f, (x, y, z)))]


def test_packed_bits_unpack_to_the_ladder_bits():
    """pack_bits → unpack_bits gives the bits scalar_mul_steps walks, at
    256 bits (eight words) and at lengths that end inside a word; word 0
    holds a scalar's top 32 bits."""
    ks = [0, 1, ed.L - 1, 2**256 - 19]  # 0: an invalid lane's weight
    bits = torch.from_numpy(ed.int_to_bits_msb(ks, 256)).to(torch.uint8)
    packed = ed.pack_bits(bits)
    assert packed.shape == (B, 8) and packed.dtype == torch.int32
    assert torch.equal(ed.unpack_bits(packed, 256), bits.to(torch.int32))
    assert [int(v) & 0xffffffff for v in packed[:, 0]] == [
        k >> 224 for k in ks]
    rng = np.random.default_rng(94)
    for nbits in (1, 8, 40):
        bits = torch.from_numpy(rng.integers(0, 2, size=(B, nbits),
                                             dtype=np.int32))
        assert torch.equal(ed.unpack_bits(ed.pack_bits(bits), nbits), bits)


def _bits_int(row) -> int:
    return int("".join(str(int(v)) for v in row), 2)


def test_ed_ladder_on_the_provider_path(monkeypatch):
    """Ed25519CudaCrypto's device path (plain kernels on the CPU) on four
    lanes of the adversarial batch (valid, a wrong signer, s >= L, R with
    y >= p): the packed bits unpack to the bits msm_is_identity hands
    scalar_mul_bits, the invalid lanes' weights 0, and every lane of the
    256-bit ladder with a nonzero scalar equals the JAX package's affine
    _host_mul of its point."""
    seen = {}
    smb, ladder = ed.scalar_mul_bits, ed.ladder

    def smb_spy(p, bits):
        seen["bits"] = bits
        return smb(p, bits)

    def ladder_spy(p, packed, nbits):
        seen.update(p=p, packed=packed, nbits=nbits)
        seen["r"] = ladder(p, packed, nbits)
        return seen["r"]

    monkeypatch.setattr(ed, "scalar_mul_bits", smb_spy)
    monkeypatch.setattr(ed, "ladder", ladder_spy)
    sigs, pks = test_torch_edwards._adversarial_batch()
    port = Ed25519CudaCrypto(SEEDS[0], device="cpu", device_threshold=1,
                             rng=random.Random(5))
    assert port.verify_batch(sigs[:B], [MSG] * B, pks[:B]) == [
        True, False, False, False]

    bits = seen["bits"]
    assert seen["nbits"] == 256 and seen["packed"].shape == (len(bits), 8)
    assert torch.equal(ed.unpack_bits(seen["packed"], 256),
                       bits.to(torch.int32))
    size = (len(bits) - 2) // 2  # lanes: the R's, the A's, B and a pad
    ks = [_bits_int(row) for row in bits]
    live = [i for i, k in enumerate(ks) if k]
    # s >= L and y >= p weigh 0, as do the pad lanes.
    assert live == [0, 1, size, size + 1, 2 * size]
    pts = _affine(ed.FE, seen["p"].x, seen["p"].y, seen["p"].z)
    got = _affine(ed.FE, seen["r"].x, seen["r"].y, seen["r"].z)
    assert [got[i] for i in live] == [jed._host_mul(pts[i], ks[i])
                                      for i in live]


def test_sm2_ladder_on_the_provider_path(monkeypatch):
    """Sm2Crypto's device path (plain kernels on the CPU) on four lanes
    of the adversarial batch (valid, a wrong signer, another hash, r = 0):
    the packed digits unpack to the window digits of the bits
    verify_lanes hands dual_scalar_mul_bits (the invalid lane's zeroed),
    and the 256-bit ladder's R = u1·G + u2·Q equals HostCurve.mul_add on
    every valid lane."""
    seen = {}
    dual, ladder = w.dual_scalar_mul_bits, w.dual_ladder

    def dual_spy(ops, g, g_bits, q, q_bits):
        seen.update(q=q, g_bits=g_bits, q_bits=q_bits)
        return dual(ops, g, g_bits, q, q_bits)

    def ladder_spy(tg, tq, packed, windows):
        seen.update(packed=packed, windows=windows)
        seen["r"] = ladder(tg, tq, packed, windows)
        return seen["r"]

    monkeypatch.setattr(w, "dual_scalar_mul_bits", dual_spy)
    monkeypatch.setattr(w, "dual_ladder", ladder_spy)
    sigs, pks = test_torch_ecdsa._adversarial_batch("sm2")
    port = Sm2Crypto(0x3000, device="cpu", device_threshold=1)
    assert port.verify_batch(sigs[:B], [MSG_ECDSA] * B, pks[:B]) == [
        True, False, False, False]

    f = w.FQ_SM2
    lanes = len(seen["g_bits"])
    assert seen["windows"] == 64 and seen["packed"].shape == (lanes, 16)
    dg, dq = w.unpack_digits(seen["packed"], 64)
    assert torch.equal(dg, w._window_digits(seen["g_bits"], 4))
    assert torch.equal(dq, w._window_digits(seen["q_bits"], 4))
    assert dg[:, :3].any() and dq[:, :3].any()
    assert not (dg[:, 3:].any() or dq[:, 3:].any())  # r = 0, the pad
    u1 = [_bits_int(row) for row in seen["g_bits"][:3]]
    u2 = [_bits_int(row) for row in seen["q_bits"][:3]]
    qs = _affine(f, *(c[:3] for c in seen["q"]))
    assert _affine(f, *(c[:3] for c in seen["r"])) == [
        SM2_HOST.mul_add(a, b, q) for a, b, q in zip(u1, u2, qs)]


def test_ed_ladder_matches_jax_at_8_bits():
    """The CPU route of the ladder on loose limbs against the JAX
    package's scalar_mul_bits and today's step-by-step loop."""
    rng = np.random.default_rng(95)
    loose = [_limbs(rng, B) for _ in range(4)]
    bits = rng.integers(0, 2, size=(B, 8), dtype=np.int32)
    bits[0], bits[1] = 1, 0
    p = ed.EdPoint(*map(torch.from_numpy, loose))
    got = ed.scalar_mul_bits(p, torch.from_numpy(bits))
    want = jed.scalar_mul_bits(jed.EdPoint(*map(jnp.asarray, loose)),
                               jnp.asarray(bits))
    assert _ints(ed.FE, got) == _ints(ed.FE, want)
    steps = ed.scalar_mul_steps(p, torch.from_numpy(bits))
    assert all(torch.equal(a, b) for a, b in zip(got, steps))


def test_sm2_ladder_matches_jax_at_8_bits():
    """The CPU route of SM2's dual ladder (window 4, two windows) against
    the JAX package's dual_scalar_mul_bits, today's step-by-step loop and
    HostCurve.mul_add."""
    rng = np.random.default_rng(96)
    f = w.FQ_SM2
    u1, u2 = (rng.integers(0, 2, size=(B, 8), dtype=np.int32)
              for _ in range(2))
    u1[0], u2[1] = 0, 0
    g = w.SM2.from_affine(*map(torch.from_numpy, SM2_G))
    q = w.SM2.from_affine(torch.from_numpy(SM2_QX), torch.from_numpy(SM2_QY))
    got = w.dual_scalar_mul_bits(w.SM2, g, torch.from_numpy(u1), q,
                                 torch.from_numpy(u2))
    want = jw.dual_scalar_mul_bits(
        jw.SM2, jw.SM2.from_affine(*map(jnp.asarray, SM2_G)),
        jnp.asarray(u1),
        jw.SM2.from_affine(jnp.asarray(SM2_QX), jnp.asarray(SM2_QY)),
        jnp.asarray(u2))
    assert _ints(f, got) == _ints(f, want)
    steps = w.dual_scalar_mul_steps(w.SM2, g, torch.from_numpy(u1), q,
                                    torch.from_numpy(u2))
    assert all(torch.equal(a, b) for a, b in zip(got, steps))
    weights = 1 << np.arange(7, -1, -1)
    assert _affine(f, *got) == [
        SM2_HOST.mul_add(int(a @ weights), int(b @ weights), qq)
        for a, b, qq in zip(u1, u2, SM2_QS)]
