"""The G2 table MSM of the port (ROADMAP item 11) on the CPU: ops/curve.py
msm_table_build and msm_from_tables against the JAX package's jitted
ones (limb for limb) and against the host oracle at the default 16 × 16
windows; the table device steps of crypto/cuda_provider.py against the
ladder steps on the same inputs; and CudaBlsCrypto(g2_table_msm=True),
the twin of tests/test_pairing.py TestG2TableMsm, verdict for verdict
against the ladder provider and CpuBlsCrypto.

Every provider here runs on device="cpu" (each kernel's plain version)
with the pubkey cache's capacity ladder cut to one 8-row rung, so a
table build stays small; pubkeys validate on the host (the QC
threshold is high) and the pairing is the host's."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from consensus_overlord_tpu.ops import bls12381_groups as jdev
from consensus_overlord_tpu_torch.core.sm3 import sm3_hash
from consensus_overlord_tpu_torch.crypto import bls12381 as oracle
from consensus_overlord_tpu_torch.crypto import cuda_provider
from consensus_overlord_tpu_torch.crypto.cuda_provider import CudaBlsCrypto
from consensus_overlord_tpu_torch.crypto.provider import CpuBlsCrypto
from consensus_overlord_tpu_torch.ops import bls12381_groups as tdev
from consensus_overlord_tpu_torch.ops import kernels
from consensus_overlord_tpu_torch.ops.curve import Point

# One intra-op thread: several worker processes share the cores.
torch.set_num_threads(1)

KEYS = [0x7AB1E * (i + 1) + 3 for i in range(8)]
N = 6  # validators of the first reconfigure; two more join later


def _bits(scalars, nbits):
    return np.array([[(s >> (nbits - 1 - i)) & 1 for i in range(nbits)]
                     for s in scalars], np.int32)


def _g2_points(rng, k):
    return [oracle.g2_mul(oracle.G2_GEN, int(rng.integers(1, 2**62)))
            for _ in range(k)]


def test_table_build_and_msm_bit_equal_to_jax():
    """windows = 2, digits = 4 over R = 3 rows (an identity row among
    them), B = 5 lanes with repeated rows and an all-zero (masked)
    lane: the tables and the sum limb for limb as the JAX functions give
    them (run op by op: compiling them costs more than running them)."""
    rng = np.random.default_rng(5)
    pts = _g2_points(rng, 2) + [None]
    scalars = [0b1011, 0b0110, 0, 0b1111, 0b0001]
    rows = np.array([0, 1, 1, 2, 0], np.int32)
    bits = _bits(scalars, 4)

    jtab = jdev.G2.msm_table_build(jdev.g2_from_oracle(pts), 2, 4)
    want = jdev.G2.msm_from_tables(jtab, jnp.asarray(rows),
                                   jnp.asarray(bits))
    ttab = tdev.G2.msm_table_build(tdev.g2_from_oracle(pts), 2, 4)
    got = tdev.G2.msm_from_tables(ttab, torch.from_numpy(rows),
                                  torch.from_numpy(bits))
    for j, t in zip(jtab, ttab):
        assert t.shape == (3, 2, 4, 2, tdev.FQ.n)
        assert np.array_equal(np.asarray(j), t.numpy())
    for j, t in zip(want, got):
        assert np.array_equal(np.asarray(j), t.numpy())


def test_default_tables_sum_as_the_oracle():
    """16 windows × 16 digits over 2 rows, 64-bit scalars: Σ k_i·P_row_i
    of the host oracle, and (B, k) lanes give one sum per column."""
    rng = np.random.default_rng(9)
    pts = _g2_points(rng, 2)
    scalars = [int(v) for v in rng.integers(1, 2**63, size=3)]
    rows = [0, 1, 0]
    tab = tdev.G2.msm_table_build(tdev.g2_from_oracle(pts))
    assert tab.x.shape == (2, 16, 16, 2, tdev.FQ.n)
    bits = torch.from_numpy(_bits(scalars, 64))
    got = tdev.G2.msm_from_tables(tab, torch.tensor(rows), bits)
    want = None
    for r, s in zip(rows, scalars):
        want = oracle.g2_add(want, oracle.g2_mul(pts[r], s))
    assert tdev.g2_to_oracle(got) == [want]
    # Two columns: the second masks lane 1 out.
    cols = torch.stack([bits, bits * torch.tensor([1, 0, 1])[:, None]], 1)
    got2 = tdev.G2.msm_from_tables(
        tab, torch.tensor(rows)[:, None].expand(-1, 2), cols)
    want2 = None
    for r, s in ((0, scalars[0]), (0, scalars[2])):
        want2 = oracle.g2_add(want2, oracle.g2_mul(pts[r], s))
    assert tdev.g2_to_oracle(Point(*(c[0] for c in got2))) == [want, want2]


# -- the provider ---------------------------------------------------------------

@pytest.fixture(scope="module")
def cpus():
    return [CpuBlsCrypto(k) for k in KEYS]


@pytest.fixture(scope="module")
def providers(cpus):
    """(table provider, ladder provider) over the first N validators,
    with the pubkey-cache ladder cut to one 8-row rung for the module."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(cuda_provider, "_PK_CAPS", (8,))

        def make(tables):
            p = CudaBlsCrypto(KEYS[0], device="cpu", device_threshold=1,
                              qc_device_threshold=10**9,
                              device_pairing=False, g2_table_msm=tables)
            p.update_pubkeys([c.pub_key for c in cpus[:N]])
            return p

        yield make(True), make(False)


def _verdicts(batch, tab, ladder, cpus):
    sigs, hashes, voters = batch
    got = tab.verify_batch(sigs, hashes, voters)
    assert got == ladder.verify_batch(sigs, hashes, voters)
    assert got == [cpus[0].verify_signature(s, h, v)
                   for s, h, v in zip(sigs, hashes, voters)]
    return got


def test_tables_built_at_reconfigure(providers):
    tab, ladder = providers
    assert tab._use_g2_tables and not ladder._use_g2_tables
    assert ladder._pk_tab is None
    assert all(t.shape == (8, 16, 16, 2, tdev.FQ.n) for t in tab._pk_tab)
    assert tab.degraded_status()["g2_table_msm"] is True


def test_table_msm_exact(providers, cpus):
    tab, ladder = providers
    h = sm3_hash(b"tables-1")
    sigs = [c.sign(h) for c in cpus[:N]]
    sigs[1] = cpus[1].sign(sm3_hash(b"bad"))
    got = _verdicts((sigs, [h] * N, [c.pub_key for c in cpus[:N]]), tab,
                    ladder, cpus)
    assert got == [True, False, True, True, True, True]
    assert tab.calls["verify_batch"]["device"] >= 1


def test_table_msm_three_hashes(providers, cpus):
    tab, ladder = providers
    hs = [sm3_hash(b"tables-%d" % g) for g in range(3)]
    hashes = [hs[i % 3] for i in range(N)]
    sigs = [c.sign(h) for c, h in zip(cpus[:N], hashes)]
    sigs[4] = cpus[4].sign(hs[0])  # signed another group's hash
    got = _verdicts((sigs, hashes, [c.pub_key for c in cpus[:N]]), tab,
                    ladder, cpus)
    assert got == [True, True, True, True, False, True]


def test_table_round_steps_equal_the_ladder_steps(providers, cpus):
    """verify_round_tab and verify_round_multi_tab against verify_round
    and verify_round_multi on the same inputs: every output equal."""
    tab, _ = providers
    h = sm3_hash(b"tables-steps")
    sigs = [c.sign(h) for c in cpus[:N]]
    (_, sx, ssign, sinf, sok, wpacked, rows,
     _) = tab._host_prep(sigs, [c.pub_key for c in cpus[:N]], N)
    ins = (sx, ssign, sinf, sok, wpacked, rows)
    gmask = torch.tensor([[i % 2 == 0 for i in range(8)],
                          [i % 2 == 1 for i in range(8)]])
    for want, got in (
            (cuda_provider.verify_round(*ins, *tab._pk_device()),
             cuda_provider.verify_round_tab(*ins, *tab._pk_tab)),
            (cuda_provider.verify_round_multi(*ins, gmask,
                                              *tab._pk_device()),
             cuda_provider.verify_round_multi_tab(*ins, gmask,
                                                  *tab._pk_tab))):
        assert len(want) == len(got)
        assert all(torch.equal(w, g) for w, g in zip(want, got))


def test_tables_rebuilt_after_update(providers, cpus):
    tab, _ = providers
    before = tab._pk_tab
    tab.update_pubkeys([c.pub_key for c in cpus])  # two join
    assert tab._pk_tab is not None and tab._pk_tab is not before
    h = sm3_hash(b"tables-2")
    voters = [c.pub_key for c in cpus]
    assert tab.verify_batch([c.sign(h) for c in cpus], [h] * len(cpus),
                            voters) == [True] * len(cpus)


@pytest.mark.parametrize("value, on", [("1", True), ("0", False),
                                       ("off", False), (None, False)])
def test_table_knob_reads_the_environment(monkeypatch, value, on):
    if value is None:
        monkeypatch.delenv("CONSENSUS_G2_TABLE_MSM", raising=False)
    else:
        monkeypatch.setenv("CONSENSUS_G2_TABLE_MSM", value)
    assert CudaBlsCrypto(KEYS[0], device="cpu")._use_g2_tables is on


def test_g2_plain_versions_launch_nothing():
    """G2.add/dbl on CPU tensors are the plain versions: the generic
    formulas over Fq2 of the plain field, which launch no kernel."""
    rng = np.random.default_rng(3)
    p = tdev.g2_from_oracle(_g2_points(rng, 3) + [None])
    q = tdev.g2_from_oracle(_g2_points(rng, 4))
    kernels.reset_counts()
    assert all(torch.equal(a, b) for a, b in
               zip(tdev.G2.add(p, q), tdev.G2.add_plain(p, q)))
    assert all(torch.equal(a, b) for a, b in
               zip(tdev.G2.dbl(p), tdev.G2.dbl_plain(p)))
    assert not any(kernels.counts().values())
    assert type(tdev.G2._plain.f.fq).__name__ == "PlainField"
