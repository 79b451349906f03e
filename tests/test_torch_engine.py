"""The port's host stack (engine/wal.py, engine/smr.py, sim/router.py,
sim/harness.py and the sim-grade providers) against the JAX package's:
WAL files written by either package load in the other, the sharded
router reproduces the golden seed-7 counters at 1 and 4 shards, and
4-validator simhash fleets of both packages commit the same blocks,
each proof auditing under both packages.  Tolerance: none (bytes,
counters, verdicts)."""

import asyncio
import dataclasses
import enum
import json

import pytest

from consensus_overlord_tpu.core import bitmap as jbitmap
from consensus_overlord_tpu.core import types as jtypes
from consensus_overlord_tpu.core.sm3 import sm3_hash as jsm3
from consensus_overlord_tpu.crypto import provider as jprovider
from consensus_overlord_tpu.engine import smr as jsmr
from consensus_overlord_tpu.engine import wal as jwal
from consensus_overlord_tpu.sim import SimNetwork as JSimNetwork
from consensus_overlord_tpu_torch.core import bitmap as tbitmap
from consensus_overlord_tpu_torch.core import types as ttypes
from consensus_overlord_tpu_torch.core.sm3 import sm3_hash as tsm3
from consensus_overlord_tpu_torch.crypto import provider as tprovider
from consensus_overlord_tpu_torch.engine import smr as tsmr
from consensus_overlord_tpu_torch.engine import wal as twal
from consensus_overlord_tpu_torch.sim import SimNetwork as TSimNetwork
from consensus_overlord_tpu_torch.sim.router import ShardedRouter
from test_sim_fabric import COUNTER_KEYS, GOLDEN, _scripted_traffic

PACKAGES = {"jax": (jtypes, jbitmap, jprovider, jsmr, jwal, jsm3),
            "torch": (ttypes, tbitmap, tprovider, tsmr, twal, tsm3)}


def run(coro, timeout=60):
    return asyncio.run(asyncio.wait_for(coro, timeout))


def plain(obj):
    if dataclasses.is_dataclass(obj):
        return {f.name: plain(getattr(obj, f.name))
                for f in dataclasses.fields(obj)}
    if isinstance(obj, enum.Enum):
        return int(obj.value)
    return obj


# -- the WAL -------------------------------------------------------------------

def _engine_with_state(pkg: str, wal, locked: bool):
    """An engine of `pkg` over `wal`, holding a position, its own votes
    and (optionally) a lock: everything _save_wal persists."""
    t, _, p, smr, _, _ = PACKAGES[pkg]
    crypto = p.SimHashCrypto(b"\x07" * 32)
    eng = smr.Engine(crypto.pub_key, None, crypto, wal)
    eng.height, eng.round = 12, 3
    eng._my_prevote_round, eng._my_precommit_round = 3, 2
    if locked:
        qc = t.AggregatedVote(t.AggregatedSignature(b"\x5a" * 96, b"\xe0"),
                              t.VoteType.PREVOTE, 12, 2, b"\x42" * 32,
                              b"\x11" * 32)
        eng.lock_round = 2
        eng.lock_proposal = t.Proposal(12, 2, b"content", b"\x42" * 32, qc,
                                       b"\x22" * 32)
        eng.lock_qc = qc
    return eng


@pytest.mark.parametrize("locked", [False, True])
@pytest.mark.parametrize("writer,reader", [("jax", "torch"),
                                           ("torch", "jax")])
def test_file_wal_loads_across_packages(tmp_path, writer, reader, locked):
    async def main():
        wal_w = PACKAGES[writer][4].FileWal(str(tmp_path / writer))
        await _engine_with_state(writer, wal_w, locked)._save_wal()
        other = PACKAGES[reader][4].FileWal(str(tmp_path / "other"))
        await _engine_with_state(reader, other, locked)._save_wal()
        blob_w = (tmp_path / writer / "overlord.wal").read_bytes()
        blob_o = (tmp_path / "other" / "overlord.wal").read_bytes()
        assert blob_w == blob_o  # the same frame, byte for byte
        wal_r = PACKAGES[reader][4].FileWal(str(tmp_path / writer))
        got = await _engine_with_state(reader, wal_r, False)._load_wal()
        want = await _engine_with_state(writer, wal_w, False)._load_wal()
        return got, want

    got, want = run(main())
    assert got is not None and plain(got) == plain(want)
    assert (got.lock_proposal is not None) == locked
    assert (got.height, got.round, got.my_prevote_round,
            got.my_precommit_round) == (12, 3, 3, 2)


def test_corrupt_wal_is_quarantined_alike(tmp_path):
    """A torn frame written by either package is quarantined by both."""
    blob = twal.frame_record(b"\xc5\x0c\x03\x04\x03\xc0")[:-1]
    seen = []
    for name, mod in (("jax", jwal), ("torch", twal)):
        d = tmp_path / name
        d.mkdir()
        (d / "overlord.wal").write_bytes(blob)
        w = mod.FileWal(str(d))
        seen.append(run(w.load()))
        assert (d / "overlord.wal.corrupt").read_bytes() == blob
    assert seen == [None, None]


# -- the router's seed contract --------------------------------------------------

def _run_script(shards, seed=7):
    async def main():
        router = ShardedRouter(seed=seed, drop_rate=0.2,
                               delay_range=(0.0, 0.005), shards=shards,
                               worker="inline")
        counts = {}
        nodes = [bytes([i + 1]) * 8 for i in range(8)]
        try:
            await _scripted_traffic(router, nodes, counts)
            stats = router.stats()
        finally:
            router.close()
        return stats, counts
    return run(main())


@pytest.mark.parametrize("shards", [1, 4])
def test_router_matches_the_golden_seed7_counters(shards):
    golden = json.loads(GOLDEN.read_text())
    stats, counts = _run_script(shards)
    for k in COUNTER_KEYS:
        assert stats[k] == golden["counters"][k], (k, stats[k])
    assert {a.hex(): n for a, n in counts.items()} == \
        golden["per_target_delivered"]


# -- the engine on the fast provider ---------------------------------------------

def _fleet(pkg: str, heights: int):
    """Blocks and proofs a 4-validator simhash fleet of `pkg` commits."""
    _, _, p, _, _, _ = PACKAGES[pkg]
    net_cls = JSimNetwork if pkg == "jax" else TSimNetwork

    async def main():
        net = net_cls(n_validators=4, block_interval_ms=100, seed=3,
                      crypto_factory=lambda i: p.SimHashCrypto(
                          (0x5000 + 7919 * i).to_bytes(32, "big")))
        net.start(init_height=1)
        try:
            await net.run_until_height(heights, timeout=30)
        finally:
            await net.stop()
        c = net.controller
        assert not c.violations
        return ({h: c.chain[h] for h in range(1, heights + 1)},
                {h: c.proofs[h] for h in range(1, heights + 1)},
                c.authority_list())

    return run(main())


def _audit(pkg: str, proof_bytes: bytes, authority, want_height: int):
    """The proof check of tests/test_engine.py TestBlsEndToEnd, under
    `pkg`'s own types, bitmap and provider."""
    t, b, p, _, _, sm3 = PACKAGES[pkg]
    proof = t.Proof.decode(proof_bytes)
    assert proof.height == want_height
    nodes = [t.Node(n.address, n.propose_weight, n.vote_weight)
             for n in authority]
    voters = b.extract_voters(nodes, proof.signature.address_bitmap)
    assert 3 * len(voters) > 2 * len(nodes)  # a quorum signed
    vote = t.Vote(proof.height, proof.round, t.VoteType.PRECOMMIT,
                  proof.block_hash)
    return p.SimHashCrypto(b"\x00" * 32).verify_aggregated_signature(
        proof.signature.signature, sm3(vote.encode()), voters), proof


def test_simhash_fleets_commit_the_same_blocks():
    heights = 5
    t_chain, t_proofs, t_auth = _fleet("torch", heights)
    j_chain, j_proofs, j_auth = _fleet("jax", heights)
    assert [n.address for n in t_auth] == [n.address for n in j_auth]
    for h in range(1, heights + 1):
        assert t_chain[h] == j_chain[h], h
        for proofs, auth in ((t_proofs, t_auth), (j_proofs, j_auth)):
            hashes = set()
            for pkg in PACKAGES:
                ok, proof = _audit(pkg, proofs[h], auth, h)
                assert ok, (pkg, h)
                hashes.add(proof.block_hash)
            assert len(hashes) == 1
        t_hash = ttypes.Proof.decode(t_proofs[h]).block_hash
        assert t_hash == jtypes.Proof.decode(j_proofs[h]).block_hash


class _Raising:
    """A provider whose batch call raises; `breaker` says whether it
    carries a circuit breaker of its own."""

    def __init__(self, breaker):
        self.breaker = breaker
        self.host_calls = 0

    def verify_batch(self, sigs, hashes, voters):
        raise RuntimeError("launch failed")

    def verify_signature(self, sig, h, voter):
        self.host_calls += 1
        return True


@pytest.mark.parametrize("breaker", [None, object()],
                         ids=["breaker_less", "own_breaker"])
def test_frontier_reverifies_only_for_breaker_less_providers(breaker):
    """A breaker-less provider's failed batch is re-verified on its host
    oracle (counted in stats.reverified); a provider with its own breaker
    has already degraded where it was built to, so its exception reaches
    every waiter and is kept as the frontier's fault."""
    from consensus_overlord_tpu_torch.crypto.frontier import BatchingVerifier

    prov = _Raising(breaker)

    async def main():
        f = BatchingVerifier(prov, max_batch=4, linger_s=0.001)
        try:
            return await asyncio.gather(
                *(f.verify(b"s%d" % i, b"h" * 32, b"v") for i in range(3)),
                return_exceptions=True), f
        finally:
            f.close()

    results, f = asyncio.run(main())
    if breaker is None:
        assert results == [True] * 3 and prov.host_calls == 3
        assert (f.stats.reverified, f.stats.device_faults) == (1, 0)
        assert f.fault is None
    else:
        assert all(isinstance(r, RuntimeError) for r in results)
        assert prov.host_calls == 0
        assert (f.stats.reverified, f.stats.device_faults) == (0, 1)
        assert isinstance(f.fault, RuntimeError)
