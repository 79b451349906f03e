"""The port's multi-tenant acceptance harness (consensus_overlord_tpu_torch/
sim/multichain.py, the twin of scripts/sim_multichain.py), in process on
sim_crypto: a small run with a saturating Byzantine tenant meets the
three acceptance conditions and rejects every garbage signature, and a
queue bound so large that nothing sheds fails with the JAX script's
ADMISSION message."""

import json

from consensus_overlord_tpu_torch.sim import multichain

SMALL = ["--chains", "2", "--validators", "3", "--heights", "2",
         "--interval-ms", "50", "--saturate", "1"]


def _lines(out: str):
    return [json.loads(ln) for ln in out.splitlines() if ln.startswith("{")]


def test_saturating_byzantine_tenant_meets_the_acceptance_conditions(
        capsys, tmp_path):
    rc = multichain.main(SMALL + ["--adversarial", "1",
                                  "--out-dir", str(tmp_path)])
    out = capsys.readouterr()
    assert rc == 0, out.err
    lines = _lines(out.out)
    tenants = [d for d in lines if d["metric"] == "tenant-verify-throughput"]
    assert [d["context"]["tenant"] for d in tenants] == ["chain0", "chain1"]
    assert all(d["reached_height"] for d in tenants)
    assert tenants[0]["context"]["adversarial"]
    assert tenants[0]["tenant"]["sheds"] > 0
    (combined,) = [d for d in lines
                   if d["metric"] == "multichain-shared-frontier"]
    assert combined["ok"] and combined["failures"] == []
    assert combined["adversarial_flood"]["sent"] > 0
    assert combined["adversarial_flood"]["ok"] == 0
    assert combined["light_p50_wait_ms"]["chain1"] is not None
    assert {"ledger_version", "env"} <= set(combined)
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "multichain_combined.json", "tenant_chain0.json",
        "tenant_chain1.json"]


def test_a_bound_that_never_sheds_fails_admission(capsys):
    rc = multichain.main(SMALL + ["--tenant-queue-bound", "1000000"])
    out = capsys.readouterr()
    assert rc == 2
    assert ("ADMISSION: saturating tenant chain0 never shed (bound 1000000 "
            "too high or flood too weak; requests=") in out.err
    (combined,) = [d for d in _lines(out.out)
                   if d["metric"] == "multichain-shared-frontier"]
    assert not combined["ok"]
