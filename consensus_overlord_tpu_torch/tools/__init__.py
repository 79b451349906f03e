"""The port's operator tools, each the twin of a script of the JAX
package's scripts/ and run as a module:

  python -m consensus_overlord_tpu_torch.tools.profile_verify  (profile_verify.py)
  python -m consensus_overlord_tpu_torch.tools.pairing_smoke   (pairing_smoke.py)
  python -m consensus_overlord_tpu_torch.tools.warm_cache      (warm_cache.py)

(the ledger CLI, scripts/ledger.py's twin, is
`python -m consensus_overlord_tpu_torch.obs.ledger`).  Each runs on the
card and exits non-zero naming it when none is visible; profile_verify
and pairing_smoke run on the CPU under --cpu.  fixtures.py holds the
signed-vote fixtures they and chip_smoke.py share."""
