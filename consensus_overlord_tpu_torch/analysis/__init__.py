"""graftlint for the port — an AST-based checker of the conventions
that carry the port's correctness and that no test type-checks.

The twin of consensus_overlord_tpu/analysis/, with the port's own
meaning where the two packages differ: kernel launches are asynchronous
and a device error raises (it never moves work to the host).  Stdlib
only (ast + tokenize): it imports neither torch nor jax, so it runs in
any lane.

  CUDA001 host syncs reachable from a device body (TPU001's twin)
  CUDA002 int32-limb upcast hazards in ops/ (TPU002's twin)
  CONC001 class attributes written both under and outside the lock
  CONC002 device-path handlers that neither re-raise nor pass the error
          through the injected-fault gate; readbacks outside the
          dispatch watchdog
  OBS001  metric families / statusz sections out of sync across
          obs/metrics.py, obs/README.md, tests, service/main.py and
          sim/run.py
  SIM001  chaos-generator RNG draws inserted before the append-only
          legacy draw block (sim/chaos.py)
  GL001   malformed `# graftlint: disable=` suppression (missing reason)
  GL002   baseline entry without a reason
  GL003   stale suppression

Run it with `python -m consensus_overlord_tpu_torch.analysis` (see
analysis/README.md for the rule catalog, the suppression syntax and the
baseline workflow).
"""

from .core import (  # noqa: F401
    Finding,
    LintResult,
    Project,
    all_rules,
    load_baseline,
    run_rules,
)
