"""graftlint CLI for the port — the twin of scripts/graftlint.py.

    python -m consensus_overlord_tpu_torch.analysis            # human output
    python -m consensus_overlord_tpu_torch.analysis --json     # machine output
    python -m consensus_overlord_tpu_torch.analysis --rules CUDA001,CONC002 f.py
    python -m consensus_overlord_tpu_torch.analysis --baseline baseline.json
    python -m consensus_overlord_tpu_torch.analysis --write-baseline new.json
    python -m consensus_overlord_tpu_torch.analysis --list-rules

Stdlib-only and device-free (ast + tokenize; no torch or jax import).
Exit codes: 0 = clean (inline-suppressed and baselined findings don't
count), 1 = actionable findings, 2 = usage or internal error.  Rule
catalog, suppression syntax and the baseline workflow:
consensus_overlord_tpu_torch/analysis/README.md.
"""

import argparse
import json
import os
import sys

from . import Project, all_rules, run_rules
from .core import write_baseline

#: The checkout this package lives in.
_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="graftlint",
        description="AST-based invariant checker of the PyTorch/CUDA "
                    "port: host syncs on device paths, limb discipline, "
                    "lock and device-failure rules, and the metric & RNG "
                    "contracts")
    ap.add_argument("paths", nargs="*",
                    help="explicit files for the code rules (default: "
                         "the rule's own file scope under the package)")
    ap.add_argument("--root", default=_ROOT,
                    help="repo root (default: the checkout this package "
                         "lives in)")
    ap.add_argument("--rules", default=None,
                    help="comma-separated rule codes (default: all)")
    ap.add_argument("--json", action="store_true", dest="as_json",
                    help="machine-readable JSON on stdout")
    ap.add_argument("--baseline", default=None,
                    help="JSON baseline of accepted findings (each "
                         "entry needs a reason)")
    ap.add_argument("--write-baseline", default=None, metavar="PATH",
                    help="write the current findings as a baseline "
                         "skeleton (reasons left empty for a human to "
                         "justify) and exit")
    ap.add_argument("--list-rules", action="store_true",
                    help="print the rule codes and exit")
    args = ap.parse_args(argv)

    if args.list_rules:
        for code in sorted(all_rules()):
            print(code)
        return 0

    overrides = {}
    if args.paths:
        overrides["files"] = args.paths
    rules = ([r.strip() for r in args.rules.split(",") if r.strip()]
             if args.rules else None)
    project = Project(args.root, overrides=overrides)
    try:
        result = run_rules(project, rules=rules,
                           baseline_path=args.baseline)
    except ValueError as e:
        print(f"graftlint: {e}", file=sys.stderr)
        return 2

    if args.write_baseline:
        write_baseline(args.write_baseline, result.findings)
        print(f"graftlint: wrote {len(result.findings)} entr"
              f"{'y' if len(result.findings) == 1 else 'ies'} to "
              f"{args.write_baseline} — fill in each \"reason\" before "
              "pointing --baseline at it")
        return 0

    if args.as_json:
        print(json.dumps(result.to_dict(), indent=2))
        return result.exit_code

    for f in result.findings:
        print(f.render())
    tail = (f"{len(result.findings)} finding(s)"
            f" ({len(result.suppressed)} suppressed,"
            f" {len(result.baselined)} baselined)")
    if result.findings:
        print(f"graftlint: FAIL — {tail}")
    else:
        print(f"graftlint: ok — {tail}")
    return result.exit_code


if __name__ == "__main__":
    sys.exit(main())
