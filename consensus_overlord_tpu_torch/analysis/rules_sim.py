"""SIM001 — the chaos generator's append-only RNG draw-order contract.

The port's copy of consensus_overlord_tpu/analysis/rules_sim.py, over
the port's sim/chaos.py, whose legacy draws are the JAX generator's.

`ChaosSchedule.generate` (sim/chaos.py) promises that every NEW event
family draws from the seeded RNG strictly AFTER all legacy draws, so
old seeds replay bit-identically even in schedules that include new
kinds.  One golden fixture (tests/data/chaos_schedule_seed7.json) pins
the behavior for seed 7; this rule pins the *structure* for every seed:

  * the sentinel comment `# graftlint: sim001-legacy-draw-boundary`
    must exist inside `generate` (it marks where the frozen legacy
    draw block ends — everything below it is append territory);
  * the rng draw call sites ABOVE the sentinel must match the pinned
    legacy sequence exactly — inserting, removing, or reordering a
    draw there silently re-seeds every recorded schedule.

Extending the generator legitimately = add draws BELOW the sentinel.
If the legacy block itself must change (a seed-breaking change), update
LEGACY_DRAWS here and regenerate the golden fixture in the same PR.
"""

from __future__ import annotations

import ast
from typing import Iterable, List, Optional, Tuple

from .core import Finding, Project

SIM_CHAOS = "consensus_overlord_tpu_torch/sim/chaos.py"

SENTINEL = "graftlint: sim001-legacy-draw-boundary"

#: The frozen legacy draw block of ChaosSchedule.generate, as rng
#: method names in source order (loops collapse to their call site —
#: the contract pins SITES, the golden fixture pins values).
LEGACY_DRAWS: Tuple[str, ...] = (
    "sample",      # slots = rng.sample(span, n_events)
    "choice",      # short-run fallback: rng.choice(span) per event
    "shuffle",     # rng.shuffle(kinds)
    "sample",      # crash_targets = rng.sample(range(n), crashes)
    "randrange",   # device_fault target
)

RNG_METHODS = {"random", "randrange", "randint", "choice", "choices",
               "sample", "shuffle", "uniform", "gauss", "betavariate",
               "expovariate", "getrandbits", "randbytes"}


def _find_generate(tree: ast.AST) -> Optional[ast.FunctionDef]:
    for node in ast.walk(tree):
        if isinstance(node, ast.ClassDef) and node.name == "ChaosSchedule":
            for sub in node.body:
                if (isinstance(sub, (ast.FunctionDef,
                                     ast.AsyncFunctionDef))
                        and sub.name == "generate"):
                    return sub
    # fixture twins may define a bare generate()
    for node in ast.walk(tree):
        if (isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef))
                and node.name == "generate"):
            return node
    return None


def check_sim001(project: Project) -> Iterable[Finding]:
    rel = project.overrides.get("sim_chaos", SIM_CHAOS)
    sf = project.file(rel)
    if sf is None or sf.tree is None:
        return
    fn = _find_generate(sf.tree)
    if fn is None:
        yield sf.finding(
            "SIM001", 0,
            "ChaosSchedule.generate not found — the RNG draw-order "
            "contract has nothing to anchor to")
        return
    end = max((n.end_lineno or n.lineno for n in ast.walk(fn)
               if hasattr(n, "lineno") and n.lineno is not None),
              default=fn.lineno)
    sentinel_line = None
    for i in range(fn.lineno, min(end, len(sf.lines)) + 1):
        if SENTINEL in sf.lines[i - 1]:
            sentinel_line = i
            break
    if sentinel_line is None:
        yield sf.finding(
            "SIM001", fn.lineno,
            f"generate() has no `# {SENTINEL}` sentinel — the "
            "append-only RNG contract needs an explicit boundary "
            "between the frozen legacy draws and append territory")
        return

    draws: List[Tuple[int, str]] = []
    for node in ast.walk(fn):
        if (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and isinstance(node.func.value, ast.Name)
                and node.func.value.id == "rng"
                and node.func.attr in RNG_METHODS):
            draws.append((node.lineno, node.func.attr))
    draws.sort()
    legacy = tuple(m for ln, m in draws if ln < sentinel_line)
    if legacy != LEGACY_DRAWS:
        # anchor the finding at the first divergent draw site (or the
        # sentinel when a draw was REMOVED past the end)
        at = sentinel_line
        for i, (ln, m) in enumerate(d for d in draws
                                    if d[0] < sentinel_line):
            if i >= len(LEGACY_DRAWS) or m != LEGACY_DRAWS[i]:
                at = ln
                break
        yield sf.finding(
            "SIM001", at,
            f"legacy RNG draw block changed: expected draw sites "
            f"{list(LEGACY_DRAWS)} above the sentinel, found "
            f"{list(legacy)} — inserting/removing/reordering a draw "
            "there re-seeds every recorded chaos schedule (new event "
            "kinds must draw BELOW the sentinel)")


RULES = {"SIM001": check_sim001}
