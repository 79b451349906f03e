#!/usr/bin/env python3
"""Break the pairing interpreter's time into its parts, on one card.

    python3 scripts/torch_pairing_breakdown.py [ROOT ...]

For each checkout root (default: this one), in its own process: the
field-core measuring kernel (csrc/pairing.cu tower_probe_kernel, no
program table) times one dependent product, one dependent addition and
one block barrier, from the difference of a 2k- and a k-long chain (so
the launch drops out), at one warp and at the pairing kernels' full
block; and final_exp_kernel times the measuring programs of
ops/tower_program.py, each less the time of the program with no op
("io"): "fq_inv" (CHAIN-deep product chain), "add_chain" (CHAIN
dependent additions on one lane group) and "add_wide" (the same on 32
lane groups at once).  What one program step costs beyond its op is the
interpreter's own: fetching the op's words and the barriers it keeps.
Each root prints one JSON line, with its programs' statistics.  Every
result is checked against the plain field.  Needs a GPU.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROGRAMS = ("io", "fq_inv", "add_chain", "add_wide")


def worker(root: str, seed: int, clock_hz: float) -> dict:
    sys.path.insert(0, REPO)
    from chip_smoke import time_ms  # this checkout's timing, for every root
    sys.path.insert(0, os.path.abspath(root))
    import numpy as np
    import torch
    from consensus_overlord_tpu_torch.ops import kernels
    from consensus_overlord_tpu_torch.ops import tower_program as tp
    from consensus_overlord_tpu_torch.ops.field import BLS12_381_FQ as fq

    kernels.build_all()
    rng = np.random.default_rng(seed)

    def loose(*shape):
        return torch.from_numpy(rng.integers(
            0, fq.loose_max + 1, size=shape + (fq.n,), dtype=np.int32))

    x, y = loose(1), loose(1)
    xc, yc = x.cuda(), y.cuda()
    k = tp.CHAIN
    want = {"mul": x, "add": x, "barrier": x}
    for _ in range(k):
        want["mul"] = fq.mul(want["mul"], y)
        want["add"] = fq.add(want["add"], y)
    probe = {}
    for mode in kernels.PROBE_MODES:
        got = kernels.tower_probe(fq, xc, yc, mode, k, 32).cpu()
        if not torch.equal(got, want[mode]):
            raise SystemExit(f"tower_probe {mode} differs from the plain "
                             "field")
        for threads in sorted({32, 256, kernels.TOWER_THREADS}):
            t = [time_ms(torch, lambda: kernels.tower_probe(
                fq, xc, yc, mode, kk, threads), 20, clock_hz)
                for kk in (k, 2 * k)]
            probe[f"{mode}@{threads}"] = (t[1] - t[0]) / k * 1e3  # us
    out = {"root": root, "probe_us": probe, "programs": {}}
    f = loose(1, 12)
    fc = f.reshape(1, 2, 3, 2, fq.n).cuda()
    for name in PROGRAMS:
        prog = tp.program(name, fq)
        got = kernels.final_exp(fq, fc, program=name).cpu().reshape(1, 12,
                                                                    fq.n)
        if not torch.equal(got, tp.run_program(prog, fq, f)):
            raise SystemExit(f"program {name} differs from run_program")
        out["programs"][name] = {
            "ms": time_ms(torch, lambda: kernels.final_exp(
                fq, fc, program=name), 20, clock_hz),
            "stats": prog.stats}
    io = out["programs"]["io"]["ms"]
    out["per_step_us"] = {name: (out["programs"][name]["ms"] - io) / k * 1e3
                          for name in PROGRAMS[1:]}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("roots", nargs="*", default=["."])
    ap.add_argument("--seed", type=int, default=13)
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--clock-hz", type=float, default=0.0,
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker:
        print(json.dumps(worker(args.roots[0], args.seed, args.clock_hz)),
              flush=True)
        return 0
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    clock_hz = float(smi.split(",")[2]) * 1e6
    print(json.dumps({"card": smi}), flush=True)
    for root in args.roots:
        subprocess.run([sys.executable, os.path.abspath(__file__), root,
                        "--worker", "--seed", str(args.seed),
                        "--clock-hz", str(clock_hz)], check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
