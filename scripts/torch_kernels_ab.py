#!/usr/bin/env python3
"""Time the port's CUDA kernels of several checkouts on one card, in turn.

    python3 scripts/torch_kernels_ab.py PARENT . . PARENT

Each argument is the root of a checkout holding consensus_overlord_tpu_torch/;
each runs in its own process (the packages share one name), builds its
kernels from its own sources, and prints one JSON line: the device time
per launch of fq_mul (B = 8192 and 131072 lanes, the main path's heaviest
launch size), g1_add (B = 8192 and tree-sum sizes down to one lane) and
g1_dbl (B = 8192), from CUDA events over 100 back-to-back launches held
behind a spin kernel so that the host's issue rate does not enter, and
ptxas's registers and spills of each kernel; where the checkout has the
pairing kernels (csrc/pairing.cu), also miller_product (2 and 5 pairs),
fq12_mul (1 lane) and final_exp (1 lane), over 20 launches; then the
26-limb point kernels: ed_add at 16,386 lanes and wp_add_general at
8,192 (100 launches), and where the checkout has them the one-launch
ladders ed_ladder (16,386 lanes, 256 bits) and wp_dual_ladder (8,192
lanes, 64 windows), over 10 launches, each with its resident warps an
SM where the checkout reports them.  With --curves-only a root builds
and times the 26-limb kernels alone (a sweep of build-time variants:
copies of the package under .ab/ with #defines put in front of
csrc/ed_point.cu and csrc/wp_point.cu).  Inputs are random loose
limbs from --seed (the point formulas are polynomials, so any loose
coordinates time them), the same in every root, and each line carries
a SHA-256 of every output (`digest`): equal digests across roots mean
bit-identical kernels.  Giving the roots as parent, change, change,
parent compares two versions on one card within one run.  Needs a GPU.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys

SIZES = {"fq_mul": (8192, 131072), "g1_add": (1, 16, 256, 4096, 8192),
         "g1_dbl": (8192,)}
PAIRING_SIZES = {"miller_product": (2, 5), "fq12_mul": (1,),
                 "final_exp": (1,)}
#: The 26-limb point kernels' lanes: Ed25519's ladder and SM2's at the
#: 8,192-vote deployments (PERF.md §4).
CURVE_SIZES = {"ed_add": 16386, "wp_add_general": 8192,
               "ed_ladder": 16386, "wp_dual_ladder": 8192}
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _digest(outs) -> str:
    return hashlib.sha256(b"".join(
        t.cpu().numpy().tobytes() for t in outs)).hexdigest()[:16]


def curve_worker(out: dict, seed: int, clock_hz: float) -> None:
    """The 26-limb point kernels of the checkout on the path's lanes, on
    inputs of their own generator (the same with and without
    --curves-only)."""
    from chip_smoke import ptxas_report, time_ms
    import numpy as np
    import torch
    from consensus_overlord_tpu_torch.ops import edwards as ed
    from consensus_overlord_tpu_torch.ops import kernels
    from consensus_overlord_tpu_torch.ops import weierstrass as w
    from consensus_overlord_tpu_torch.ops.curve import Point

    out["ptxas_curves"] = {spec.name: ptxas_report(kernels, spec)
                           for spec in (ed.FE, w.FQ_SM2)}
    rng = np.random.default_rng(seed + 1)

    def loose(spec, *shape):
        return torch.from_numpy(rng.integers(
            0, spec.loose_max + 1, size=shape + (spec.n,),
            dtype=np.int32)).cuda()

    for name, lanes in CURVE_SIZES.items():
        if not hasattr(kernels, name):
            continue
        spec = ed.FE if name.startswith("ed") else w.FQ_SM2
        if name == "ed_add":
            p, q = (ed.EdPoint(*(loose(spec, lanes) for _ in range(4)))
                    for _ in range(2))
            run, launches = (lambda: ed.add(p, q)), 100
        elif name == "wp_add_general":
            p, q = (Point(*(loose(spec, lanes) for _ in range(3)))
                    for _ in range(2))
            run, launches = (lambda: w.SM2.add(p, q)), 100
        elif name == "ed_ladder":
            p = ed.EdPoint(*(loose(spec, lanes) for _ in range(4)))
            packed = ed.pack_bits(torch.from_numpy(rng.integers(
                0, 2, size=(lanes, 256), dtype=np.int32)).cuda())
            run, launches = (lambda: ed.ladder(p, packed, 256)), 10
        else:
            tq = Point(*(loose(spec, 16, lanes) for _ in range(3)))
            tg = Point(*(loose(spec, 16, 1) for _ in range(3)))
            packed = w.pack_digits(*(torch.from_numpy(rng.integers(
                0, 16, size=(64, lanes))).cuda() for _ in range(2)))
            run, launches = (lambda: w.dual_ladder(tg, tq, packed, 64)), 10
        out["digest"][f"{name}@{lanes}"] = _digest(run())
        out[f"{name}@{lanes}"] = time_ms(torch, run, launches, clock_hz)
        if hasattr(kernels, "resident_warps"):
            out[f"{name}_resident_warps"] = kernels.resident_warps(
                name, spec, torch.device("cuda"))


def worker(root: str, seed: int, clock_hz: float,
           curves_only: bool) -> dict:
    sys.path.insert(0, REPO)
    # This checkout's timing and ptxas reading, for every root.
    from chip_smoke import ptxas_report, time_ms
    sys.path.insert(0, os.path.abspath(root))
    import numpy as np
    import torch
    from consensus_overlord_tpu_torch.ops import bls12381_groups as dev
    from consensus_overlord_tpu_torch.ops import kernels

    fq = dev.FQ
    rng = np.random.default_rng(seed)
    if curves_only:
        from consensus_overlord_tpu_torch.ops import edwards as ed
        from consensus_overlord_tpu_torch.ops import weierstrass as w
        out = {"root": root, "digest": {},
               "build_s": kernels.build_all((ed.FE, w.FQ_SM2))}
        curve_worker(out, seed, clock_hz)
        return out
    kernels.build_all()

    def loose(lanes):
        return torch.from_numpy(rng.integers(
            0, fq.loose_max + 1, size=(lanes, fq.n),
            dtype=np.int32)).cuda()

    out = {"root": root, "ptxas": ptxas_report(kernels), "digest": {}}
    for name, sizes in SIZES.items():
        for lanes in sizes:
            a = tuple(loose(lanes) for _ in range(3))
            b = tuple(loose(lanes) for _ in range(3))
            run = {"fq_mul": lambda: kernels.fq_mul(fq, a[0], b[0]),
                   "g1_add": lambda: kernels.g1_add(fq, a, b),
                   "g1_dbl": lambda: kernels.g1_dbl(fq, a)}[name]
            got = run()
            got = got if isinstance(got, tuple) else (got,)
            out["digest"][f"{name}@{lanes}"] = _digest(got)
            out[f"{name}@{lanes}"] = time_ms(torch, run, 100, clock_hz)
    if not hasattr(kernels, "miller_product"):
        return out
    for name, sizes in PAIRING_SIZES.items():
        for lanes in sizes:
            a = loose(lanes * 12).reshape(lanes, 2, 3, 2, fq.n)
            b = loose(lanes * 12).reshape(lanes, 2, 3, 2, fq.n)
            p, q = loose(lanes), loose(lanes * 2).reshape(lanes, 2, fq.n)
            skip = torch.zeros(lanes, dtype=torch.bool, device="cuda")
            run = {"miller_product": lambda: kernels.miller_product(
                       fq, p, p, q, q, skip),
                   "fq12_mul": lambda: kernels.fq12_mul(fq, a, b),
                   "final_exp": lambda: kernels.final_exp(fq, a)}[name]
            out[f"{name}@{lanes}"] = time_ms(torch, run, 20, clock_hz)
    if hasattr(kernels, "all_specs"):
        curve_worker(out, seed, clock_hz)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("roots", nargs="+")
    ap.add_argument("--seed", type=int, default=11)
    ap.add_argument("--curves-only", action="store_true",
                    help="build and time the 26-limb point kernels only")
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--clock-hz", type=float, default=0.0,
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker:
        print(json.dumps(worker(args.roots[0], args.seed, args.clock_hz,
                                args.curves_only)), flush=True)
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
                        "--clock-hz", str(clock_hz)]
                       + ["--curves-only"] * args.curves_only, check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
