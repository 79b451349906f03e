#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (consensus_overlord_tpu_torch) on one GPU.

    python3 chip_smoke.py [--seed 7]

The quickest proof that the port starts on the card.  It builds the CUDA
kernels from the checkout's sources, then drives the port's main path —
BLS12-381 batch vote verification at the deployment size of bench.py
(8192 votes per batch from 8192 validators, 64-bit RLC weights, the
pubkey cache at its 16384-row rung) — through the entry points a user
calls:

  pubkeys      CudaBlsCrypto(device="cuda").update_pubkeys on every key
               (device G2 decompression + subgroup check), checked
               against the keys' oracle points;
  single_hash  verify_batch on one vote hash, every lane must verify;
  bad_lanes    a single-hash and a 3-hash batch carrying wrong signers,
               malformed encodings, unknown voters and an order-3
               component, verdict for verdict against CpuBlsCrypto;
  mixed        verify_batch over 3 vote hashes (the k=3 rung).

Kernel launch counts are read around the main path and per phase; a
kernel of the path that was never launched fails the run.  A profiled
warm round then reports the device-busy time by kernel.  Then each
kernel is held against its plain PyTorch version at B = 8192 (tolerance
0: integer arithmetic, torch.equal) and timed with CUDA events beside
its plain version and the least time the card could take for the same
work.  Each phase prints one JSON line; the kernels line, the card's
name and power limit, and the contract line close the output.  Any
failure exits non-zero.  Exits 2 without a result when no GPU is
visible; fixtures are cached under .smoke_fixtures/.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys
import time

#: H100 SXM peaks (NVIDIA data sheet, as tabled in the repo's measurement
#: guide): HBM bytes/s, and the float32 CUDA-core rate, used as the 32-bit
#: integer ALU peak with a multiply-add counted as two operations (the
#: table has no int32 row; the int32 rate is not higher, so the bound
#: stays a lower bound).
HBM_BYTES_PER_S = 3.35e12
ALU_OPS_PER_S = 67e12
LANES = 8192
ROOT = os.path.dirname(os.path.abspath(__file__))
FIXTURE_DIR = os.path.join(ROOT, ".smoke_fixtures")


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


# -- fixtures ------------------------------------------------------------------

def make_fixtures(seed: int, validators: int, nhash: int = 3):
    """Validator keys sk_i = s0 + i and their signatures on `nhash` vote
    hashes, built incrementally (pk_i = pk_{i-1} + G2, sig_i = sig_{i-1} +
    H) with the oracle's affine adds; cached by (seed, validators)."""
    import numpy as np
    from consensus_overlord_tpu_torch.core.sm3 import sm3_hash
    from consensus_overlord_tpu_torch.crypto import bls12381 as oracle

    s0 = int.from_bytes(hashlib.sha256(
        f"chip_smoke:{seed}".encode()).digest(), "big") % oracle.R
    hashes = [sm3_hash(f"chip_smoke:{seed}:block:{g}".encode())
              for g in range(nhash)]
    path = os.path.join(FIXTURE_DIR, f"fixtures_{seed}_{validators}.npz")
    if os.path.exists(path):
        z = np.load(path)
        pks = [bytes(r) for r in z["pks"]]
        sigs = [[bytes(r) for r in z["sigs"][g]] for g in range(nhash)]
        return s0, hashes, pks, sigs
    h_pts = [oracle.hash_to_g1(h) for h in hashes]
    pk = oracle.g2_mul(oracle.G2_GEN, s0)
    sig = [oracle.g1_mul(hp, s0) for hp in h_pts]
    pks, sigs = [], [[] for _ in range(nhash)]
    for _ in range(validators):
        pks.append(oracle.g2_compress(pk))
        for g in range(nhash):
            sigs[g].append(oracle.g1_compress(sig[g]))
        pk = oracle.g2_add(pk, oracle.G2_GEN)
        sig = [oracle.g1_add(s, hp) for s, hp in zip(sig, h_pts)]
    os.makedirs(FIXTURE_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.npz"
    np.savez(tmp, pks=np.frombuffer(b"".join(pks), np.uint8).reshape(
                 validators, 96),
             sigs=np.frombuffer(b"".join(b"".join(s) for s in sigs),
                                np.uint8).reshape(nhash, validators, 48))
    os.replace(tmp, path)
    return s0, hashes, pks, sigs


# -- kernel measurement ----------------------------------------------------------

def time_ms(torch, fn, launches: int) -> float:
    """Mean device time of fn over `launches` calls (CUDA events, after a
    warm-up call)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(launches):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / launches


def plan_ops(spec, plan_name: str, width: int) -> int:
    """32-bit ALU operations per lane of one planned reduction: 2 per
    fold multiply-add, 3 per carried position (shift, mask, add)."""
    from consensus_overlord_tpu_torch.ops import kernels
    ops = 0
    for kind, arg in spec._plan(kernels.plan_bounds(spec, plan_name)):
        if kind == "fold":
            ops += 2 * arg * spec.n
            width = spec.n
        elif kind == "carry":
            width += arg
            ops += 3 * width
        else:
            width += arg
    return ops


def lane_ops(spec) -> dict:
    """Operations per lane of each kernel, counted from its field ops."""
    n = spec.n
    mul = 2 * n * n + plan_ops(spec, "mul", 2 * n - 1)
    add = n + plan_ops(spec, "add2", n)
    sub = 2 * n + plan_ops(spec, "sub", n)
    small = {k: n + plan_ops(spec, k, n)
             for k in ("small2", "small3", "small8", "small12")}
    g1_add = (12 * mul + 12 * add + 5 * sub + small["small3"]
              + 2 * small["small12"])
    g1_dbl = (8 * mul + 2 * add + sub + small["small8"] + small["small12"]
              + small["small3"] + small["small2"])
    return {"fq_mul": mul, "g1_add": g1_add, "g1_dbl": g1_dbl}


def bound(ops_total: float, bytes_total: float):
    t_ops = ops_total / ALU_OPS_PER_S
    t_bytes = bytes_total / HBM_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops > t_bytes else "bytes")


def kernel_checks(torch, launches: dict, seed: int) -> list:
    """Each kernel vs its plain version at B = LANES on the card, with
    times and bounds.  Launch counts come from the main path's run."""
    from consensus_overlord_tpu_torch.crypto import bls12381 as oracle
    from consensus_overlord_tpu_torch.ops import bls12381_groups as dev
    from consensus_overlord_tpu_torch.ops import kernels

    fq = dev.FQ
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randint(0, fq.loose_max + 1, (LANES, fq.n), dtype=torch.int32,
                      device="cuda", generator=gen)
    y = torch.randint(0, fq.loose_max + 1, (LANES, fq.n), dtype=torch.int32,
                      device="cuda", generator=gen)
    x[:64] = fq.loose_max  # every limb at the loose bound
    y[:32] = fq.loose_max
    # G1 operands: a random point and its successors P + i·G (one affine
    # add each), plus identity, doubling (P+P) and inverse (P + −P) lanes.
    start = int.from_bytes(hashlib.sha256(
        f"chip_smoke:{seed}:g1".encode()).digest(), "big") % oracle.R
    pts = [oracle.g1_mul(oracle.G1_GEN, start)]
    while len(pts) < LANES - 4:
        pts.append(oracle.g1_add(pts[-1], oracle.G1_GEN))
    p_aff = pts + [None, None, pts[5], pts[9]]
    q_aff = pts[::-1] + [pts[3], None, pts[5], oracle.g1_neg(pts[9])]
    p = dev.g1_from_oracle(p_aff, "cuda")
    q = dev.g1_from_oracle(q_aff, "cuda")

    ops = lane_ops(fq)
    cases = {
        "fq_mul": (lambda: fq.mul(x, y), lambda: fq.mul_plain(x, y),
                   3 * fq.n * 4),
        "g1_add": (lambda: dev.G1.add(p, q), lambda: dev.G1.add_plain(p, q),
                   9 * fq.n * 4),
        "g1_dbl": (lambda: dev.G1.dbl(p), lambda: dev.G1.dbl_plain(p),
                   6 * fq.n * 4),
    }
    rows = []
    for k in kernels.KERNELS:
        run, plain, lane_bytes = cases[k.name]
        got = run()
        want = plain()
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        if not all(torch.equal(a, b) for a, b in zip(got, want)):
            fail(f"{k.name} differs from its plain version")
        err = max(int((a.long() - b.long()).abs().max()) for a, b in
                  zip(got, want))
        bound_ms, bound_by = bound(ops[k.name] * LANES, lane_bytes * LANES)
        rows.append({
            "name": k.name, "route": k.route, "source": k.source,
            "replaces": k.replaces, "launches": launches[k.name],
            "max_abs_err": err,
            "ms": time_ms(torch, run, 100),
            "plain_ms": time_ms(torch, plain, 10),
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
        })
    if oracle.g1_add(p_aff[0], q_aff[0]) != dev.g1_to_oracle(
            dev.Point(*(c[:1] for c in dev.G1.add(p, q))))[0]:
        fail("g1_add disagrees with the oracle")
    return rows


def trace_round(torch, prov, sigs, h, pks) -> dict:
    """Where a warm single-hash round's time goes: device-busy seconds by
    kernel from a torch.profiler trace of the CUDA activity, beside the
    wall time of the same round untraced (host clock, ending in the
    verdict readback)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    n = len(pks)
    t = time.perf_counter()
    prov.verify_batch(sigs, [h] * n, pks)
    wall = time.perf_counter() - t
    with profile(activities=[ProfilerActivity.CUDA]) as trace:
        if prov.verify_batch(sigs, [h] * n, pks) != [True] * n:
            fail("traced round rejected valid votes")
    kern = [e for e in trace.key_averages() if e.device_type ==
            DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kern) / 1e6
    top = sorted(kern, key=lambda e: -e.self_device_time_total)[:6]
    return {"phase": "single_hash_trace", "votes": n, "wall_s": wall,
            "device_busy_s": busy, "device_idle_share": 1 - busy / wall,
            "kernel_launches": sum(e.count for e in kern),
            "top_kernels": [{"name": e.key[:48], "calls": e.count,
                             "ms": e.self_device_time_total / 1e3}
                            for e in top]}


# -- main path -------------------------------------------------------------------

def drive_main_path(prov, s0, hashes, pks, sigs, sync) -> dict:
    """The main path through the provider's entry points, one JSON line
    per phase; returns each phase's kernel launches."""
    from consensus_overlord_tpu_torch.crypto import bls12381 as oracle
    from consensus_overlord_tpu_torch.crypto.provider import CpuBlsCrypto
    from consensus_overlord_tpu_torch.ops import kernels

    n = len(pks)
    phase_counts = {}

    def phase(name, fn):
        before = kernels.counts()
        t = time.perf_counter()
        out = fn()
        sync()
        secs = time.perf_counter() - t
        after = kernels.counts()
        phase_counts[name] = {k: after[k] - before[k] for k in after}
        return out, secs

    # Pubkeys: device validation of every key into the device cache.
    _, secs = phase("pubkeys", lambda: prov.update_pubkeys(pks))
    if any(prov._pk.index[pk] < 0 for pk in pks):
        fail("a valid pubkey was rejected")
    want_aff = [oracle.g2_decompress(pk) for pk in pks[:256]]
    if prov._pk.aff[:256] != want_aff:
        fail("device-validated pubkeys differ from the oracle's points")
    emit({"phase": "pubkeys", "keys": n, "seconds": secs,
          "cache_rows": int(prov._pk_device()[0].shape[0]),
          "launches": phase_counts["pubkeys"]})

    # Single-hash round at the deployment size, cold then warm.
    h0 = hashes[0]
    for rnd in ("single_hash_cold", "single_hash"):
        got, secs = phase(rnd, lambda: prov.verify_batch(
            sigs[0], [h0] * n, pks))
        if got != [True] * n:
            fail(f"{rnd}: {got.count(False)} valid votes rejected")
        emit({"phase": rnd, "votes": n, "seconds": secs,
              "verifies_per_s": n / secs, "launches": phase_counts[rnd]})

    # Bad lanes, verdict for verdict against the host oracle provider.
    cpu = CpuBlsCrypto(s0)
    outsider = CpuBlsCrypto(s0 + n + 12345)
    torsion = (0, 2)  # the order-3 point of E(Fq)
    sb, vb = list(sigs[0][:64]), list(pks[:64])
    sb[3], sb[4] = sb[4], sb[3]                      # wrong signers
    sb[7] = b"\x00" * 48                             # no compressed flag
    sb[8] = b"short"                                 # wrong length
    sb[11] = bytes([0x9F]) + b"\xff" * 47            # x >= p
    sb[30] = bytes([0xC0]) + b"\x00" * 47            # infinity
    vb[13] = b"\x01" * 96                            # undecodable voter
    vb[17], sb[17] = outsider.pub_key, outsider.sign(h0)  # unknown voter
    sb[21] = oracle.g1_compress(oracle.g1_add(
        oracle.g1_decompress(sb[21]), torsion))      # order-3 component
    hm = [hashes[i % 3] for i in range(96)]
    sm = [sigs[i % 3][100 + i] for i in range(96)]
    vm = list(pks[100:196])
    sm[5] = sigs[1][105]                             # signed another hash
    sm[40] = oracle.g1_compress(oracle.g1_add(
        oracle.g1_decompress(sm[40]), torsion))
    sm[70] = b"\x00" * 48
    vm[80] = b"\x02" * 96

    def bad_batches():
        return (prov.verify_batch(sb, [h0] * 64, vb),
                prov.verify_batch(sm, hm, vm))

    (got_s, got_m), secs = phase("bad_lanes", bad_batches)
    want_s = [cpu.verify_signature(s, h0, v) for s, v in zip(sb, vb)]
    want_m = [cpu.verify_signature(s, h, v) for s, h, v in zip(sm, hm, vm)]
    if got_s != want_s or got_m != want_m:
        fail("bad-lane verdicts differ from CpuBlsCrypto")
    emit({"phase": "bad_lanes", "lanes": [64, 96], "seconds": secs,
          "rejected": [got_s.count(False), got_m.count(False)],
          "launches": phase_counts["bad_lanes"]})

    # Mixed hashes: the k = 3 rung at the deployment size.
    hx = [hashes[i % 3] for i in range(n)]
    sx = [sigs[i % 3][i] for i in range(n)]
    got, secs = phase("mixed", lambda: prov.verify_batch(sx, hx, pks))
    sample = range(0, n, max(1, n // 12))
    if got != [True] * n or any(
            not cpu.verify_signature(sx[i], hx[i], pks[i]) for i in sample):
        fail("mixed-hash verdicts differ from CpuBlsCrypto")
    emit({"phase": "mixed", "votes": n, "hashes": 3, "seconds": secs,
          "verifies_per_s": n / secs, "launches": phase_counts["mixed"]})

    return phase_counts


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=7)
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 2
    try:
        from consensus_overlord_tpu_torch.crypto.cuda_provider import (
            CudaBlsCrypto)
        from consensus_overlord_tpu_torch.ops import kernels
    except ImportError as e:
        print(f"chip_smoke: the port is not importable here: {e}",
              file=sys.stderr)
        return 2
    if any(m == "jax" or m.startswith(("jax.", "consensus_overlord_tpu."))
           or m == "consensus_overlord_tpu" for m in sys.modules):
        fail("the port imported JAX or the JAX package")

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    emit({"phase": "build", "nvcc_seconds": kernels.build_all(),
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "card": smi})

    t0 = time.perf_counter()
    s0, hashes, pks, sigs = make_fixtures(args.seed, LANES)
    emit({"phase": "fixtures", "validators": len(pks), "hashes": len(hashes),
          "seconds": time.perf_counter() - t0})

    prov = CudaBlsCrypto(s0, device="cuda")
    kernels.reset_counts()
    phase_counts = drive_main_path(prov, s0, hashes, pks, sigs,
                                   torch.cuda.synchronize)
    totals = kernels.counts()
    for name, used in (("pubkeys", ["fq_mul"]),
                       ("single_hash", ["fq_mul", "g1_add", "g1_dbl"]),
                       ("bad_lanes", ["fq_mul", "g1_add", "g1_dbl"]),
                       ("mixed", ["fq_mul", "g1_add", "g1_dbl"])):
        idle = [k for k in used if phase_counts[name][k] == 0]
        if idle:
            fail(f"phase {name} never launched {idle}")

    emit(trace_round(torch, prov, sigs[0], hashes[0], pks))
    emit({"kernels": kernel_checks(torch, totals, args.seed)})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
