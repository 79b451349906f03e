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
  mixed        verify_batch over 3 vote hashes (the k=3 rung);
  qc_aggregate aggregate_signatures over all 8192 signatures of one hash,
               byte-equal to CpuBlsCrypto's (g1_validate_sum: fq_mul and
               g1_add), and a 64-lane batch with a malformed signature
               must raise CryptoError;
  qc_verify    verify_aggregated_signature of that aggregate: True, and
               False for a wrong hash and for a swapped voter, each from
               the device pairing (g2_sum_rows, then miller_product and
               final_exp) with no host-oracle pairing.

Every batch pairs on the card (device pairing is on by default there):
the Miller product and the final exponentiation of csrc/pairing.cu.
Kernel launch counts, and their lanes per launch, are read around the
main path, per phase and per QC call (each with the counts set to 0 just
before); a kernel of a path that was never launched fails the run.  Each
of these phases prints the provider's breaker state, device failures and
host pairing fallbacks, and any failure, open breaker or fallback fails
the run.  The build's ptxas report (registers, spills) is printed, and a
spill in any kernel fails the run.  Then

  degraded         the degraded mode at 64 lanes on fresh providers, with
                   faults raised in Python only: the breaker's fault
                   window on verify_batch, aggregate_signatures and
                   verify_aggregated_signature (it must open at its
                   threshold and close on one clean call after the
                   cooldown), a kernel set whose device pairing raises
                   (one counted host pairing), and a readback stalled
                   past a 1-s dispatch deadline (DispatchTimeout; clearing
                   the stall must end the abandoned readback thread);
                   every verdict against CpuBlsCrypto; then a device
                   step failing with a RuntimeError that was not
                   injected must raise to the caller with nothing fed to
                   the breaker;

  pairing_ab       the warm single-hash round with device pairing off,
                   on, on, off (seconds, verifies/s), and the device
                   pairing's own time per flush at 2 and 5 pairs;
  crosscheck       one warm round with CONSENSUS_PAIRING_CROSSCHECK=1:
                   any device/host verdict mismatch fails the run.

Then each kernel is held against its plain version (tolerance 0:
integer arithmetic, torch.equal) and timed with CUDA events beside its
plain version and the least time the card could take for the same work:
the field and G1 kernels at B = 8192 and at their most frequent and
lane-heaviest launch sizes in a warm round (g1_add at every size of the
round); the pairing kernels (phase pairing_kernels) on seeded loose
limbs at 1, 2 and 5 pairs, the Fq12 multiply at 1, 2, 4 and 5 lanes,
the final exponentiation at 1 and 3, each also beside its latency bound
(its multiply depth times one dependent product of the field core on
one warp, timed by the measuring kernel tower_probe_kernel with no
program table), with each program's epochs, steps per warp, registers
and shared memory.  Each phase prints one JSON line; the kernels
line, the card's name and power limit, and the contract line close the
output.  A profiled warm round, last so that the profiler touches no
host-clock phase, reports the device-busy time by kernel.  Any failure exits non-zero.  Exits 2 without a result when no
GPU is visible; fixtures are cached under .smoke_fixtures/.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import re
import subprocess
import sys
import time

#: H100 SXM memory rate (NVIDIA H100 data sheet).
HBM_BYTES_PER_S = 3.35e12
#: int32 rates per clock per SM of compute capability 9.0, times SMS and
#: the card's max SM clock (nvidia-smi clocks.max.sm, read at run time).
#: Integer multiplies and multiply-adds (IMAD, IMUL) issue on the FMA
#: pipe; shifts, logic ops and adds without a multiply (SHF, LOP3, LEA,
#: IADD3) on the separate ALU pipe (Nsight Compute Kernel Profiling
#: Guide, pipelines "fma" and "alu").  Each pipe takes 64 per clock (CUDA
#: C++ Programming Guide, arithmetic instruction throughput table: 32-bit
#: integer multiply-add; add, shift, bitwise), and the SM's four
#: schedulers issue one warp instruction a clock each, 128 thread
#: instructions in all.  One instruction counts as one operation.
SMS = 132
IMAD_PER_CLOCK_PER_SM = 64
ALU_PER_CLOCK_PER_SM = 64
ISSUE_PER_CLOCK_PER_SM = 128
LANES = 8192
#: The pairing kernels (csrc/pairing.cu), and the Fq elements a lane of
#: each reads and writes (a Miller pair: px, py, qx, qy in; Fq12 out).
PAIRING = ("miller_product", "fq12_mul", "final_exp")
PAIRING_LANE_FQ = {"miller_product": 6 + 12, "fq12_mul": 24 + 12,
                   "final_exp": 12 + 12}
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

def time_ms(torch, fn, launches: int, clock_hz: float) -> float:
    """Mean device time of fn over `launches` back-to-back calls (CUDA
    events, after a warm-up call).  A spin kernel holds the card until
    the host has queued every call, so a kernel shorter than its Python
    wrapper is timed on the device, not at the host's issue rate."""
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    fn()
    host_s = time.perf_counter() - t
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(min(2.0, 2 * host_s * launches + 1e-3)
                          * clock_hz))
    start.record()
    for _ in range(launches):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / launches


def plan_ops(spec, plan_name: str) -> dict:
    """int32 instructions per lane of one planned reduction, by pipe: an
    IMAD per fold multiply-add; per carry pass over w positions, a mask
    (LOP3) and a shift-add (LEA.HI) for each but position 0, which takes
    the mask only, and a shift for a new top position."""
    from consensus_overlord_tpu_torch.ops import kernels
    imad = alu = 0
    for kind, arg, w_in, _ in kernels.plan_steps(spec, plan_name):
        if kind == "fold":
            imad += arg * spec.n
        elif kind == "carry":
            alu += 2 * w_in - 1 + arg
    return {"imad": imad, "alu": alu, "either": 0}


def _ops(*terms) -> dict:
    """The sum of (count, ops) terms, pipe by pipe."""
    return {k: sum(c * o[k] for c, o in terms)
            for k in ("imad", "alu", "either")}


def field_ops(spec) -> dict:
    """int32 instructions per lane of each base-field op, by pipe.  A
    limb-wise add, a subtraction a + (pad − b) (one IADD3), a negation
    pad − x or a multiple by a small constant (IMAD, LEA or SHF) can
    issue on either pipe ("either")."""
    n = spec.n
    limbwise = {"imad": 0, "alu": 0, "either": n}
    f = {name: _ops((1, limbwise), (1, plan_ops(spec, name)))
         for name in ("add2", "sub", "neg", "small2", "small3", "small8",
                      "small12")}
    f["mul"] = _ops((1, {"imad": n * n, "alu": 0, "either": 0}),
                    (1, plan_ops(spec, "mul")))
    f["add"] = f.pop("add2")
    return f


def lane_ops(spec) -> dict:
    """int32 instructions per lane of each kernel, by pipe, counted from
    its field ops; the pairing kernels' from their programs' op counts
    (ops/tower_program.py)."""
    from consensus_overlord_tpu_torch.ops import tower_program
    f = field_ops(spec)
    g1_add = _ops((12, f["mul"]), (12, f["add"]), (5, f["sub"]),
                  (1, f["small3"]), (2, f["small12"]))
    g1_dbl = _ops((8, f["mul"]), (2, f["add"]), (1, f["sub"]),
                  (1, f["small8"]), (1, f["small12"]), (1, f["small3"]),
                  (1, f["small2"]))
    out = {"fq_mul": f["mul"], "g1_add": g1_add, "g1_dbl": g1_dbl}
    for name in PAIRING:
        by_kind = tower_program.program(name, spec).stats["by_kind"]
        out[name] = _ops(*((c, f[k]) for k, c in by_kind.items()))
    return out


def bound(ops: dict, lanes: int, bytes_total: float, clock_hz: float):
    """The least time of `lanes` lanes of work with `ops` per lane: the
    larger of the bytes over the memory rate and the operations over the
    card's int32 rates (each pipe alone, and both through issue)."""
    per_s = SMS * clock_hz
    t_ops = lanes * max(ops["imad"] / (IMAD_PER_CLOCK_PER_SM * per_s),
                        ops["alu"] / (ALU_PER_CLOCK_PER_SM * per_s),
                        sum(ops.values()) / (ISSUE_PER_CLOCK_PER_SM * per_s))
    t_bytes = bytes_total / HBM_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops > t_bytes else "bytes")


def kernel_operands(torch, seed: int):
    """Fq operands (random loose limbs, rows at the loose bound) and G1
    operands (a random point and its successors P + i·G, one affine add
    each, plus identity, doubling (P+P) and inverse (P + −P) lanes), all
    LANES wide on the card."""
    from consensus_overlord_tpu_torch.crypto import bls12381 as oracle
    from consensus_overlord_tpu_torch.ops import bls12381_groups as dev

    fq = dev.FQ
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randint(0, fq.loose_max + 1, (LANES, fq.n), dtype=torch.int32,
                      device="cuda", generator=gen)
    y = torch.randint(0, fq.loose_max + 1, (LANES, fq.n), dtype=torch.int32,
                      device="cuda", generator=gen)
    x[:64] = fq.loose_max  # every limb at the loose bound
    y[:32] = fq.loose_max
    start = int.from_bytes(hashlib.sha256(
        f"chip_smoke:{seed}:g1".encode()).digest(), "big") % oracle.R
    pts = [oracle.g1_mul(oracle.G1_GEN, start)]
    while len(pts) < LANES - 4:
        pts.append(oracle.g1_add(pts[-1], oracle.G1_GEN))
    p_aff = pts + [None, None, pts[5], pts[9]]
    q_aff = pts[::-1] + [pts[3], None, pts[5], oracle.g1_neg(pts[9])]
    return (x, y, dev.g1_from_oracle(p_aff, "cuda"),
            dev.g1_from_oracle(q_aff, "cuda"), p_aff, q_aff)


def kernel_checks(torch, launches: dict, operands, card: dict,
                  frequent: dict):
    """Each kernel vs its plain version on the card (tolerance 0,
    torch.equal), timed beside its bound: at B = LANES for the kernels
    line, and at the lane counts `frequent` names for each kernel
    (operands tiled to that size).  Launch counts come from the main
    path's run."""
    from consensus_overlord_tpu_torch.crypto import bls12381 as oracle
    from consensus_overlord_tpu_torch.ops import bls12381_groups as dev
    from consensus_overlord_tpu_torch.ops import kernels

    fq = dev.FQ
    x, y, p, q, p_aff, q_aff = operands
    ops = lane_ops(fq)

    def measure(name: str, lanes: int) -> dict:
        idx = torch.arange(lanes, device="cuda") % LANES
        xs, ys = x[idx], y[idx]
        ps = dev.Point(*(c[idx] for c in p))
        qs = dev.Point(*(c[idx] for c in q))
        run, plain, lane_bytes = {
            "fq_mul": (lambda: fq.mul(xs, ys), lambda: fq.mul_plain(xs, ys),
                       3 * fq.n * 4),
            "g1_add": (lambda: dev.G1.add(ps, qs),
                       lambda: dev.G1.add_plain(ps, qs), 9 * fq.n * 4),
            "g1_dbl": (lambda: dev.G1.dbl(ps), lambda: dev.G1.dbl_plain(ps),
                       6 * fq.n * 4),
        }[name]
        got = run()
        want = plain()
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        if not all(torch.equal(a, b) for a, b in zip(got, want)):
            fail(f"{name} differs from its plain version at B = {lanes}")
        err = max(int((a.long() - b.long()).abs().max()) for a, b in
                  zip(got, want))
        bound_ms, bound_by = bound(ops[name], lanes, lane_bytes * lanes,
                                   card["clock_hz"])
        return {"max_abs_err": err,
                "ms": time_ms(torch, run, 100, card["clock_hz"]),
                "plain_ms": time_ms(torch, plain, 10, card["clock_hz"]),
                "bound_ms": bound_ms, "bound_by": bound_by}

    field = [k for k in kernels.KERNELS if k.name not in PAIRING]
    rows = [{"name": k.name, "route": k.route, "source": k.source,
             "replaces": k.replaces, "launches": launches[k.name],
             **measure(k.name, LANES), "library_ms": None}
            for k in field]
    sized = [{"name": k.name, "lanes": lanes, **measure(k.name, lanes)}
             for k in field for lanes in frequent[k.name]]
    if oracle.g1_add(p_aff[0], q_aff[0]) != dev.g1_to_oracle(
            dev.Point(*(c[:1] for c in dev.G1.add(p, q))))[0]:
        fail("g1_add disagrees with the oracle")
    return rows, sized


def pairing_checks(torch, launches: dict, per_flush: dict, card: dict,
                   seed: int, ptxas: dict):
    """Each pairing kernel vs its plain version on the card (torch.equal)
    on seeded loose limbs (a row of each operand at the loose bound), at
    1, 2 and 5 pairs, 1, 2, 4 and 5 Fq12 products and 1 and 3 final
    exponentiations; timed with CUDA events beside the plain version, the
    throughput bound and the latency bound.  Returns the kernels-line rows
    (at the main path's single-hash sizes: 2 pairs, one product, one
    exponentiation) and the phase line, with each kernel's registers
    and spills."""
    from consensus_overlord_tpu_torch.ops import kernels
    from consensus_overlord_tpu_torch.ops import pairing as pr
    from consensus_overlord_tpu_torch.ops import tower_program

    fq = pr.FQ
    gen = torch.Generator(device="cuda").manual_seed(seed + 4)

    def loose(*shape):
        t = torch.randint(0, fq.loose_max + 1, shape + (fq.n,),
                          dtype=torch.int32, device="cuda", generator=gen)
        t.view(-1, fq.n)[0] = fq.loose_max
        return t

    # The latency bound: one dependent product of the field core on one
    # warp (the measuring kernel, no program table; the difference of a
    # 2k- and a k-product chain, so the launch drops out) times a
    # program's multiply depth.
    x, y = loose(1), loose(1)
    k = tower_program.CHAIN
    want = x
    for _ in range(k):
        want = fq.mul_plain(want, y)
    if not torch.equal(kernels.tower_probe(fq, x, y, "mul", k, 32), want):
        fail("the field-core probe differs from the plain products")
    product_ms = (time_ms(torch, lambda: kernels.tower_probe(
        fq, x, y, "mul", 2 * k, 32), 20, card["clock_hz"]) - time_ms(
        torch, lambda: kernels.tower_probe(fq, x, y, "mul", k, 32), 20,
        card["clock_hz"])) / k
    # The earlier yardstick, kept beside it: one product step of the
    # interpreter itself on the fq_inv chain.
    chain = loose(1, 2, 3, 2)
    inv = kernels.final_exp(fq, chain, program="fq_inv")
    if not torch.equal(inv.view(12, fq.n)[0], fq.inv(chain.view(12, fq.n)[0])):
        fail("the fq_inv chain differs from the plain inversion")
    inv_depth = tower_program.program("fq_inv", fq).stats["mul_depth"]
    inv_step_ms = time_ms(torch, lambda: kernels.final_exp(
        fq, chain, program="fq_inv"), 20, card["clock_hz"]) / inv_depth
    ops = lane_ops(fq)

    def cases(name, lanes):
        if name == "miller_product":
            px, py, qx, qy = loose(lanes), loose(lanes), loose(lanes, 2), \
                loose(lanes, 2)
            skip = torch.arange(lanes, device="cuda") % 4 == 1

            def plain():
                f = pr.miller_loop(px, py, qx, qy)
                return pr.FQ12.where(skip, pr.FQ12.one_like(f), f)
            return (lambda: kernels.miller_product(fq, px, py, qx, qy, skip),
                    plain)
        if name == "fq12_mul":
            x, y = loose(lanes, 2, 3, 2), loose(lanes, 2, 3, 2)
            return lambda: pr.fq12_mul(x, y), lambda: pr.FQ12.mul(x, y)
        f = loose(lanes, 2, 3, 2)
        return (lambda: pr.final_exponentiation(f),
                lambda: pr.FQ12.final_exponentiation(f))

    sizes = {"miller_product": (1, 2, 5), "fq12_mul": (1, 2, 4, 5),
             "final_exp": (1, 3)}
    path_size = {"miller_product": 2, "fq12_mul": 1, "final_exp": 1}
    measured, rows = [], []
    for name in PAIRING:
        prog = tower_program.program(name, fq).stats
        for lanes in sizes[name]:
            run, plain = cases(name, lanes)
            got, want = run(), plain()
            if not torch.equal(got, want):
                fail(f"{name} differs from its plain version at {lanes}")
            bound_ms, bound_by = bound(
                ops[name], lanes, 4 * fq.n * PAIRING_LANE_FQ[name] * lanes,
                card["clock_hz"])
            row = {"name": name, "lanes": lanes,
                   "max_abs_err": int((got.long() - want.long()).abs().max()),
                   "ms": time_ms(torch, run, 20, card["clock_hz"]),
                   "plain_ms": time_ms(torch, plain, 2, card["clock_hz"]),
                   "bound_ms": bound_ms, "bound_by": bound_by,
                   "latency_bound_ms": prog["mul_depth"] * product_ms}
            row["binding_bound"] = ("latency" if row["latency_bound_ms"] >
                                    bound_ms else bound_by)
            measured.append(row)
            if lanes == path_size[name]:
                k = {kk.name: kk for kk in kernels.KERNELS}[name]
                rows.append({"name": name, "route": k.route,
                             "source": k.source, "replaces": k.replaces,
                             "launches": launches[name],
                             **{key: row[key] for key in (
                                 "max_abs_err", "ms", "plain_ms",
                                 "bound_ms", "bound_by")},
                             "library_ms": None})
    programs = {}
    for name in PAIRING:
        st = dict(tower_program.program(name, fq).stats)
        st["smem_bytes"] = kernels.tower_smem_bytes(st["registers"])
        st["latency_bound_ms"] = st["mul_depth"] * product_ms
        programs[name] = st
    phase = {"phase": "pairing_kernels", "product_ms": product_ms,
             "fq_inv_step_ms": inv_step_ms, "programs": programs,
             "ptxas": {name: ptxas[name + "_kernel"] for name in PAIRING},
             "launches_per_flush": per_flush, "kernels": measured}
    return rows, phase


def pairing_ab(torch, prov, s0, sigs, h, pks, sync, card) -> dict:
    """The warm single-hash round with device pairing off, on, on, off
    (host clock, ending in the verdict readback), and the device
    pairing's own time per flush at P = 2 and 5 pairs on real points:
    device time (CUDA events over back-to-back flushes) and host clock
    (a flush ending in its verdict readback), beside the host oracle's
    pairing of the same pairs (the native backend)."""
    from consensus_overlord_tpu_torch.crypto import bls12381 as oracle
    from consensus_overlord_tpu_torch.crypto.cuda_provider import (
        CudaBlsCrypto)
    from consensus_overlord_tpu_torch.ops import pairing as pr

    n = len(pks)
    off = CudaBlsCrypto(s0, device_pairing=False)
    off.load_pubkey_cache(prov._pk)
    off.verify_batch(sigs, [h] * n, pks)  # warm: the cache's upload
    rounds = []
    for on in (False, True, True, False):
        p = prov if on else off
        sync()
        t = time.perf_counter()
        got = p.verify_batch(sigs, [h] * n, pks)
        sync()
        secs = time.perf_counter() - t
        if got != [True] * n:
            fail(f"pairing_ab: device_pairing={on} rejected valid votes")
        rounds.append({"device_pairing": on, "seconds": secs,
                       "verifies_per_s": n / secs})
    neg_g2 = (oracle.G2_GEN[0], oracle.fq2_neg(oracle.G2_GEN[1]))
    h_pt = oracle.hash_to_g1(h)
    sig0 = oracle.g1_decompress(sigs[0])
    pk0 = oracle.g2_decompress(pks[0])
    flush = {}
    for pairs in (2, 5):
        g1 = [sig0, h_pt, sig0, h_pt, None][:pairs]
        g2 = [neg_g2, pk0, neg_g2, pk0, pk0][:pairs]
        px, py, pinf = (torch.as_tensor(a, device="cuda")
                        for a in pr.g1_affine_from_oracle(g1))
        qx, qy, qinf = (torch.as_tensor(a, device="cuda")
                        for a in pr.g2_affine_from_oracle(g2))
        mask = torch.ones(pairs, dtype=torch.bool, device="cuda")

        def run():
            return pr.multi_pairing_is_one_staged(px, py, pinf, qx, qy,
                                                  qinf, mask)
        if not bool(run()):
            fail(f"device pairing rejected a true relation at {pairs} pairs")
        t = time.perf_counter()
        for _ in range(10):
            bool(run())
        host_ms = (time.perf_counter() - t) * 100
        t = time.perf_counter()
        for _ in range(10):
            oracle.multi_pairing_is_one([(p, q) for p, q in zip(g1, g2)])
        flush[pairs] = {"device_ms": time_ms(torch, run, 20,
                                            card["clock_hz"]),
                        "host_ms": host_ms,
                        "host_oracle_ms": (time.perf_counter() - t) * 100}
    return {"phase": "pairing_ab", "votes": n, "rounds": rounds,
            "flush": flush, "pairing_off": provider_health(off, "pairing_ab"),
            **provider_health(prov, "pairing_ab")}


def crosscheck(prov, s0, sigs, h, pks) -> dict:
    """One warm single-hash round and one failing 64-lane batch with
    CONSENSUS_PAIRING_CROSSCHECK=1: every device verdict is paired on the
    host too; a mismatch (the provider logs and counts each) fails the
    run."""
    from consensus_overlord_tpu_torch.crypto import cuda_provider
    from consensus_overlord_tpu_torch.crypto.provider import CpuBlsCrypto

    os.environ["CONSENSUS_PAIRING_CROSSCHECK"] = "1"
    try:
        xp = cuda_provider.CudaBlsCrypto(s0)
    finally:
        del os.environ["CONSENSUS_PAIRING_CROSSCHECK"]
    xp.load_pubkey_cache(prov._pk)
    n = len(pks)
    t = time.perf_counter()
    good = xp.verify_batch(sigs, [h] * n, pks)
    secs = time.perf_counter() - t
    sb = list(sigs[:64])
    sb[3], sb[4] = sb[4], sb[3]
    bad = xp.verify_batch(sb, [h] * 64, pks[:64])
    cpu = CpuBlsCrypto(s0)
    if good != [True] * n or bad != [cpu.verify_signature(s, h, v)
                                     for s, v in zip(sb, pks[:64])]:
        fail("crosscheck: wrong verdicts")
    if xp.pairing_mismatches:  # each one logged as an error
        fail(f"crosscheck: {xp.pairing_mismatches} device/host mismatches")
    return {"phase": "crosscheck", "votes": n, "seconds": secs,
            "mismatches": xp.pairing_mismatches,
            **provider_health(xp, "crosscheck")}


_PTXAS_NAME = re.compile(r"(fq_mul_kernel|g1_dbl_kernel|g1_add_kernel|"
                         r"miller_product_kernel|fq12_mul_kernel|"
                         r"final_exp_kernel)")


def ptxas_report(kernels) -> dict:
    """Registers, stack and spills of every kernel entry, from ptxas's
    -v report of the build of each library the checkout has."""
    out, cur = {}, None
    for lib in kernels._LIBS:
        for line in kernels.build_log(lib).splitlines():
            m = re.search(r"Function properties for (\S+)", line)
            if m:
                k = _PTXAS_NAME.search(m.group(1))
                cur = k.group(1) if k else None
                if cur:
                    out[cur] = {}
                continue
            m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill "
                          r"stores, (\d+) bytes spill loads", line)
            if m and cur:
                out[cur].update(stack=int(m.group(1)),
                                spill_stores=int(m.group(2)),
                                spill_loads=int(m.group(3)))
            m = re.search(r"Used (\d+) registers", line)
            if m and cur:
                out[cur]["registers"] = int(m.group(1))
                cur = None
    return out


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
    ours = {name: [(e.count, e.self_device_time_total / 1e3)
                   for e in kern if name + "_kernel" in e.key]
            for name in ("fq_mul", "g1_add", "g1_dbl") + PAIRING}
    return {"phase": "single_hash_trace", "votes": n, "wall_s": wall,
            "device_busy_s": busy, "device_idle_share": 1 - busy / wall,
            "kernel_launches": sum(e.count for e in kern),
            "top_kernels": [{"name": e.key[:48], "calls": e.count,
                             "ms": e.self_device_time_total / 1e3}
                            for e in top],
            "port_kernels": {name: {"calls": sum(c for c, _ in v),
                                    "ms": sum(m for _, m in v)}
                             for name, v in ours.items()}}


# -- main path -------------------------------------------------------------------

def provider_health(prov, phase: str) -> dict:
    """A provider's breaker and fallback counters for a phase line; a
    device failure, a breaker that is not closed or a host pairing in a
    main-path or QC phase fails the run."""
    st = prov.breaker.status()
    doc = {"breaker": st["state"], "device_failures": st["total_failures"],
           "pairing_host_fallbacks": prov.pairing_host_fallbacks}
    if (st["state"] != "closed" or st["total_failures"]
            or prov.pairing_host_fallbacks):
        fail(f"{phase}: the device path degraded "
             f"({st['last_failure_reason']}): {doc}")
    return doc


def _launches_of(kernels, fn):
    """fn() with every launch count set to 0 just before and read just
    after: (its result, launches by kernel, launches by lane bucket)."""
    kernels.reset_counts()
    out = fn()
    return out, kernels.counts(), {
        k: kernels.size_buckets(v) for k, v in kernels.sizes().items() if v}


def drive_qc(torch, prov, s0, h, pks, sigs, sync):
    """The QC paths through the provider's entry points at the deployment
    size, one JSON line each; returns each phase's launches.

      qc_aggregate  aggregate_signatures over every validator's signature
                    on one hash, byte-equal to CpuBlsCrypto's; a 64-lane
                    batch with one malformed signature raises CryptoError;
      qc_verify     verify_aggregated_signature of that aggregate: True,
                    False for a wrong hash, False with one voter swapped
                    for another validator's key, each against the host
                    oracle's check; every verdict from the device pairing
                    (no host-oracle pairing in the provider).

    Each call is timed on the host clock beside the host oracle's own
    call; the split times each device step alone, the inversion that ends
    it, and the device pairing's time per call (CUDA events around its
    launches)."""
    from consensus_overlord_tpu_torch.crypto import bls12381 as oracle
    from consensus_overlord_tpu_torch.crypto import cuda_provider as cp
    from consensus_overlord_tpu_torch.crypto.provider import (
        CpuBlsCrypto, CryptoError)
    from consensus_overlord_tpu_torch.ops import bls12381_groups as dev
    from consensus_overlord_tpu_torch.ops import kernels

    n = len(pks)
    cpu = CpuBlsCrypto(s0)

    def timed(fn):
        sync()
        t = time.perf_counter()
        out = fn()
        sync()
        return out, time.perf_counter() - t

    def step_seconds(step, *args):
        """One device step alone, ending in a synchronise (warm: the
        provider's call ran it first)."""
        return timed(lambda: step(*args))[1]

    one = torch.ones((1, dev.FQ.n), dtype=torch.int32, device=prov.device)
    inversion_s = step_seconds(dev.FQ.inv, one)

    # qc_aggregate.
    (agg, secs), launches, lanes = _launches_of(
        kernels, lambda: timed(lambda: prov.aggregate_signatures(sigs, pks)))
    t = time.perf_counter()
    want = cpu.aggregate_signatures(sigs, pks)
    oracle_s = time.perf_counter() - t
    if agg != want:
        fail("qc_aggregate: the aggregate differs from CpuBlsCrypto's")
    idle = [k for k in ("fq_mul", "g1_add") if launches[k] == 0]
    if idle:
        fail(f"qc_aggregate never launched {idle}")
    bad = list(sigs[:64])
    bad[9] = b"\x00" * 48  # no compressed flag

    def raises(fn) -> float:
        t = time.perf_counter()
        try:
            fn()
        except CryptoError:
            return time.perf_counter() - t
        fail("qc_aggregate: a malformed signature did not raise CryptoError")

    bad_s = raises(lambda: prov.aggregate_signatures(bad, pks[:64]))
    bad_oracle_s = raises(lambda: cpu.aggregate_signatures(bad, pks[:64]))
    parsed = dev.parse_g1_compressed(list(sigs))
    ins = [torch.as_tensor(a, device=prov.device) for a in (
        parsed.x, parsed.sign, parsed.infinity, parsed.wellformed)]
    emit({"phase": "qc_aggregate", "signatures": n, "seconds": secs,
          "oracle_seconds": oracle_s, "launches": launches,
          "launch_lanes": lanes,
          "split": {"g1_validate_sum_s": step_seconds(
                        cp.g1_validate_sum, *ins),
                    "inversion_s": inversion_s},
          "bad_batch": {"lanes": 64, "raised": "CryptoError",
                        "seconds": bad_s, "oracle_seconds": bad_oracle_s},
          **provider_health(prov, "qc_aggregate")})
    qc = {"qc_aggregate": launches}

    # qc_verify: every device pairing timed by CUDA events; the host
    # oracle's pairings counted (there must be none).
    events, host_pairings = [], []

    class TimedPairing(cp._SingleChipKernels):
        @staticmethod
        def multi_pairing(*a):
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            out = cp._SingleChipKernels.multi_pairing(*a)
            stop.record()
            events.append((start, stop))
            return out

    real_pairing = cp.oracle.multi_pairing_is_one

    def counted(pairs):
        host_pairings.append(len(pairs))
        return real_pairing(pairs)

    swapped = list(pks)
    swapped[5] = pks[6]
    cases = [("valid", h, pks, True),
             ("wrong_hash", hashlib.sha256(h).digest(), pks, False),
             ("swapped_voter", h, swapped, False)]
    # The host oracle's QC check first, without its per-key subgroup
    # check (every key is a multiple of G2 by construction; with it the
    # check takes minutes at this size).
    oracle_checks = []
    for name, hh, voters, want_v in cases:
        t = time.perf_counter()
        want_o = oracle.aggregate_verify_same_message(
            voters, hh, agg, check_subgroup=False)
        oracle_checks.append((want_o, time.perf_counter() - t))
    prov._kernels, cp.oracle.multi_pairing_is_one = TimedPairing, counted
    try:
        calls = []
        for (name, hh, voters, want_v), (want_o, oracle_s) in zip(
                cases, oracle_checks):
            (got, secs), launches, lanes = _launches_of(
                kernels, lambda: timed(
                    lambda: prov.verify_aggregated_signature(agg, hh, voters)))
            if got is not want_v or want_o is not want_v:
                fail(f"qc_verify {name}: {got} (oracle {want_o}), "
                     f"want {want_v}")
            calls.append({"case": name, "verdict": got, "seconds": secs,
                          "oracle_seconds": oracle_s, "launches": launches,
                          "launch_lanes": lanes})
    finally:
        prov._kernels = cp._SingleChipKernels
        cp.oracle.multi_pairing_is_one = real_pairing
    torch.cuda.synchronize()
    pairing_ms = [a.elapsed_time(b) for a, b in events]
    if host_pairings or len(pairing_ms) != len(cases):
        fail(f"qc_verify: {len(host_pairings)} host pairings, "
             f"{len(pairing_ms)} device pairings in {len(cases)} calls")
    for c in calls:
        idle = [k for k in ("fq_mul", "miller_product", "final_exp")
                if c["launches"][k] == 0]
        if idle:
            fail(f"qc_verify {c['case']} never launched {idle}")
    rows = torch.tensor([prov._pk.index[v] for v in pks], device=prov.device)
    mask = torch.ones(n, dtype=torch.bool, device=prov.device)
    emit({"phase": "qc_verify", "voters": n, "calls": calls,
          "host_pairings": len(host_pairings),
          "split": {"g2_sum_rows_s": step_seconds(
                        cp.g2_sum_rows, rows, mask, *prov._pk_device()),
                    "inversion_s": inversion_s,
                    "device_pairing_ms": pairing_ms},
          **provider_health(prov, "qc_verify")})
    qc["qc_verify"] = {k: sum(c["launches"][k] for c in calls)
                       for k in calls[0]["launches"]}
    return qc


def degraded(prov, s0, h, pks, sigs) -> dict:
    """Degraded mode at 64 lanes on fresh providers, every verdict against
    CpuBlsCrypto: (1) the breaker's fault window fails verify_batch,
    aggregate_signatures and verify_aggregated_signature, the third
    failure opens the breaker, and after the window is cleared and the
    cooldown has passed one clean device call closes it; (2) a kernel set
    whose device pairing raises pairs on the host, counted once; (3) a
    stall of the readback past dispatch_deadline_s = 1 s ends in a
    DispatchTimeout, and clearing the stall ends the abandoned readback
    thread; (4) a device step that fails with anything but an injected
    fault raises to the caller, with nothing fed to the breaker.  Faults
    are raised in Python only."""
    import threading

    from consensus_overlord_tpu_torch.crypto import cuda_provider as cp
    from consensus_overlord_tpu_torch.crypto.breaker import (
        CircuitBreaker, InjectedDeviceFault)
    from consensus_overlord_tpu_torch.crypto.provider import CpuBlsCrypto

    n = 64
    cpu = CpuBlsCrypto(s0)
    good, voters = list(sigs[:n]), list(pks[:n])
    bad = list(good)
    bad[3], bad[4] = bad[4], bad[3]  # wrong signers
    want = cpu.verify_batch(bad, [h] * n, voters)
    agg = cpu.aggregate_signatures(good, voters)
    steps = []

    p = cp.CudaBlsCrypto(s0, breaker=CircuitBreaker(failure_threshold=3,
                                                     cooldown_s=0.5))
    p.update_pubkeys(voters)
    p.breaker.inject_faults(60.0)
    got = (p.verify_batch(bad, [h] * n, voters),
           p.aggregate_signatures(good, voters),
           p.verify_aggregated_signature(agg, h, voters))
    if got != (want, agg, True):
        fail("degraded: verdicts under injected faults differ from "
             "CpuBlsCrypto")
    opened = p.degraded_status()
    if opened["state"] != "open" or opened["total_failures"] != 3:
        fail(f"degraded: the breaker did not open at 3 failures: {opened}")
    p.breaker.clear_injected_faults()
    time.sleep(0.6)
    if p.verify_batch(bad, [h] * n, voters) != want:
        fail("degraded: the probe's verdicts differ from CpuBlsCrypto")
    if p.breaker.state != "closed":
        fail("degraded: a clean device call did not close the breaker")
    steps.append({"step": "inject_faults", "at_open": opened,
                  "after_probe": p.degraded_status()})

    class FailingPairing(cp._SingleChipKernels):
        fault = InjectedDeviceFault

        @classmethod
        def multi_pairing(cls, *_a):
            raise cls.fault("pairing device fault")

    p = cp.CudaBlsCrypto(s0)
    p.load_pubkey_cache(prov._pk)
    p._kernels = FailingPairing
    if p.verify_batch(bad, [h] * n, voters) != want:
        fail("degraded: host-paired verdicts differ from CpuBlsCrypto")
    if p.pairing_host_fallbacks != 1:
        fail(f"degraded: {p.pairing_host_fallbacks} pairing fallbacks, "
             "want 1")
    steps.append({"step": "failing_pairing", "status": p.degraded_status()})

    p = cp.CudaBlsCrypto(s0, dispatch_deadline_s=1.0)
    p.load_pubkey_cache(prov._pk)
    before = set(threading.enumerate())
    p.inject_dcn_stall(30.0)
    t = time.perf_counter()
    got = p.verify_batch(bad, [h] * n, voters)
    secs = time.perf_counter() - t
    p.inject_dcn_stall(0.0)
    abandoned = [w for w in threading.enumerate()
                 if w not in before and w.name.startswith("dispatch-watchdog")]
    for w in abandoned:
        w.join(5.0)
    alive = sum(w.is_alive() for w in abandoned)
    if len(abandoned) != 1 or alive:
        fail(f"degraded: want the stall's one abandoned readback thread "
             f"ended by the clear; found {len(abandoned)}, {alive} alive")
    st = p.degraded_status()
    if got != want or "DispatchTimeout" not in st["last_failure_reason"]:
        fail(f"degraded: the stalled batch gave {got == want} verdicts, "
             f"reason {st['last_failure_reason']!r}")
    steps.append({"step": "dcn_stall", "seconds": secs,
                  "deadline_s": p._deadline_for(cp._pad_to(n)),
                  "abandoned_threads_ended": len(abandoned), "status": st})

    class RealFault(FailingPairing):
        fault = RuntimeError

    p = cp.CudaBlsCrypto(s0)
    p.load_pubkey_cache(prov._pk)
    p._kernels = RealFault
    try:
        p.verify_batch(bad, [h] * n, voters)
        fail("degraded: a device fault that was not injected was "
             "swallowed")
    except RuntimeError as e:
        raised = type(e).__name__
    st = p.degraded_status()
    if st["total_failures"] or p.pairing_host_fallbacks:
        fail(f"degraded: a device fault fed the breaker: {st}")
    steps.append({"step": "real_fault_propagates", "raised": raised,
                  "status": st})
    return {"phase": "degraded", "lanes": n, "steps": steps}



def drive_main_path(prov, s0, hashes, pks, sigs, sync):
    """The main path through the provider's entry points, one JSON line
    per phase; returns each phase's kernel launches, and its launches by
    lane count."""
    from consensus_overlord_tpu_torch.crypto import bls12381 as oracle
    from consensus_overlord_tpu_torch.crypto.provider import CpuBlsCrypto
    from consensus_overlord_tpu_torch.ops import kernels

    n = len(pks)
    phase_counts, phase_sizes = {}, {}

    def phase(name, fn):
        before, sizes0 = kernels.counts(), kernels.sizes()
        t = time.perf_counter()
        out = fn()
        sync()
        secs = time.perf_counter() - t
        after, sizes1 = kernels.counts(), kernels.sizes()
        phase_counts[name] = {k: after[k] - before[k] for k in after}
        phase_sizes[name] = {k: {b: c - sizes0[k].get(b, 0)
                                 for b, c in sizes1[k].items()
                                 if c > sizes0[k].get(b, 0)}
                             for k in sizes1}
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
          "launches": phase_counts["pubkeys"],
          **provider_health(prov, "pubkeys")})

    # Single-hash round at the deployment size, cold then warm.
    h0 = hashes[0]
    for rnd in ("single_hash_cold", "single_hash"):
        got, secs = phase(rnd, lambda: prov.verify_batch(
            sigs[0], [h0] * n, pks))
        if got != [True] * n:
            fail(f"{rnd}: {got.count(False)} valid votes rejected")
        emit({"phase": rnd, "votes": n, "seconds": secs,
              "verifies_per_s": n / secs, "launches": phase_counts[rnd],
              "launch_lanes": {k: kernels.size_buckets(v) for k, v in
                               phase_sizes[rnd].items()},
              **provider_health(prov, rnd)})

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
          "launches": phase_counts["bad_lanes"],
          **provider_health(prov, "bad_lanes")})

    # Mixed hashes: the k = 3 rung at the deployment size.
    hx = [hashes[i % 3] for i in range(n)]
    sx = [sigs[i % 3][i] for i in range(n)]
    got, secs = phase("mixed", lambda: prov.verify_batch(sx, hx, pks))
    sample = range(0, n, max(1, n // 12))
    if got != [True] * n or any(
            not cpu.verify_signature(sx[i], hx[i], pks[i]) for i in sample):
        fail("mixed-hash verdicts differ from CpuBlsCrypto")
    emit({"phase": "mixed", "votes": n, "hashes": 3, "seconds": secs,
          "verifies_per_s": n / secs, "launches": phase_counts["mixed"],
          **provider_health(prov, "mixed")})

    return phase_counts, phase_sizes


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
        from consensus_overlord_tpu_torch.ops.field import BLS12_381_FQ
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
    clock_mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0])
    card = {"clock_hz": clock_mhz * 1e6}
    emit({"phase": "build", "nvcc_seconds": kernels.build_all(),
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "card": smi, "max_sm_clock_mhz": clock_mhz,
          "int32_per_s": {k: SMS * r * card["clock_hz"] for k, r in (
              ("imad", IMAD_PER_CLOCK_PER_SM), ("alu", ALU_PER_CLOCK_PER_SM),
              ("issue", ISSUE_PER_CLOCK_PER_SM))},
          "lane_ops": lane_ops(BLS12_381_FQ)})
    ptxas = ptxas_report(kernels)
    emit({"phase": "ptxas", "kernels": ptxas})
    for name in ("fq_mul", "g1_add", "g1_dbl") + PAIRING:
        name += "_kernel"
        if name not in ptxas or ptxas[name].get("spill_stores", 1):
            fail(f"{name}: spills or missing from the ptxas report")

    t0 = time.perf_counter()
    s0, hashes, pks, sigs = make_fixtures(args.seed, LANES)
    emit({"phase": "fixtures", "validators": len(pks), "hashes": len(hashes),
          "seconds": time.perf_counter() - t0})

    prov = CudaBlsCrypto(s0, device="cuda")
    kernels.reset_counts()
    phase_counts, phase_sizes = drive_main_path(prov, s0, hashes, pks, sigs,
                                                torch.cuda.synchronize)
    totals = kernels.counts()
    every = [k.name for k in kernels.KERNELS]
    for name, used in (("pubkeys", ["fq_mul"]), ("single_hash", every),
                       ("bad_lanes", every), ("mixed", every)):
        idle = [k for k in used if phase_counts[name][k] == 0]
        if idle:
            fail(f"phase {name} never launched {idle}")
    per_flush = {k: {"single_hash": phase_counts["single_hash"][k],
                     "mixed": phase_counts["mixed"][k]} for k in PAIRING}
    qc = drive_qc(torch, prov, s0, hashes[0], pks, sigs[0],
                  torch.cuda.synchronize)
    emit(degraded(prov, s0, hashes[0], pks, sigs[0]))

    # Host-clock phases first: the profiled round runs last.
    emit(pairing_ab(torch, prov, s0, sigs[0], hashes[0], pks,
                    torch.cuda.synchronize, card))
    emit(crosscheck(prov, s0, sigs[0], hashes[0], pks))
    # Each kernel's most frequent lane count in a warm round, and the one
    # that carries the most lanes; g1_add at every size of the round (its
    # tree sum launches once at each power of two below the batch).
    warm = phase_sizes["single_hash"]
    frequent = {k: sorted({max(v, key=lambda b: (v[b], b)),
                           max(v, key=lambda b: (b * v[b], b))})
                for k, v in warm.items()}
    frequent["g1_add"] = sorted(warm["g1_add"])
    operands = kernel_operands(torch, args.seed)
    rows, sized = kernel_checks(torch, totals, operands, card, frequent)
    emit({"phase": "kernels_at_main_path_sizes", "kernels": sized})
    pair_rows, pair_phase = pairing_checks(torch, totals, per_flush, card,
                                           args.seed, ptxas)
    pair_phase["launches_per_qc_phase"] = {
        k: {phase: qc[phase][k] for phase in qc} for k in PAIRING}
    emit(pair_phase)
    emit(trace_round(torch, prov, sigs[0], hashes[0], pks))
    emit({"kernels": rows + pair_rows})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
