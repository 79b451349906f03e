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
               final_exp) with no host-oracle pairing;
  g2_tables    CudaBlsCrypto(g2_table_msm=True) over the same validators:
               update_pubkeys with the window-table build (seconds,
               table bytes, peak device memory), warm single-hash and
               3-hash rounds (every lane True, the ladder provider's
               verdicts, no G2 ladder launched) and the bad-lane batches
               against CpuBlsCrypto.

Every G2 add and doubling of these phases (the ladders, the tree sums,
the pubkey subgroup check, the tables) is one launch of csrc/g2_point.cu.

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
  pinned_upload    uploads issued behind 200 ms of queued work, at 20 KB
                   to 10 MB and as one warm round's upload set:
                   CudaBlsCrypto._to_dev (through pinned memory above
                   1.25 MB) must return at once, a pageable copy is timed
                   beside it; then the warm round under the parent's
                   pageable upload, pinning every upload, and _to_dev;
  sim              the port's validator fleet in process (sim/harness.py
                   SimNetwork, as `sim.run --crypto bls` builds it) at
                   deployment bls64-frontier: 64 validators, each on its
                   own CudaBlsCrypto("cuda"), the batching frontier on
                   (device and QC threshold 8, 50-ms linger), one warm
                   height, then SIM_HEIGHTS measured with the launch
                   counts set to 0 just before and read just after,
                   then one height profiled (torch.profiler's CUDA
                   activity against its wall, and a host stack sampler);
                   every committed proof is audited by the host oracle,
                   and a missed height, an idle kernel of the path, no
                   device batch, a breaker failure, a host pairing, a
                   frontier re-verify or a device fault fails the run;
  service          the same 64 validators through the service's entry
                   points (deployment bls64-service): 64 ServiceRuntimes
                   (crypto_backend "cuda") with fake network siblings on
                   one fabric and one fake controller (20-s interval),
                   on the gRPC wire where grpc imports, else in process
                   (LoopbackTransport); every node's reconfigure
                   validates the keys on the card before the controller
                   serves; one warm height and SERVICE_HEIGHTS measured
                   (launch counts set to 0 just before, read just
                   after); every measured proof through node 0's
                   CheckBlock as committed and tampered (data, and
                   another height's signature); node 0's /metrics and
                   /statusz.  A missed height, an idle kernel, a pubkey
                   update, QC call or CheckBlock on the host, a wrong
                   verdict, a device fault, host pairing, re-verify or
                   breaker failure, or a missing metric or section fails
                   the run;

  ed25519          Ed25519CudaCrypto("cuda").verify_batch on 8192 votes
                   of 8192 validators (every lane must pass; cold, warm
                   with the launch counts set to 0 just before, and
                   profiled), then a 64-lane batch with a wrong signer,
                   another hash, an undecodable key, s >= L, R with
                   y >= p, an undecodable R and small-torsion components
                   in R and in A, verdict for verdict against the port's
                   cofactored host rule;
  secp256k1, sm2   the same for Secp256k1Crypto at 1024 lanes (its bad
                   batch has r = 0 and a high s) and Sm2Crypto at 8192
                   (r = 0 and r + s = 0 mod n), then one QC of every vote
                   through verify_aggregated_signature on the card;
  curves_sim       sim.run's factory for each of the three schemes at 16
                   validators (device threshold 2), one warm height and
                   CURVES_SIM_HEIGHTS measured: every height commits,
                   device calls > 0, the scheme's kernels launched, no
                   device fault, re-verify or breaker failure, every
                   proof audited on the host;
  chaos            cell bls100-chaos: one in-process sim.run (sim/run.py
                   main) of the JAX package's chaos acceptance run
                   (--chaos --chaos-adaptive 1 --chaos-device-faults 1
                   --validators 100 --seed 7) on BLS12-381 on the card,
                   every verify of the fleet through one shared frontier
                   over one CudaBlsCrypto("cuda"), with a tenant flood,
                   the soak-chaos survival lane, the critical-path
                   trace and /statusz (read once while it runs); launch
                   counts set to 0 just before and read just after.  A
                   non-zero exit, a safety violation, an unfired event
                   of the schedule, a crashed node that never commits
                   again, no adaptive switch, no frontier batch in the
                   armed window, a shared breaker that never opened or
                   ends open, a flood without sheds or with a verdict
                   that is not False, a drift failure, no completed
                   soak cycle, fewer than 5 telemetry samples, critical
                   path shares off 1 by more than 0.05, a soak record
                   the port's obs/ledger.py cannot load, a view change
                   at a height no chaos event touched, or an idle kernel
                   fails the run;
  mesh             cell bls8192-mesh4: the same deployment over
                   MESH_LANES (4) logical lanes of the one card
                   (parallel/sharded.py Mesh; the machine has one card,
                   so no figure here is a multi-GPU one).  Each sharded
                   function against its single-card function on the same
                   inputs at 8192 votes, 16384 cache rows and 64-bit
                   weights (verify_round, verify_round_multi at k = 3,
                   g2_validate, g1_validate_sum, g2_sum_rows, round_step:
                   every output torch.equal; round_step's sums also
                   verify_round's and g1_validate_sum's; the pairing
                   verdict on valid, forged, infinity and padded pair
                   sets, also the oracle's), each timed beside it, and the
                   two collective-free twins run; then CudaBlsCrypto(mesh=...)
                   through its entry points with the launch counts set to
                   0 just before and read just after (every key on the
                   card, the single-hash and 3-hash rounds, the bad-lane
                   batches against CpuBlsCrypto, the QC aggregate and its
                   verdicts; every call on the device, every BLS kernel
                   launched, lanes per launch printed) and its warm round
                   in turns with the single card's; the ladder walk at 64
                   lanes (a lost lane, a 3-lane sub-mesh that dispatches
                   clean, an unattributed fault to the single card, the
                   climb back, a dcn_stall past the dispatch deadline:
                   exact verdicts, exactly 3 device failures, no host
                   pairing); profile_sharded_stages (the lanes' own work
                   and the combine, each timed alone, median of 5); and
                   sharded_verify_round over a one-rank NCCL group
                   (init_multihost, global_mesh), equal to the
                   single-process mesh's, then a provider over that group
                   (no supervisor; its route agreed by an all_reduce)
                   verifying a round on the device;

  pairing_ab       the warm single-hash round with device pairing off,
                   on, on, off (seconds, verifies/s), and the device
                   pairing's own time per flush at 2 and 5 pairs;
  crosscheck       one warm round with CONSENSUS_PAIRING_CROSSCHECK=1:
                   any device/host verdict mismatch fails the run;
  tooling          the build namespace (compile_cache.build_dir(),
                   _build/host-<fingerprint>/: the fingerprint's inputs,
                   a second build_all that must count no miss and a hit
                   for every library, every library the process loaded
                   mapped from there; cold and warm build seconds), the
                   port's lint over the checkout (python -m
                   consensus_overlord_tpu_torch.analysis --json: exit 0,
                   no actionable finding; counts by rule, suppressed
                   ones included) and the multichain twin (python -m
                   consensus_overlord_tpu_torch.sim.multichain) at its
                   defaults and with --adversarial 1, one after the
                   other (FAIRNESS compares queue waits that a
                   neighbour on the cores skews):
                   every condition met, no garbage verdict True, each
                   tenant's sheds and p50 wait printed;
  tools            the port's operator tools, each a subprocess on the
                   card (tools_phase): profile_verify at 8192 lanes, 4
                   measured rounds, the first traced by torch.profiler,
                   whose split of a warm round (parse, dispatch,
                   readback, pairing ms) is printed on a line of its own
                   (verify_split, with the round's time outside the
                   four; device pairing on, no host fallback, a trace
                   written); profile_verify over 4 logical lanes at
                   1024 with the sharded probe and a straggler injected
                   on lane cuda:0/2, the only lane flagged; pairing_smoke
                   at 4 sets, alone and over 4 lanes with lane 2 lost
                   (the supervisor's 3-lane sub-mesh), both exit 0;
                   warm_cache at rungs 32 and 128, its build 10 hits and
                   no miss; the ledger CLI's check over the two profile
                   records, exit 0.

Then each kernel is held against its plain version (tolerance 0:
integer arithmetic, torch.equal) and timed with CUDA events beside its
plain version and the least time the card could take for the same work:
the field and G1 kernels at B = 8192 and at their most frequent and
lane-heaviest launch sizes in a warm round (g1_add at every size of the
round); the G2 kernels (phase g2_kernels) at every size of the warm
round and at the lane-heaviest launch of the 3-hash round and of each
g2_tables call, with registers, spills and resident warps; the pairing kernels (phase pairing_kernels) on seeded loose
limbs at 1, 2 and 5 pairs, the Fq12 multiply at 1, 2, 4 and 5 lanes,
the final exponentiation at 1 and 3, fq_inv (final_exp_kernel on the
fq_inv12 program: FieldSpec.inv on the card) at 1, 12, 64 and 8192
elements, each also beside its latency bound
(its multiply depth times one dependent product of the field core on
one warp, timed by the measuring kernel tower_probe_kernel with no
program table), with each program's epochs, steps per warp, registers
and shared memory; and the kernels of the three other schemes (phase
curve_kernels: fq_mul at 26 limbs for each field, ed_add, ed_ladder,
secp_add, secp_dbl, wp_add_general, wp_dual_ladder) on seeded loose
limbs at the launch size that carried the most lanes on its scheme's
warm path, with their registers, spills and resident warps; each ladder
also against the step-by-step route there (one point-kernel launch an
add) and against its plain version at LADDER_PLAIN_LANES lanes (these
rows of the kernels line give `lanes` for `ms` and `plain_lanes` for
`plain_ms`).  Each phase prints one JSON line; the kernels line, the
card's name and power limit, and the contract line close the output.  A profiled warm round, last so that the profiler touches no
host-clock phase, reports the device-busy time by kernel.  Any failure exits non-zero.  Exits 2 without a result when no
GPU is visible; fixtures (consensus_overlord_tpu_torch/tools/fixtures.py)
are cached under .smoke_fixtures/.
"""

from __future__ import annotations

import argparse
import asyncio
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


def make_fixtures(seed: int, validators: int, nhash: int = 3):
    """tools/fixtures.py make_fixtures (imported at the call, so that this
    script starts, and says so, where the port is missing)."""
    from consensus_overlord_tpu_torch.tools.fixtures import (
        make_fixtures as build)
    return build(seed, validators, nhash)


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
    from consensus_overlord_tpu_torch.ops import kernels
    n = spec.n
    limbwise = {"imad": 0, "alu": 0, "either": n}
    f = {name: _ops((1, limbwise), (1, plan_ops(spec, name)))
         for name in kernels.plan_names(spec) if name != "mul"}
    f["mul"] = _ops((1, {"imad": n * n, "alu": 0, "either": 0}),
                    (1, plan_ops(spec, "mul")))
    f["add"] = f.pop("add2")
    return f


#: The Fq operations of the field product and of the a = 0 group law
#: (Renes–Costello–Batina Algorithms 7 and 9), as word_ops prices them:
#: products, the first stage's products (reduced one by one; each output
#: is a sum of products of two of them, reduced once), additions and
#: subtractions, small multiples (3b, 3, 8, 2), values loaded and stored.
WORD_FUNCTIONS = {
    "mul": {"mul": 1, "stage1": 0, "chain": 0, "small": 0, "load": 2,
            "out": 1},
    "add": {"mul": 12, "stage1": 6, "chain": 17, "small": 3, "load": 6,
            "out": 3},
    "dbl": {"mul": 8, "stage1": 4, "chain": 3, "small": 4, "load": 3,
            "out": 3},
}


def word_ops(spec, fn: str) -> dict:
    """int32 instructions per lane, by pipe, of the least the function
    needs in 32-bit words (⌈bits/32⌉: 12 for BLS12-381's Fq, 8 for the
    256-bit fields), by the rule of ops/g2_words.py bound_steps: a word
    product for each Fq product and for each output's Montgomery scale
    correction, a REDC for each first-stage product and two for each
    output (its sum, its correction), a carry chain for each addition or
    subtraction, a small multiple for each product by a constant, and the
    entry (repack and quotient step) of each value loaded from limbs and
    the exit of each stored."""
    from consensus_overlord_tpu_torch.ops import g2_words

    words = -(-spec.p.bit_length() // 32)
    f = WORD_FUNCTIONS[fn]
    return g2_words.price_steps(
        {"row": words * (f["mul"] + f["out"]),
         "redc_step": words * (f["stage1"] + 2 * f["out"]),
         "chain": f["chain"], "small": f["small"],
         "quotient": f["load"], "entry": f["load"], "exit": f["out"]},
        g2_words.step_ops(words, spec.n))


def lane_ops(spec) -> dict:
    """int32 instructions per lane of each kernel, by pipe: the field and
    G1 kernels' and the G2 kernels' from the least their function needs
    in 32-bit words (word_ops; ops/g2_words.py bound_ops), not from the
    10-bit limb program as written; the pairing kernels' from their
    programs' op counts over the limb field ops (ops/tower_program.py)."""
    from consensus_overlord_tpu_torch.ops import g2_words, tower_program
    f = field_ops(spec)
    out = {"fq_mul": word_ops(spec, "mul"), "g1_add": word_ops(spec, "add"),
           "g1_dbl": word_ops(spec, "dbl"),
           "g2_add": g2_words.bound_ops(g2_words.ADD),
           "g2_dbl": g2_words.bound_ops(g2_words.DBL)}
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
        ms = time_ms(torch, run, 100, card["clock_hz"])
        return {"max_abs_err": err, "ms": ms,
                "plain_ms": time_ms(torch, plain, 10, card["clock_hz"]),
                "bound_ms": bound_ms, "bound_by": bound_by,
                "time_over_bound": ms / bound_ms}

    field = [k for k in kernels.BLS_KERNELS
             if k.name in ("fq_mul", "g1_add", "g1_dbl")]
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


#: Above this many lanes a G2 kernel is held against its plain version on
#: its first and last G2_PLAIN_SLICE lanes (the plain version's outer
#: products take about 110 KB a lane).
G2_PLAIN_MAX = 24576
G2_PLAIN_SLICE = 8192


#: Lanes of the G2 operands whose every limb is at the loose bound, then
#: as many of random loose limbs (off the curve: the formulas are
#: polynomials, so the kernel and its plain version must still agree).
G2_LOOSE_LANES = slice(16, 32)
G2_RANDOM_LANES = slice(32, 48)


def g2_operands(torch, prov, seed: int):
    """G2 operands from the provider's device pubkey cache (the
    fixtures' keys as g2_validate left them): P its first LANES rows, Q
    the same rows reversed, with an identity in P's fourth-last lane and
    Q's third-last, P + P and P + (−P) in the last two lanes, every limb
    at 4095 in both in G2_LOOSE_LANES and random loose limbs from `seed`
    in G2_RANDOM_LANES."""
    from consensus_overlord_tpu_torch.ops import bls12381_groups as dev

    p = dev.Point(*(c[:LANES].clone() for c in prov._pk_device()))
    q = dev.Point(*(c.flip(0) for c in p))
    inf = dev.G2.infinity_like(p.x[:1])
    neg = dev.G2.neg(dev.Point(*(c[-1:] for c in p)))
    gen = torch.Generator(device=p.x.device).manual_seed(seed + 12)
    for cp, cq, ci, cn in zip(p, q, inf, neg):
        cp[-4] = ci[0]
        cq[-3] = ci[0]
        cq[-2] = cp[-2]
        cq[-1] = cn[0]
        for c in (cp, cq):
            c[G2_LOOSE_LANES] = dev.FQ.loose_max
            c[G2_RANDOM_LANES] = torch.randint(
                0, dev.FQ.loose_max + 1, c[G2_RANDOM_LANES].shape,
                dtype=c.dtype, device=c.device, generator=gen)
    return p, q


def g2_kernel_checks(torch, kernels, launches: dict, card: dict, operands,
                     sizes: dict, ptxas: dict, pk_aff):
    """g2_add and g2_dbl vs their plain versions on the card: every
    output coordinate equal in canonical value (FieldSpec.strict of both,
    torch.equal: the kernels choose their own limbs), every output limb
    at most FQ.loose_max; timed with CUDA events beside the plain version
    and the bound (the least the function needs in words,
    g2_words.bound_ops), at B = LANES for the kernels line and at every
    lane count of `sizes` (operands tiled), with
    registers, spills and resident warps; and g2_add's first lane against
    the oracle."""
    from consensus_overlord_tpu_torch.crypto import bls12381 as oracle
    from consensus_overlord_tpu_torch.ops import bls12381_groups as dev

    p, q = operands
    fq = dev.FQ
    ops = lane_ops(fq)
    lane_bytes = {"g2_add": 18 * fq.n * 4, "g2_dbl": 12 * fq.n * 4}

    def measure(name: str, lanes: int) -> dict:
        idx = torch.arange(lanes, device="cuda") % LANES
        ps = dev.Point(*(c[idx] for c in p))
        qs = dev.Point(*(c[idx] for c in q))
        if name == "g2_add":
            run = lambda: dev.G2.add(ps, qs)  # noqa: E731
            plain = lambda a, b: dev.G2.add_plain(a, b)  # noqa: E731
        else:
            run = lambda: dev.G2.dbl(ps)  # noqa: E731
            plain = lambda a, b: dev.G2.dbl_plain(a)  # noqa: E731
        got = run()
        if max(int(g.max()) for g in got) > fq.loose_max or \
                min(int(g.min()) for g in got) < 0:
            fail(f"{name}: an output limb outside 0..{fq.loose_max} at "
                 f"B = {lanes}")
        cuts = ([slice(0, lanes)] if lanes <= G2_PLAIN_MAX else
                [slice(0, G2_PLAIN_SLICE), slice(lanes - G2_PLAIN_SLICE,
                                                 lanes)])
        err = 0
        for cut in cuts:
            a, b = (dev.Point(*(c[cut] for c in pt)) for pt in (ps, qs))
            want = [fq.strict(w) for w in plain(a, b)]
            mine = [fq.strict(g[cut]) for g in got]
            if not all(torch.equal(g, w) for g, w in zip(mine, want)):
                fail(f"{name} differs from its plain version at B = {lanes}")
            err = max([err] + [int((g.long() - w.long()).abs().max())
                               for g, w in zip(mine, want)])
        a, b = (dev.Point(*(c[cuts[0]] for c in pt)) for pt in (ps, qs))
        bound_ms, bound_by = bound(ops[name], lanes, lane_bytes[name] * lanes,
                                   card["clock_hz"])
        ms = time_ms(torch, run, 100, card["clock_hz"])
        return {"max_abs_err": err, "ms": ms,
                "plain_ms": time_ms(torch, lambda: plain(a, b), 10,
                                    card["clock_hz"]),
                "bound_ms": bound_ms, "bound_by": bound_by,
                "lanes": lanes, "plain_lanes": cuts[0].stop - cuts[0].start,
                "time_over_bound": ms / bound_ms}

    got = dev.g2_to_oracle(dev.Point(*(c[:1] for c in dev.G2.add(p, q))))
    if got != [oracle.g2_add(pk_aff[0], pk_aff[LANES - 1])]:
        fail("g2_add disagrees with the oracle")
    rows, phase = [], {"phase": "g2_kernels", "kernels": []}
    for k in (kernels.G2_ADD, kernels.G2_DBL):
        info = ptxas.get(k.name + "_kernel", {})
        if info.get("spill_stores", 1) or info.get("spill_loads", 1):
            fail(f"{k.name}: spills or missing from the ptxas report")
        warps = kernels.resident_warps(k.name, dev.FQ, torch.device("cuda"))
        for lanes in sorted(set(sizes[k.name]) | {LANES}):
            m = measure(k.name, lanes)
            phase["kernels"].append(
                {"name": k.name, **m, "registers": info.get("registers"),
                 "spill_stores": info["spill_stores"],
                 "spill_loads": info["spill_loads"],
                 "resident_warps": warps})
            if lanes == LANES:
                rows.append({"name": k.name, "route": k.route,
                             "source": k.source, "replaces": k.replaces,
                             "launches": launches[k.name],
                             **{key: m[key] for key in (
                                 "max_abs_err", "ms", "plain_ms", "bound_ms",
                                 "bound_by")},
                             "library_ms": None, "lanes": lanes})
    return rows, phase


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
    from consensus_overlord_tpu_torch.ops.field import BLS12_381_FQ

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
    # FieldSpec.inv on the card: final_exp_kernel on the fq_inv12
    # program, twelve elements a lane, against the plain inversion
    # (pow_static over mul_plain) at the paths' element counts: one (each
    # to_affine of a verify round or QC), 12 (one full lane), 64 and
    # LANES (the pubkey cache's affine readback).
    inv_prog = tower_program.program("fq_inv12", BLS12_381_FQ).stats
    per_elem = {k: c // kernels.FQ_INV_PER_LANE
                for k, c in inv_prog["by_kind"].items()}
    inv_ops = _ops(*((c, field_ops(BLS12_381_FQ)[k])
                     for k, c in per_elem.items()))
    for elems in (1, 12, 64, LANES):
        x = loose(elems)
        run, plain = (lambda: kernels.fq_inv(BLS12_381_FQ, x),
                      lambda: fq.inv(x))
        got, want = run(), plain()
        if not torch.equal(got, want):
            fail(f"fq_inv differs from the plain inversion at {elems}")
        bound_ms, bound_by = bound(inv_ops, elems, 2 * 4 * fq.n * elems,
                                   card["clock_hz"])
        row = {"name": "fq_inv", "lanes": elems,
               "max_abs_err": int((got.long() - want.long()).abs().max()),
               "ms": time_ms(torch, run, 20, card["clock_hz"]),
               "plain_ms": time_ms(torch, plain, 2, card["clock_hz"]),
               "bound_ms": bound_ms, "bound_by": bound_by,
               "latency_bound_ms": inv_prog["mul_depth"] * product_ms}
        row["binding_bound"] = ("latency" if row["latency_bound_ms"] >
                                bound_ms else bound_by)
        measured.append(row)
        if elems == 1:
            k = kernels.FQ_INV
            rows.append({"name": k.name, "route": k.route,
                         "source": k.source, "replaces": k.replaces,
                         "launches": launches[k.name],
                         **{key: row[key] for key in (
                             "max_abs_err", "ms", "plain_ms", "bound_ms",
                             "bound_by")},
                         "library_ms": None})
    programs = {}
    for name in PAIRING + ("fq_inv12",):
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
                         r"g2_dbl_kernel|g2_add_kernel|"
                         r"miller_product_kernel|fq12_mul_kernel|"
                         r"final_exp_kernel|ed_add_kernel|ed_ladder_kernel|"
                         r"wp_add_general_kernel|wp_dual_ladder_kernel)")


def ptxas_report(kernels, spec=None, libs=None) -> dict:
    """Registers, stack and spills of every kernel entry, from ptxas's
    -v report of the build of each library of a field (default
    BLS12-381's; `libs` names a subset)."""
    spec = spec or kernels._default_spec()
    # A checkout from before the per-field builds (scripts/
    # torch_kernels_ab.py reads a parent's) builds every library for BLS.
    libs = libs or (kernels.spec_libs(spec) if hasattr(kernels, "spec_libs")
                    else kernels._LIBS)
    out, cur = {}, None
    for lib in libs:
        for line in kernels.build_log(lib, spec).splitlines():
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
            for name in ("fq_mul", "g1_add", "g1_dbl", "g2_add", "g2_dbl")
            + PAIRING}
    return {"phase": "single_hash_trace", "votes": n, "wall_s": wall,
            "device_busy_s": busy, "device_idle_share": 1 - busy / wall,
            "kernel_launches": sum(e.count for e in kern),
            "top_kernels": [{"name": e.key[:48], "calls": e.count,
                             "ms": e.self_device_time_total / 1e3}
                            for e in top],
            "port_kernels": {name: {"calls": sum(c for c, _ in v),
                                    "ms": sum(m for _, m in v)}
                             for name, v in ours.items()}}



# -- the fleet -------------------------------------------------------------------

#: Deployment bls64-frontier: the scheme of BASELINE.json config 4
#: (BLS12-381 aggregated signatures, unweighted), the fleet of config 2
#: (64 validators) in one process on one shard with the batching frontier
#: on, the sim's device threshold (consensus_overlord_tpu/sim/run.py:351;
#: QC threshold equal to it) and the linger of the JAX package's BLS
#: device row (BASELINE.md:381).  Cut from 4,096 validators to 64: one
#: Python process carries every engine (BASELINE.md:378, :386-388).
SIM_VALIDATORS = 64
SIM_WARM_HEIGHTS = 1
#: Measured heights: 2 keep the whole smoke, chaos phase included, well
#: inside its time limit.
SIM_HEIGHTS = 2
#: The block interval.  At 2 s the fleet never committed height 1 on an
#: H100 80GB HBM3 (700 W): its host work outran the round timers and
#: every node verified 63 chokes a round.  At 10 s no view change.
SIM_INTERVAL_MS = 10000
SIM_THRESHOLD = 8
SIM_LINGER_MS = 50.0
#: How long one height may take before the phase fails.  Not a pacing
#: parameter: a height takes the interval plus its work.
SIM_TIMEOUT_S = 120.0
#: The kernels every measured height must launch (fq12_mul is reported).
SIM_KERNELS = ("fq_mul", "g1_add", "g1_dbl", "g2_add", "g2_dbl",
               "miller_product", "final_exp", "fq_inv")


#: Upload sizes the pinned_upload phase issues behind queued work: 20 KB
#: (the arrays of a 64-lane QC are smaller), the 8192-lane round's
#: signature limbs (1.25 MB, the provider's _PAGEABLE_MAX_BYTES), and 2,
#: 4 and 8 times that.
UPLOAD_BYTES = (20_480,) + tuple(k * 8192 * 39 * 4 for k in (1, 2, 4, 8))


def pinned_upload(torch, prov, card, sigs, h, pks) -> dict:
    """Uploads issued while the card is busy (200 ms of queued work): at
    each of UPLOAD_BYTES a copy from pageable memory and one through
    CudaBlsCrypto._to_dev, then the arrays one warm 8192-lane
    single-hash round uploads, issued back to back both ways.  _to_dev
    must return long before the queued work ends every time.  Then the
    warm round itself is timed under three upload rules, in the order
    pageable, pin_all, to_dev, to_dev, pin_all, pageable: every upload
    from pageable memory, every upload through pinned memory, and
    _to_dev's rule (pinned above _PAGEABLE_MAX_BYTES)."""
    import numpy as np

    from consensus_overlord_tpu_torch.crypto import cuda_provider

    queued_ms = 200.0
    cycles = int(queued_ms * 1e-3 * card["clock_hz"])
    device = prov.device

    def pageable(a):
        return torch.as_tensor(a).to(device, non_blocking=True)

    def pin_all(a):
        return torch.as_tensor(a).pin_memory().to(device, non_blocking=True)

    def behind_queue(upload, arrays) -> float:
        torch.cuda.synchronize()
        torch.cuda._sleep(cycles)
        t0 = time.perf_counter()
        got = [upload(a) for a in arrays]
        host_ms = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        for g, a in zip(got, arrays):
            if not torch.equal(g.cpu(), torch.as_tensor(a)):
                fail("pinned_upload: an uploaded copy differs")
        return host_ms

    out = {"phase": "pinned_upload", "queued_ms": queued_ms,
           "pageable_max_bytes": cuda_provider._PAGEABLE_MAX_BYTES,
           "sizes": {}}
    for nbytes in UPLOAD_BYTES:
        arr = np.arange(nbytes // 4, dtype=np.int32)
        prov._to_dev(arr)  # the pinned pool's first block
        out["sizes"][nbytes] = {
            "pageable_host_ms": behind_queue(pageable, [arr]),
            "to_dev_host_ms": behind_queue(prov._to_dev, [arr])}
    n = len(pks)
    recorded = []
    real = prov._to_dev
    prov._to_dev = lambda a: (recorded.append(np.array(a)), real(a))[1]
    try:
        prov.verify_batch(sigs, [h] * n, pks)
    finally:
        del prov._to_dev
    out["round_uploads"] = {
        "arrays": len(recorded),
        "bytes": sum(a.nbytes for a in recorded),
        "pageable_host_ms": behind_queue(pageable, recorded),
        "to_dev_host_ms": behind_queue(prov._to_dev, recorded)}
    rules = {"pageable": pageable, "pin_all": pin_all, "to_dev": None}
    rounds = {rule: [] for rule in rules}
    for rule in ("pageable", "pin_all", "to_dev", "to_dev", "pin_all",
                 "pageable"):
        if rules[rule] is not None:
            prov._to_dev = rules[rule]
        try:
            t0 = time.perf_counter()
            got = prov.verify_batch(sigs, [h] * n, pks)
            rounds[rule].append(time.perf_counter() - t0)
        finally:
            prov.__dict__.pop("_to_dev", None)
        if got != [True] * n:
            fail(f"pinned_upload: the {rule} round rejected valid votes")
    out["round_s"] = rounds
    waited = [k for k, v in out["sizes"].items()
              if v["to_dev_host_ms"] > queued_ms / 2]
    if waited or out["round_uploads"]["to_dev_host_ms"] > queued_ms / 2:
        fail(f"pinned_upload: _to_dev waited for the card: {out}")
    return out


def _fleet_totals(net) -> dict:
    from consensus_overlord_tpu_torch.sim.run import sum_status

    stats = [n.frontier.stats for n in net.nodes]
    router = net.router.stats()
    return {"status": sum_status(n.crypto.degraded_status()
                                 for n in net.nodes),
            "batches": sum(s.batches for s in stats),
            "requests": sum(s.requests for s in stats),
            "max_lanes": max(s.max_batch for s in stats),
            "reverified": sum(s.reverified for s in stats),
            "device_faults": sum(s.device_faults for s in stats),
            "delivered": router["delivered"], "dropped": router["dropped"],
            "view_changes": [vc for n in net.nodes
                             for vc in n.adapter.view_changes]}


def _audit_proofs(net, heights) -> int:
    """Each committed proof decoded, its voters extracted against the
    controller's authority list and the aggregate checked on the
    precommit vote hash by the host oracle (CpuBlsCrypto)."""
    from consensus_overlord_tpu_torch.core.bitmap import extract_voters
    from consensus_overlord_tpu_torch.core.sm3 import sm3_hash
    from consensus_overlord_tpu_torch.core.types import (
        Proof, Vote, VoteType)
    from consensus_overlord_tpu_torch.crypto.provider import CpuBlsCrypto

    ctl = net.controller
    authority = ctl.authority_list()
    oracle = CpuBlsCrypto(0x1000)
    for h in heights:
        proof = Proof.decode(ctl.proofs[h])
        voters = extract_voters(authority, proof.signature.address_bitmap)
        vote = Vote(proof.height, proof.round, VoteType.PRECOMMIT,
                    proof.block_hash)
        if (proof.height != h or 3 * len(voters) <= 2 * len(authority)
                or not oracle.verify_aggregated_signature(
                    proof.signature.signature, sm3_hash(vote.encode()),
                    voters)):
            fail(f"sim: the proof of height {h} fails the audit")
    if ctl.violations:
        fail(f"sim: safety violations {ctl.violations}")
    return len(heights)


class HostSampler:
    """Every `every_s`, every thread's innermost Python frame
    (sys._current_frames): a thread in threading, queue, selectors or an
    executor's worker loop waits; one standing on a `with _ISSUE:` line
    of the provider waits for the issue lock (cuda_provider._ISSUE); any
    other runs Python or sits in a C call (a launch, a copy, the native
    pairing), and is charged to the innermost frame of the port's
    package."""

    WAITS = ("threading.py", "queue.py", "selectors.py", "thread.py")
    PKG = os.sep + "consensus_overlord_tpu_torch" + os.sep

    def __init__(self, every_s: float = 0.05):
        import collections
        import threading

        self.every_s = every_s
        self.samples = 0
        self.threads = collections.Counter()
        self.modules = collections.Counter()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True)

    @staticmethod
    def _on_issue_lock(frame) -> bool:
        import linecache

        name = frame.f_code.co_filename
        return (name.endswith("cuda_provider.py") and linecache.getline(
            name, frame.f_lineno).strip() == "with _ISSUE:")

    @staticmethod
    def _role(name: str) -> str:
        if name == "MainThread":
            return "event loop"
        if name.startswith("frontier-dispatch"):
            return "frontier dispatchers"
        if name.startswith("asyncio"):
            return "resolvers"
        return "other"

    def _loop(self) -> None:
        import threading

        me = threading.get_ident()
        while not self._stop.wait(self.every_s):
            names = {t.ident: t.name for t in threading.enumerate()}
            for ident, frame in sys._current_frames().items():
                if ident == me:
                    continue
                role = self._role(names.get(ident, ""))
                if frame.f_code.co_filename.endswith(self.WAITS):
                    self.threads[role + " waiting"] += 1
                    continue
                if self._on_issue_lock(frame):
                    self.threads[role + " on the issue lock"] += 1
                    continue
                self.threads[role + " running"] += 1
                f = frame
                while f is not None and self.PKG not in f.f_code.co_filename:
                    f = f.f_back
                self.modules[f.f_code.co_filename.split(self.PKG, 1)[1]
                             if f is not None else "outside the port"] += 1
            self.samples += 1

    def __enter__(self):
        self._thread.start()
        return self

    def __exit__(self, *exc) -> None:
        self._stop.set()
        self._thread.join()

    def report(self) -> dict:
        running = max(sum(self.modules.values()), 1)
        return {"samples": self.samples, "every_ms": self.every_s * 1e3,
                "thread_samples": dict(sorted(self.threads.items())),
                "running_share_by_module": {
                    k: v / running for k, v in self.modules.most_common(8)}}


def sim_fleet(torch, kernels, seed: int) -> dict:
    """The port's validator fleet in process (sim/harness.py SimNetwork,
    as sim/run.py --crypto bls builds it) at deployment bls64-frontier:
    every node on its own CudaBlsCrypto(device="cuda") with the JAX
    package's sim keys; one warm height, then SIM_HEIGHTS measured with
    the launch counts set to 0 just before and read just after; then one
    more height, profiled: a torch.profiler trace of the CUDA activity
    (device-busy seconds against the height's wall) and a HostSampler."""
    import asyncio

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from consensus_overlord_tpu_torch.crypto.cuda_provider import (
        CudaBlsCrypto)
    from consensus_overlord_tpu_torch.obs.prof import DeviceProfiler
    from consensus_overlord_tpu_torch.sim import SimNetwork

    async def drive():
        t0 = time.perf_counter()
        net = SimNetwork(
            n_validators=SIM_VALIDATORS, block_interval_ms=SIM_INTERVAL_MS,
            seed=seed, use_frontier=True,
            frontier_linger_s=SIM_LINGER_MS / 1000.0,
            crypto_factory=lambda i: CudaBlsCrypto(
                0x1000 + 7919 * i, device="cuda",
                device_threshold=SIM_THRESHOLD),
            sim_device_crypto=True, profiler=DeviceProfiler(),
            flight_recorder_capacity=256)
        doc = {"setup_s": time.perf_counter() - t0}
        # Each node validates its authority set's keys into its own
        # pubkey cache on the card, as a node does on reconfigure.
        t0 = time.perf_counter()
        for n in net.nodes:
            n.crypto.update_pubkeys(net.controller.validators)
        doc["pubkeys_s"] = time.perf_counter() - t0
        net.start(init_height=1)
        top = SIM_WARM_HEIGHTS + SIM_HEIGHTS
        want = SIM_WARM_HEIGHTS
        try:
            t0 = time.perf_counter()
            await net.run_until_height(want, SIM_TIMEOUT_S)
            doc["warm_s"] = time.perf_counter() - t0
            before = _fleet_totals(net)
            kernels.reset_counts()
            t0 = last = time.perf_counter()
            height_ms = []
            for want in range(SIM_WARM_HEIGHTS + 1, top + 1):
                await net.run_until_height(want, SIM_TIMEOUT_S)
                now = time.perf_counter()
                height_ms.append((now - last) * 1e3)
                last = now
            doc["total_s"] = last - t0
            doc["launches"] = kernels.counts()
            doc["launch_lanes"] = {k: kernels.size_buckets(v) for k, v in
                                   kernels.sizes().items() if v}
            after = _fleet_totals(net)
            want = top + 1
            with HostSampler() as sampler, profile(
                    activities=[ProfilerActivity.CUDA]) as trace:
                t0 = time.perf_counter()
                await net.run_until_height(want, SIM_TIMEOUT_S)
                wall = time.perf_counter() - t0
            final = _fleet_totals(net)
        except asyncio.TimeoutError:
            print(net.dump_flight_recorders(16), file=sys.stderr)
            fail(f"sim: stuck at height {net.controller.latest_height}, "
                 f"wanted {want} within {SIM_TIMEOUT_S} s")
        finally:
            await net.stop()
        kern = [e for e in trace.key_averages()
                if e.device_type == DeviceType.CUDA]
        busy = sum(e.self_device_time_total for e in kern) / 1e6
        top_k = sorted(kern, key=lambda e: -e.self_device_time_total)[:5]
        doc["profiled_height"] = {
            "wall_s": wall, "device_busy_s": busy,
            "device_idle_share": 1 - busy / wall,
            "kernel_launches": sum(e.count for e in kern),
            "top_kernels": [{"name": e.key[:48], "calls": e.count,
                             "ms": e.self_device_time_total / 1e3}
                            for e in top_k],
            "host": sampler.report()}
        doc["height_ms"] = height_ms
        doc["audited"] = _audit_proofs(net, range(1, top + 2))
        return doc, before, after, final

    doc, before, after, final = asyncio.run(drive())
    srt = sorted(doc["height_ms"])

    def pct(q: float) -> float:
        return srt[min(len(srt) - 1, int(q * len(srt)))]

    def delta(path: str, where: str) -> int:
        return (after["status"]["calls"][path][where]
                - before["status"]["calls"][path][where])

    batches = after["batches"] - before["batches"]

    def tally(changes) -> dict:
        out: dict = {}
        for _, _, why in changes:
            out[why] = out.get(why, 0) + 1
        return out

    reasons = tally(after["view_changes"][len(before["view_changes"]):])
    st = after["status"]
    out = {"phase": "sim", "deployment": "bls64-frontier",
           "validators": SIM_VALIDATORS, "warm_heights": SIM_WARM_HEIGHTS,
           "heights": SIM_HEIGHTS, "interval_ms": SIM_INTERVAL_MS,
           "device_threshold": SIM_THRESHOLD,
           "frontier_linger_ms": SIM_LINGER_MS,
           "setup_s": doc["setup_s"], "pubkeys_s": doc["pubkeys_s"],
           "warm_s": doc["warm_s"],
           "total_s": doc["total_s"],
           "ms_per_height": doc["total_s"] * 1e3 / SIM_HEIGHTS,
           "height_ms": doc["height_ms"], "p50_ms": pct(0.50),
           "p95_ms": pct(0.95),
           "frontier": {
               "batches": batches,
               "device_rounds": delta("verify_batch", "device"),
               "host_batches": delta("verify_batch", "host"),
               "mean_lanes": (after["requests"] - before["requests"])
               / max(batches, 1),
               "max_lanes_with_warm": after["max_lanes"],
               "reverified": after["reverified"] - before["reverified"]},
           "qc": {path: {w: delta(path, w) for w in ("device", "host")}
                  for path in ("aggregate", "verify_aggregated")},
           "launches": doc["launches"], "launch_lanes": doc["launch_lanes"],
           "breaker_failures": st["total_failures"],
           "breakers": st["state"],
           "pairing_host_fallbacks": st["pairing_host_fallbacks"],
           "delivered": after["delivered"] - before["delivered"],
           "dropped": after["dropped"] - before["dropped"],
           "view_changes": reasons,
           "warm_view_changes": tally(before["view_changes"]),
           "audited_proofs": doc["audited"],
           "profiled_height": doc["profiled_height"]}
    idle = [k for k in SIM_KERNELS if not out["launches"][k]]
    if idle:
        fail(f"sim: the measured heights never launched {idle}: {out}")
    if not out["frontier"]["device_rounds"]:
        fail(f"sim: no frontier batch went to the device: {out}")
    fst = final["status"]
    if (fst["total_failures"] or fst["pairing_host_fallbacks"]
            or final["reverified"] or final["device_faults"]):
        fail(f"sim: the device path degraded: {out}, through the profiled "
             f"height {fst}")
    if any(m == "jax" or m.startswith(("jax.", "consensus_overlord_tpu."))
           or m == "consensus_overlord_tpu" for m in sys.modules):
        fail("sim: the fleet imported JAX or the JAX package")
    return out


# -- the service ------------------------------------------------------------------

#: Deployment bls64-service: bls64-frontier through the service's entry
#: points (service/main.py ServiceRuntime), one process, crypto_backend
#: "cuda" on every node.
SERVICE_VALIDATORS = 64
SERVICE_WARM_HEIGHTS = 1
#: Measured heights: 2 keep the whole smoke, chaos phase included, well
#: inside its time limit.
SERVICE_HEIGHTS = 2
#: The controller's block interval, in seconds (ConsensusConfiguration
#: carries whole seconds).  The round timers are ratios of it (prevote
#: and precommit 1x, propose 1.5x), and one process verifies all 64
#: nodes' QCs in turn, about 8 s of a height's chain on an H100 80GB
#: HBM3 (700 W) host.  At 10 s a slower host crossed the timers: 39
#: nodes braked into round 1, 25 stayed in round 0, RPCs past their
#: 10-s deadline dropped, and no height committed within 120 s.  20 s
#: leaves the timers about 2.5x that chain.
SERVICE_INTERVAL_S = 20
SERVICE_LINGER_MS = 50.0
SERVICE_TIMEOUT_S = 120.0
#: The kernels every measured height must launch: the leader's QC
#: aggregates (fq_mul, g1_add) and every QC verify's device pairing.
#: Vote batches stay below the service's device threshold (32), so
#: g1_dbl and fq12_mul are reported, not required.
SERVICE_KERNELS = ("fq_mul", "g1_add", "g2_add", "miller_product",
                   "final_exp", "fq_inv")
#: /statusz sections node 0 must serve.
SERVICE_SECTIONS = ("crypto", "frontier", "commits", "health")


def service_transport():
    """The gRPC wire on localhost where `grpc` imports, else the
    in-process LoopbackTransport."""
    from consensus_overlord_tpu_torch.service.rpc import (
        GrpcTransport, LoopbackTransport)

    try:
        return GrpcTransport()
    except ImportError:
        return LoopbackTransport()


def _service_totals(runtimes) -> dict:
    from consensus_overlord_tpu_torch.sim.run import sum_status

    stats = [rt.consensus.frontier.stats for rt in runtimes]
    return {"status": sum_status(rt.consensus.crypto.degraded_status()
                                 for rt in runtimes),
            "batches": sum(s.batches for s in stats),
            "requests": sum(s.requests for s in stats),
            "max_lanes": max(s.max_batch for s in stats),
            "reverified": sum(s.reverified for s in stats),
            "device_faults": sum(s.device_faults for s in stats)}


def _with_signature_of(proof: bytes, other: bytes) -> bytes:
    """`proof` carrying the aggregate signature of `other`: it decodes,
    its hash and voters match, and only the signature check refuses it."""
    from consensus_overlord_tpu_torch.core.types import (
        AggregatedSignature, Proof)

    p, q = Proof.decode(proof), Proof.decode(other)
    return Proof(p.height, p.round, p.block_hash, AggregatedSignature(
        q.signature.signature, p.signature.address_bitmap)).encode()


async def check_blocks(runtime, controller, heights, transport) -> dict:
    """Every committed proof of `heights` through node `runtime`'s
    CheckBlock RPC (SUCCESS), then the same block with its data changed
    and with another height's signature (PROPOSAL_CHECK_ERROR each)."""
    from consensus_overlord_tpu_torch.service.pb import pb2
    from consensus_overlord_tpu_torch.service.rpc import (
        CONSENSUS_SERVICE, Code, RetryClient)

    client = RetryClient(f"localhost:{runtime.bound_port}",
                         "ConsensusService", CONSENSUS_SERVICE, retries=1,
                         transport=transport)
    wrong, sent, checks = [], 0, 0
    t0 = time.perf_counter()
    try:
        for h in heights:
            other = h - 1 if h - 1 in controller.proofs else h + 1
            data, proof = controller.chain[h], controller.proofs[h]
            for case, d, pr, want in (
                    ("committed", data, proof, Code.SUCCESS),
                    ("data", data + b"x", proof, Code.PROPOSAL_CHECK_ERROR),
                    ("signature", data,
                     _with_signature_of(proof, controller.proofs[other]),
                     Code.PROPOSAL_CHECK_ERROR)):
                resp = await client.call("CheckBlock", pb2.ProposalWithProof(
                    proposal=pb2.Proposal(height=h, data=d), proof=pr),
                    timeout=60.0)
                sent += 1
                checks += case != "data"  # the rest reach the signature
                if resp.code != want:
                    wrong.append({"height": h, "case": case,
                                  "code": resp.code, "want": want})
    finally:
        await client.close()
    return {"calls": sent, "signature_checks": checks,
            "seconds": time.perf_counter() - t0, "wrong": wrong}


def read_surface(port: int) -> dict:
    """Node 0's /metrics and /statusz over loopback HTTP."""
    import urllib.request

    base = f"http://127.0.0.1:{port}"
    with urllib.request.urlopen(f"{base}/metrics", timeout=10) as r:
        body = r.read()
    with urllib.request.urlopen(f"{base}/statusz", timeout=10) as r:
        status = json.loads(r.read())
    return {"metrics_bytes": len(body),
            "commit_latency_seconds":
                b"consensus_commit_latency_seconds_count" in body,
            "sections": sorted(status), "commits": status.get("commits"),
            "health": status.get("health")}


async def _loop_lag(lags: list, every_s: float = 0.05) -> None:
    """How late the event loop wakes a sleeper, every `every_s`: the
    time a callback waits for the loop (handlers, RPCs, timers)."""
    loop = asyncio.get_running_loop()
    while True:
        t0 = loop.time()
        await asyncio.sleep(every_s)
        lags.append(loop.time() - t0 - every_s)


def _lag_summary(lags: list) -> dict:
    srt = sorted(lags) or [0.0]
    return {"samples": len(lags), "p50": srt[len(srt) // 2] * 1e3,
            "p99": srt[min(len(srt) - 1, int(0.99 * len(srt)))] * 1e3,
            "max": srt[-1] * 1e3}


async def _settled_qc_verifies(prov, quiet_s: float = 2.0,
                               limit_s: float = 60.0) -> dict:
    """The provider's verify_aggregated calls once they have not moved
    for quiet_s: a QC verify a stopped engine had queued still lands."""
    import asyncio

    last = dict(prov.degraded_status()["calls"]["verify_aggregated"])
    t0 = still = time.perf_counter()
    while time.perf_counter() - still < quiet_s:
        if time.perf_counter() - t0 > limit_s:
            fail(f"service: QC verifies still running {limit_s} s after "
                 "the engines stopped")
        await asyncio.sleep(0.2)
        now = dict(prov.degraded_status()["calls"]["verify_aggregated"])
        if now != last:
            last, still = now, time.perf_counter()
    return last


async def drive_service(kernels, validators: int, device: str, transport,
                        warm: int, heights: int, interval_s: int,
                        timeout_s: float, linger_ms: float) -> dict:
    """Deployment bls64-service at `validators` nodes: ServiceRuntimes in
    this process, each with crypto_backend "cuda" on `device`, one
    FakeNetworkService each on a shared NetworkFabric, one
    FakeController, metrics on node 0 only, WALs in a temporary
    directory.  Every node starts (serves, registers with its network
    sibling, pings the controller, which does not serve yet); then each
    node's reconfigure (Consensus.proc_reconfigure, what the Reconfigure
    RPC and a successful ping run) applies the controller's
    configuration, validating the 64 keys into the node's pubkey cache,
    all before the controller serves: the engines start together, as in
    a deployment, not one validation (about 0.6 s on the event loop)
    apart.  `warm` heights, then `heights` measured with the launch
    counts set to 0 just before and read just after; then CheckBlock on
    node 0 and its /metrics and /statusz."""
    import tempfile

    from consensus_overlord_tpu_torch.crypto.provider import CpuBlsCrypto
    from consensus_overlord_tpu_torch.service.config import ConsensusConfig
    from consensus_overlord_tpu_torch.service.main import ServiceRuntime
    from consensus_overlord_tpu_torch.service.rpc import CONTROLLER_SERVICE
    from consensus_overlord_tpu_torch.service.rpc import generic_handler
    from consensus_overlord_tpu_torch.sim.grpc_fakes import (
        FakeController, NetworkFabric, start_fake_network)

    keys = [0x1000 + 7919 * i for i in range(validators)]
    pks = [CpuBlsCrypto(k).pub_key for k in keys]
    fabric = NetworkFabric(transport)
    fabric.set_validators(pks)
    controller = FakeController(pks, block_interval=interval_s,
                                transport=transport)
    ctrl_server, ctrl_port = transport.server(
        (generic_handler("Consensus2ControllerService", CONTROLLER_SERVICE,
                         controller),), port=0, host="localhost")
    servers, runtimes, view_changes = [ctrl_server], [], []
    lags, lag = [], None
    tmp = tempfile.TemporaryDirectory()
    doc = {"transport": transport.name}
    try:
        t0 = time.perf_counter()
        for i, key in enumerate(keys):
            net_server, net_port = await start_fake_network(fabric, i)
            servers.append(net_server)
            config = ConsensusConfig(
                network_port=net_port, consensus_port=0,
                controller_port=ctrl_port, server_retry_interval=1,
                wal_path=os.path.join(tmp.name, f"wal{i}"),
                enable_metrics=(i == 0), metrics_port=0,
                crypto_backend="cuda", frontier_linger_ms=linger_ms)
            rt = ServiceRuntime(config, key, host="localhost", device=device,
                                transport=transport)
            port = await rt.start()
            controller.consensus_addrs.append(f"localhost:{port}")
            runtimes.append(rt)
            brain = rt.consensus.brain
            brain.report_view_change = (
                lambda h, r, why, inner=brain.report_view_change:
                (view_changes.append(why), inner(h, r, why)))
        doc["setup_s"] = time.perf_counter() - t0
        lag = asyncio.get_running_loop().create_task(_loop_lag(lags))
        t0 = time.perf_counter()
        config = controller.current_config()
        for rt in runtimes:  # no await between: no engine starts early
            rt.consensus.proc_reconfigure(config)
        doc["reconfigure_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        await ctrl_server.start()
        want = warm
        await controller.wait_for_height(want, timeout_s + 60.0)
        doc["warm_s"] = time.perf_counter() - t0
        doc["warm_view_changes"] = len(view_changes)
        before = _service_totals(runtimes)
        changes_before, dropped_before = len(view_changes), fabric.dropped
        del lags[:]
        kernels.reset_counts()
        t0 = last = time.perf_counter()
        height_ms = []
        for want in range(warm + 1, warm + heights + 1):
            await controller.wait_for_height(want, timeout_s)
            now = time.perf_counter()
            height_ms.append((now - last) * 1e3)
            last = now
        doc["total_s"] = last - t0
        doc["dropped"] = fabric.dropped - dropped_before
        doc["loop_lag_ms"] = _lag_summary(lags)
        doc["launches"] = kernels.counts()
        doc["launch_lanes"] = {k: kernels.size_buckets(v) for k, v in
                               kernels.sizes().items() if v}
        after = _service_totals(runtimes)
        doc["view_changes"] = {}
        for why in view_changes[changes_before:]:
            doc["view_changes"][why] = doc["view_changes"].get(why, 0) + 1
        doc["height_ms"] = height_ms
        # Quiet the fleet first: node 0's engine verifies QCs on the
        # provider that serves its CheckBlock, so a height committing
        # meanwhile would add to CheckBlock's count.
        for rt in runtimes:
            rt.consensus.stop()
        node0 = runtimes[0].consensus.crypto
        qc0 = await _settled_qc_verifies(node0)
        doc["check_block"] = await check_blocks(
            runtimes[0], controller, range(warm + 1, warm + heights + 1),
            transport)
        qc1 = node0.degraded_status()["calls"]["verify_aggregated"]
        doc["check_block"]["on"] = {w: qc1[w] - qc0[w]
                                    for w in ("device", "host")}
        doc["surface"] = await asyncio.to_thread(
            read_surface, runtimes[0].metrics_port)
        final = _service_totals(runtimes)
        doc["committed"] = controller.latest_height
    except asyncio.TimeoutError:
        import collections

        if runtimes and runtimes[0].recorder is not None:
            print(runtimes[0].recorder.dump(16), file=sys.stderr)
        print(json.dumps({
            "committed": controller.latest_height,
            "nodes_at": collections.Counter(
                f"h{rt.consensus.engine.height}r{rt.consensus.engine.round}"
                for rt in runtimes),
            "view_changes": collections.Counter(view_changes),
            "dropped": fabric.dropped,
            "loop_lag_ms": _lag_summary(lags)}), file=sys.stderr)
        raise
    finally:
        if lag is not None:
            lag.cancel()
        for rt in runtimes:
            await rt.stop(0.5)
        for server in servers:
            await server.stop(0.5)
        await controller.close()
        await fabric.close()
        tmp.cleanup()
    doc["before"], doc["after"], doc["final"] = before, after, final
    return doc


def service_report(doc: dict, validators: int, heights: int) -> dict:
    """The phase line from drive_service's document: ms per height, and
    per path device calls against host calls over the whole run (pubkey
    updates happen at start) or the measured heights."""
    import statistics

    before, after, final = doc["before"], doc["after"], doc["final"]
    srt = sorted(doc["height_ms"])

    def delta(path: str, where: str) -> int:
        return (after["status"]["calls"][path][where]
                - before["status"]["calls"][path][where])

    batches = after["batches"] - before["batches"]
    st = final["status"]
    return {
        "phase": "service", "deployment": "bls64-service",
        "transport": doc["transport"], "validators": validators,
        "heights": heights, "setup_s": doc["setup_s"],
        "reconfigure_s": doc["reconfigure_s"],
        "warm_s": doc["warm_s"], "total_s": doc["total_s"],
        "ms_per_height": doc["total_s"] * 1e3 / heights,
        "height_ms": doc["height_ms"],
        "p50_ms": statistics.median(srt),
        "p95_ms": srt[min(len(srt) - 1, int(0.95 * len(srt)))],
        "update_pubkeys": st["pubkey_updates"],
        "aggregate": {w: delta("aggregate", w) for w in ("device", "host")},
        "qc_verify": {w: delta("verify_aggregated", w)
                      for w in ("device", "host")},
        "frontier": {
            "batches": batches,
            "device_rounds": delta("verify_batch", "device"),
            "host_batches": delta("verify_batch", "host"),
            "mean_lanes": (after["requests"] - before["requests"])
            / max(batches, 1),
            "max_lanes_with_warm": after["max_lanes"]},
        "check_block": doc["check_block"],
        "launches": doc["launches"], "launch_lanes": doc["launch_lanes"],
        "view_changes": doc["view_changes"],
        "warm_view_changes": doc["warm_view_changes"],
        "breaker_failures": st["total_failures"],
        "pairing_host_fallbacks": st["pairing_host_fallbacks"],
        "reverified": final["reverified"],
        "device_faults": final["device_faults"],
        "dropped": doc["dropped"], "loop_lag_ms": doc["loop_lag_ms"],
        "committed": doc["committed"], "surface": doc["surface"]}


def service_failures(out: dict) -> list:
    """What fails the service phase: a kernel of the path never launched,
    a device fault, host pairing, re-verify or breaker failure, a pubkey
    update, QC call or CheckBlock on the host, a wrong CheckBlock
    verdict, a /metrics without the commit latency or a /statusz without
    its sections.  (A missed height raises in drive_service.)"""
    bad = []
    idle = [k for k in SERVICE_KERNELS if not out["launches"].get(k)]
    if idle:
        bad.append(f"the measured heights never launched {idle}")
    for key in ("breaker_failures", "pairing_host_fallbacks", "reverified",
                "device_faults"):
        if out[key]:
            bad.append(f"{key}: {out[key]}")
    for path in ("update_pubkeys", "aggregate", "qc_verify"):
        if out[path]["host"] or not out[path]["device"]:
            bad.append(f"{path} ran on the host: {out[path]}")
    cb = out["check_block"]
    if cb["wrong"]:
        bad.append(f"wrong CheckBlock verdicts: {cb['wrong']}")
    if cb["on"]["host"] or cb["on"]["device"] != cb["signature_checks"]:
        bad.append(f"CheckBlock's signature checks did not run on the "
                   f"card: {cb['on']}")
    if not out["surface"]["commit_latency_seconds"]:
        bad.append("/metrics lacks consensus_commit_latency_seconds")
    missing = [s for s in SERVICE_SECTIONS
               if s not in out["surface"]["sections"]]
    if missing:
        bad.append(f"/statusz lacks {missing}")
    return bad


def service_fleet(kernels) -> dict:
    """The service phase (deployment bls64-service) on the card."""
    transport = service_transport()
    try:
        doc = asyncio.run(drive_service(
            kernels, SERVICE_VALIDATORS, "cuda", transport,
            SERVICE_WARM_HEIGHTS, SERVICE_HEIGHTS, SERVICE_INTERVAL_S,
            SERVICE_TIMEOUT_S, SERVICE_LINGER_MS))
    except asyncio.TimeoutError as e:
        fail(f"service: a height was missed: {e}")
    out = service_report(doc, SERVICE_VALIDATORS, SERVICE_HEIGHTS)
    bad = service_failures(out)
    if bad:
        fail(f"service: {'; '.join(bad)}: {out}")
    if any(m == "jax" or m.startswith(("jax.", "consensus_overlord_tpu."))
           or m == "consensus_overlord_tpu" for m in sys.modules):
        fail("service: the service imported JAX or the JAX package")
    return out


# -- the chaos acceptance run ------------------------------------------------------

#: Cell bls100-chaos: the JAX package's chaos acceptance run
#: (consensus_overlord_tpu/sim/README.md:134-140: sim.run --chaos
#: --chaos-adaptive 1 --chaos-device-faults 1 --validators 100 --seed 7)
#: on BLS12-381 on the card, every validator's verifies through one
#: shared frontier over one CudaBlsCrypto("cuda"), with a tenant flood
#: and the soak-chaos survival lane on top.
CHAOS_VALIDATORS = 100
#: The block interval: the healthy heights' work (about 200 QC verifies
#: a height through the one shared provider) must fit the round timers
#: (1.5 and 1.0 intervals) with room to spare.
CHAOS_INTERVAL_MS = 6000
CHAOS_THRESHOLD = 8
#: Target heights: the schedule's 7 events and a height of post-fault
#: runway; the 5 legacy draws land on distinct heights in
#: [2, CHAOS_HEIGHTS - 1].
CHAOS_HEIGHTS = 8
#: Heights an adversary stays armed: a cut of the upstream run, whose
#: default, max(2, min(n, 12)), is 12 heights at 100 validators.  A
#: height takes about 12.5 s on the card here, so the initial schedule's
#: window and one soak cycle's would add about 250 s to a phase budgeted
#: at 240 s; 2 still covers the target's turn to lead (it is picked to
#: lead two heights after it is armed, and withholds as soon as it is
#: about to).
CHAOS_BYZ_WINDOW = 2
#: Each recurring soak cycle's schedule spans 4 heights: its 7 events
#: land on 2 heights (the generator reuses heights when the span is
#: short), so a cycle plays out in about 5 heights.
CHAOS_SOAK_S = 100.0
CHAOS_CYCLE_HEIGHTS = 4
CHAOS_SAMPLE_EVERY_S = 2.0
CHAOS_TIMEOUT_S = 120.0
#: The kernels the phase must launch (fq_inv is reported).
CHAOS_KERNELS = ("fq_mul", "g1_add", "g1_dbl", "g2_add", "g2_dbl") + PAIRING
#: /statusz sections the live read must find.
CHAOS_SECTIONS = ("consensus", "crypto", "commits", "trend", "alerts",
                  "fleet", "router", "profile")


def chaos_argv(seed: int, tmp: str) -> list:
    """sim.run's arguments for cell bls100-chaos (files under tmp)."""
    return ["--crypto", "bls", "--device", "cuda",
            "--validators", str(CHAOS_VALIDATORS), "--seed", str(seed),
            "--chaos", "--chaos-adaptive", "1", "--chaos-device-faults", "1",
            "--shared-frontier", "--chaos-tenant-floods", "1",
            "--chaos-byz-window", str(CHAOS_BYZ_WINDOW),
            "--soak-chaos", "--soak-seconds", str(CHAOS_SOAK_S),
            "--sample-every", str(CHAOS_SAMPLE_EVERY_S),
            "--soak-cycle-heights", str(CHAOS_CYCLE_HEIGHTS),
            "--soak-record", os.path.join(tmp, "soak_record.json"),
            "--soak-out", os.path.join(tmp, "soak_samples.jsonl"),
            "--critpath-out", os.path.join(tmp, "critpath.json"),
            "--statusz-port", "0",
            "--interval-ms", str(CHAOS_INTERVAL_MS),
            "--device-threshold", str(CHAOS_THRESHOLD),
            "--heights", str(CHAOS_HEIGHTS),
            "--timeout", str(CHAOS_TIMEOUT_S)]


def _chaos_touched(events) -> set:
    """Heights a chaos event may disturb.  An event fires as its height
    commits, so it first disturbs the next height; it may disturb every
    height of its window (an adversary's `heights`, else one) and the
    height after it."""
    out = set()
    for e in events:
        h = e["fired_height"]
        out.update(range(h + 1, h + max(e.get("heights", 0), 1) + 2))
    return out


def chaos_report(out: dict, net, statusz: dict, launches: dict,
                 wall_s: float, record, critpath: dict,
                 expected_events: int) -> dict:
    """The chaos phase line from sim.run's summary, the live fleet, the
    /statusz read and the launch counts, and the list of the phase's
    failed conditions (empty when it passed)."""
    ch = out.get("chaos", {})
    sc = out.get("soak_chaos", {})
    metrics = out.get("metrics", {})
    transitions = {to: metrics.get(
        f"crypto_breaker_transitions_total{{to={to}}}", 0)
        for to in ("open", "half_open", "closed")}
    floods = list(ch.get("tenant_floods", [])) + [
        f for c in sc.get("cycles", []) for f in c["tenant_floods"]]
    cycles = sc.get("cycles", [])
    complete = [c for c in cycles if c["events_skipped"] == 0
                and c["events_fired"] == expected_events]
    # Every crash that the chain outlived by two heights (the soak loop
    # may end a height after a cycle's last crash): the node must commit
    # a height after its restart.
    final = net.controller.latest_height
    crashes = [(e["node"], e["fired_height"])
               for e in ch.get("events", []) + [
                   e for c in cycles for e in c["events"]]
               if e["kind"] == "crash" and e["fired_height"] + 2 <= final]
    committed = {}
    for node, h, _ in net.controller.commit_log:
        committed[node] = max(committed.get(node, 0), h)
    rejoined = [(i, h, committed.get(net.nodes[i].name, 0) > h)
                for i, h in crashes]
    changes = {}
    for n in net.nodes:
        for h, r, why in n.adapter.view_changes:
            changes.setdefault(h, set()).add(why)
    touched = _chaos_touched(ch.get("events", []) + [
        e for c in cycles for e in c["events"]])
    healthy = [h for h in range(1, final + 1) if h not in touched]
    healthy_changes = sorted(h for h in healthy if h in changes)
    cp = critpath.get("critpath", {})
    shares = cp.get("summary", {}).get("stage_shares", {})
    trace_sums = [sum(t["shares"].values()) for t in cp.get("traces", [])]
    doc = {
        "phase": "chaos", "deployment": "bls100-chaos",
        "validators": out["validators"], "heights": out["heights"],
        "interval_ms": CHAOS_INTERVAL_MS,
        "device_threshold": CHAOS_THRESHOLD,
        "byz_window": CHAOS_BYZ_WINDOW, "soak_seconds": CHAOS_SOAK_S,
        "cycle_heights": CHAOS_CYCLE_HEIGHTS,
        "wall_s": wall_s, "total_s": out["total_s"],
        "runway_s": out["runway_s"],
        "ms_per_height": out["ms_per_height"], "p50_ms": out["p50_ms"],
        "p95_ms": out["p95_ms"],
        "final_height": final,
        "events_fired": ch.get("events_fired"),
        "events_skipped": ch.get("events_skipped"),
        "events": [(e["kind"], e["fired_height"], e["node"])
                   for e in ch.get("events", [])],
        "safety_violations": ch.get("safety_violations"),
        "crashed_rejoined": rejoined,
        "adaptive_switches": out.get("adversary", {}).get(
            "adaptive_switch", 0),
        "frontier_marks": [m["batches_at_disarm"] - m["batches_at_arm"]
                           for m in ch.get("frontier_marks", [])
                           if m["batches_at_disarm"] is not None],
        "breaker_transitions": transitions,
        "shared_breaker": out.get("shared_crypto_status", {}).get("state"),
        "shared_calls": out.get("shared_crypto_status", {}).get("calls"),
        "sheds": out.get("frontier_sheds"),
        "floods": floods,
        "frontier_batches": out.get("frontier_batches"),
        "frontier_mean_lanes": out.get("frontier_mean_batch"),
        "frontier_max_lanes": out.get("frontier_max_batch"),
        "soak": {"cycles": len(cycles), "complete_cycles": len(complete),
                 "cycle_events": [(c["events_fired"], c["events_skipped"])
                                  for c in cycles],
                 "soak_heights": sc.get("soak_heights"),
                 "soak_wall_s": sc.get("soak_wall_s"),
                 "drift_failures": sc.get("drift_failures"),
                 "dims": sc.get("soak", {})},
        "telemetry_samples": out["telemetry"]["samples"],
        "critpath_commits": out["critpath"]["commits"],
        "critpath_shares": shares,
        "critpath_traces": len(trace_sums),
        "record": {"metric": record.metric, "value": record.value,
                   "unit": record.unit} if record is not None else None,
        "view_changes": {h: sorted(w) for h, w in sorted(changes.items())},
        "healthy_heights": healthy,
        "statusz_sections": sorted(statusz),
        "launches": launches,
    }
    bad = []
    if ch.get("safety_violations") or sc.get("soak", {}).get(
            "safety_violations"):
        bad.append("safety violations")
    if ch.get("events_skipped") or ch.get("events_fired") != expected_events:
        bad.append("not every scheduled event fired")
    if not rejoined or not all(ok for _, _, ok in rejoined):
        bad.append("a crashed node never committed after its restart")
    if not doc["adaptive_switches"]:
        bad.append("no adaptive tactic switch")
    if not any(d > 0 for d in doc["frontier_marks"]):
        bad.append("no frontier batch during an armed window")
    if not transitions["open"] or doc["shared_breaker"] != "closed":
        bad.append("the shared breaker did not open and close again")
    if not doc["sheds"] or not floods or any(
            f["sheds"] <= 0 or f["rejected"] != f["sent"] for f in floods):
        bad.append("a flood shed nothing or had a verdict that was not "
                   "False")
    if sc.get("drift_failures") != [] or not complete:
        bad.append("a drift gate failed or no soak cycle completed")
    if out["telemetry"]["samples"] < 5:
        bad.append("fewer than 5 telemetry samples")
    if not trace_sums or any(abs(x - 1.0) > 0.05 for x in
                             trace_sums + [sum(shares.values())]):
        bad.append("critical-path shares do not sum to 1")
    if record is None or record.metric != "soak-chaos-survival":
        bad.append("the soak record does not load")
    if healthy_changes:
        bad.append(f"view changes at healthy heights {healthy_changes}")
    missing = [k for k in CHAOS_SECTIONS if k not in statusz]
    if missing:
        bad.append(f"/statusz lacks {missing}")
    idle = [k for k in CHAOS_KERNELS if not launches.get(k)]
    if idle:
        bad.append(f"never launched {idle}")
    return doc, bad


def chaos_fleet(kernels, seed: int, card: str) -> dict:
    """Cell bls100-chaos: one in-process sim.run of the chaos acceptance
    run on the card (chaos_argv), with the launch counts set to 0 just
    before and read just after, /statusz read once while it runs, then
    the soak record loaded through the port's obs/ledger.py and every
    condition of chaos_report checked."""
    import contextlib
    import tempfile
    import threading
    import urllib.request

    from consensus_overlord_tpu_torch.obs import ledger
    from consensus_overlord_tpu_torch.sim import run as sim_run

    tmp = tempfile.mkdtemp(prefix="chip_smoke_chaos_")
    live = {}

    def read_statusz(net, port):
        t_end = time.monotonic() + 600
        while (net.controller.latest_height < 3
               and time.monotonic() < t_end):
            time.sleep(0.2)
        try:
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{port}/statusz", timeout=30) as r:
                live["statusz"] = json.loads(r.read())
        except Exception as e:  # noqa: BLE001 — reported as a failure
            live["statusz_error"] = repr(e)

    def on_start(net, port):
        live["net"] = net
        live["reader"] = threading.Thread(target=read_statusz,
                                          args=(net, port), daemon=True)
        live["reader"].start()

    log_path = os.path.join(tmp, "sim_run.log")
    kernels.reset_counts()
    t0 = time.perf_counter()
    try:
        with open(log_path, "w") as log, contextlib.redirect_stdout(log):
            out = sim_run.main(chaos_argv(seed, tmp), on_start=on_start)
    except (SystemExit, Exception) as e:  # noqa: BLE001 — reported
        with open(log_path) as f:
            tail = f.read()[-4000:]
        fail(f"chaos: sim.run failed ({type(e).__name__}: {e}); its "
             f"output ended:\n{tail}")
    wall = time.perf_counter() - t0
    launches = kernels.counts()
    live["reader"].join(timeout=30)
    record = ledger.load_record(os.path.join(tmp, "soak_record.json"),
                                run="bls100-chaos")
    with open(os.path.join(tmp, "critpath.json")) as f:
        critpath = json.load(f)
    expected = 2 + 1 + 1 + 1 + 1 + 1  # crashes, stall, partition,
    # device fault, adaptive, tenant flood
    doc, bad = chaos_report(out, live["net"], live.get("statusz", {}),
                            {k: launches[k] for k in CHAOS_KERNELS
                             + ("fq_inv",)}, wall, record, critpath,
                            expected)
    doc["card"] = card
    if "statusz_error" in live:
        bad.append(f"/statusz read failed: {live['statusz_error']}")
    if any(m == "jax" or m.startswith(("jax.", "consensus_overlord_tpu."))
           or m == "consensus_overlord_tpu" for m in sys.modules):
        bad.append("the fleet imported JAX or the JAX package")
    if bad:
        fail(f"chaos: {'; '.join(bad)}: {json.dumps(doc, default=str)}")
    return doc


# -- the mesh (cell bls8192-mesh4) ----------------------------------------------

#: Logical lanes of the mesh phase, all on MESH_DEVICE: the machine has
#: one card.
MESH_LANES = 4
MESH_DEVICE = "cuda:0"
#: Lanes of the mesh phase's ladder walk (the JAX package's walk runs 16).
MESH_LADDER_LANES = 64


def _timed(sync, fn):
    t = time.perf_counter()
    out = fn()
    sync()
    return out, time.perf_counter() - t


def _pairing_cases(oracle, pairing_ops, s0, h0, pks):
    """Pair sets of the provider's shapes, each with the oracle's verdict:
    a signature pair and its hash pair (2 pairs), the same forged, and
    both with an infinity pair on each side and a masked padding lane
    (5 pairs); each padded to a multiple of the mesh's lanes."""
    sig = oracle.g1_mul(oracle.hash_to_g1(h0), s0)
    pk = oracle.g2_decompress(pks[0])
    neg = (oracle.G2_GEN[0], oracle.fq2_neg(oracle.G2_GEN[1]))
    h_pt = oracle.hash_to_g1(h0)
    cases = {}
    for name, s in (("valid", sig), ("invalid", oracle.g1_mul(sig, 7))):
        for extra in ((), ((None, pk), (h_pt, None))):
            pairs = [(s, neg), (h_pt, pk), *extra]
            live = len(pairs) + (1 if extra else 0)  # + a masked pair
            size = -(-live // MESH_LANES) * MESH_LANES
            pad = [None] * (size - len(pairs))
            px, py, pinf = pairing_ops.g1_affine_from_oracle(
                [p for p, _ in pairs] + pad)
            qx, qy, qinf = pairing_ops.g2_affine_from_oracle(
                [q for _, q in pairs] + pad)
            mask = [i < len(pairs) for i in range(size)]
            key = f"{name}{'_inf_pad' if extra else ''}"
            cases[key] = ((px, py, pinf, qx, qy, qinf, mask),
                          oracle.multi_pairing_is_one(pairs))
    return cases


def mesh_functions(torch, prov, mesh, s0, hashes, pks, sigs, sync) -> dict:
    """Each sharded function over the mesh against the single-card
    function on the same inputs at the deployment's size: every strict
    output and validity mask torch.equal, every pairing verdict also the
    oracle's; the two collective-free twins run.  Returns the phase doc
    and the sharded round's outputs (for the NCCL check)."""
    import numpy as np
    from consensus_overlord_tpu_torch.crypto import bls12381 as oracle
    from consensus_overlord_tpu_torch.crypto import cuda_provider as card
    from consensus_overlord_tpu_torch.ops import bls12381_groups as dev
    from consensus_overlord_tpu_torch.ops import pairing as pairing_ops
    from consensus_overlord_tpu_torch.parallel import sharded

    n = len(pks)
    size, *arrays, _ = prov._host_arrays(sigs[0], pks, n)
    ins = [prov._to_dev(a) for a in arrays]
    pk = [t.contiguous() for t in prov._pk_device()]
    hx = [hashes[i % 3] for i in range(n)]
    sx = [sigs[i % 3][i] for i in range(n)]
    _, *marr, _ = prov._host_arrays(sx, pks, n)
    gmask = np.zeros((3, size), bool)
    for g in range(3):
        gmask[g, g:n:3] = True
    multi_ins = [prov._to_dev(a) for a in marr] + [prov._to_dev(gmask)]
    parsed = dev.parse_g2_compressed(pks)
    g2_ins = [prov._to_dev(a) for a in (parsed.x, parsed.sign,
                                        parsed.infinity, parsed.wellformed)]
    g1_ins = ins[:4]
    rows = prov._to_dev(np.arange(n, dtype=np.int64))
    mask = prov._to_dev(np.ones(n, bool))
    bits = dev.unpack_weight_bits(ins[4][:n])
    step_ins = [t[:n] for t in ins[:4]] + [t[:n].contiguous()
                                           for t in pk] + [bits]
    checks = {
        "verify_round": (sharded.sharded_verify_round, card.verify_round,
                         ins + pk),
        "verify_round_multi_k3": (sharded.sharded_verify_round_multi,
                                  card.verify_round_multi,
                                  multi_ins + pk),
        "g2_validate": (sharded.sharded_g2_validate, card.g2_validate,
                        g2_ins),
        "g1_validate_sum": (sharded.sharded_g1_validate_sum,
                            card.g1_validate_sum, g1_ins),
        "g2_sum_rows": (sharded.sharded_g2_sum_rows, card.g2_sum_rows,
                        [rows, mask] + pk),
        "round_step": (sharded.sharded_round_step, sharded.round_step,
                       step_ins),
    }
    doc = {"phase": "mesh_functions", "lanes": MESH_LANES, "votes": n,
           "seconds": {}, "one_card_seconds": {}}
    round_out = step_out = None
    for name, (make, one, args) in checks.items():
        fn = make(mesh)
        want, t_one = _timed(sync, lambda: one(*args))
        got, t_mesh = _timed(sync, lambda: fn(*args))
        if len(got) != len(want) or not all(
                torch.equal(g, w) for g, w in zip(got, want)):
            fail(f"mesh: sharded {name} differs from the single-card "
                 "function")
        doc["seconds"][name] = t_mesh
        doc["one_card_seconds"][name] = t_one
        if name == "verify_round":
            round_out = got
            if not bool(got[3][:n].all()):
                fail("mesh: sharded verify_round rejected a valid vote")
        if name == "round_step":
            step_out = got
    # round_step above is held against itself over one lane; hold it also
    # against single-card functions of other code: with every vote valid
    # and every row live, its RLC sums are verify_round's aggregates (the
    # same weights) and its QC sum and validity g1_validate_sum's.
    qc = card.g1_validate_sum(*g1_ins)
    for what, got, want in (
            ("G1 RLC sum", step_out[0:3], round_out[0:3]),
            ("G2 RLC sum", step_out[3:6], round_out[4:7]),
            ("QC sum", step_out[6:9], qc[0:3]),
            ("validity", step_out[9:], [qc[3][:n]])):
        if not all(torch.equal(g, w) for g, w in zip(got, want)):
            fail(f"mesh: round_step's {what} differs from the single-card "
                 "verify_round/g1_validate_sum")
    verdicts = {}
    pair_fn = sharded.sharded_multi_pairing_is_one(mesh)
    for name, (host, want) in _pairing_cases(
            oracle, pairing_ops, s0, hashes[0], pks).items():
        args = [prov._to_dev(np.asarray(a)) for a in host]
        one = bool(pairing_ops.multi_pairing_is_one_staged(*args))
        got, secs = _timed(sync, lambda: bool(pair_fn(*args)))
        if not got == one == want:
            fail(f"mesh: pairing verdict {name}: mesh {got}, single card "
                 f"{one}, oracle {want}")
        verdicts[name] = got
        doc["seconds"][f"pairing_{name}"] = secs
    doc["pairing_verdicts"] = verdicts
    _, doc["seconds"]["verify_round_local"] = _timed(
        sync, lambda: sharded.sharded_verify_round_local(mesh)(*ins, *pk))
    _, doc["seconds"]["miller_partial_local"] = _timed(
        sync, lambda: sharded.sharded_miller_partial_local(mesh)(*(
            prov._to_dev(np.asarray(a)) for a in _pairing_cases(
                oracle, pairing_ops, s0, hashes[0], pks)["valid"][0])))
    return doc, (ins + pk, round_out)


def mesh_provider(torch, kernels, prov, mesh, s0, hashes, pks, sigs,
                  sync) -> dict:
    """CudaBlsCrypto over the mesh through its entry points, with the
    launch counts set to 0 just before and read just after: every key
    validated on the card, the single-hash and 3-hash rounds (every lane
    True), the bad-lane batches verdict for verdict against
    CpuBlsCrypto, the QC aggregate (byte-equal to the single-card
    provider's, which the qc_aggregate phase holds against CpuBlsCrypto)
    and its verdicts; no host route, no breaker failure, no host
    pairing, and every BLS kernel launched.  Each round is timed beside
    the single-card provider's, in turns."""
    from consensus_overlord_tpu_torch.core.sm3 import sm3_hash
    from consensus_overlord_tpu_torch.crypto.cuda_provider import (
        CudaBlsCrypto)
    from consensus_overlord_tpu_torch.crypto.provider import CpuBlsCrypto

    n = len(pks)
    h0 = hashes[0]
    mp = CudaBlsCrypto(s0, device="cuda", mesh=mesh)
    if mp._kernels.lanes != MESH_LANES:
        fail(f"mesh: the provider runs {mp._kernels.lanes} lanes")
    # The single-card reference aggregate, before the counted window: its
    # launches are not the mesh's.
    agg_one = prov.aggregate_signatures(sigs[0], pks)
    kernels.reset_counts()
    _, t_keys = _timed(sync, lambda: mp.update_pubkeys(pks))
    if mp._pk.aff[:256] != prov._pk.aff[:256] or any(
            mp._pk.index[pk] < 0 for pk in pks):
        fail("mesh: device-validated pubkeys differ from the single card's")
    hx = [hashes[i % 3] for i in range(n)]
    sx = [sigs[i % 3][i] for i in range(n)]
    secs = {"pubkeys": t_keys}
    for rnd, args in (("single_hash_cold", (sigs[0], [h0] * n, pks)),
                      ("single_hash", (sigs[0], [h0] * n, pks)),
                      ("mixed", (sx, hx, pks))):
        got, secs[rnd] = _timed(sync, lambda: mp.verify_batch(*args))
        if got != [True] * n:
            fail(f"mesh: {rnd} rejected {got.count(False)} valid votes")
    batches = bad_lane_batches(s0, hashes, pks, sigs)
    got, secs["bad_lanes"] = _timed(sync, lambda: [mp.verify_batch(*b)
                                                   for b in batches])
    if got != bad_lane_verdicts(CpuBlsCrypto(s0), batches):
        fail("mesh: bad-lane verdicts differ from CpuBlsCrypto")
    agg, secs["qc_aggregate"] = _timed(
        sync, lambda: mp.aggregate_signatures(sigs[0], pks))
    if agg != agg_one:
        fail("mesh: the QC aggregate differs from the single card's")
    verdicts, secs["qc_verify"] = _timed(sync, lambda: [
        mp.verify_aggregated_signature(agg, h, pks)
        for h in (h0, sm3_hash(b"mesh: another block"))])
    if verdicts != [True, False]:
        fail(f"mesh: QC verdicts {verdicts}, wanted [True, False]")
    launches = kernels.counts()
    lanes = {k: kernels.size_buckets(v) for k, v in kernels.sizes().items()
             if v and k in {x.name for x in kernels.BLS_KERNELS}}
    idle = [k.name for k in kernels.BLS_KERNELS if launches[k.name] == 0]
    if idle:
        fail(f"mesh: the mesh path never launched {idle}")
    status = mp.degraded_status()
    # The bad-lane batches' two unseen voters validate on the host (below
    # the QC threshold), as on the single card; every batch is a device
    # call.
    if any(c["host"] for c in status["calls"].values()) or \
            not status["pubkey_updates"]["device"]:
        fail(f"mesh: a call went to the host: {status['calls']}, "
             f"pubkey updates {status['pubkey_updates']}")
    # The warm round in turns: single card, mesh, mesh, single card.
    turns = []
    for p in (prov, mp, mp, prov):
        _, t = _timed(sync, lambda: p.verify_batch(sigs[0], [h0] * n, pks))
        turns.append(t)
    return {"phase": "mesh_provider", "lanes": MESH_LANES, "votes": n,
            "seconds": secs, "warm_round_turns_s": {
                "single_card": [turns[0], turns[3]],
                "mesh": [turns[1], turns[2]]},
            "verifies_per_s": n / min(turns[1], turns[2]),
            "launches": {k.name: launches[k.name]
                         for k in kernels.BLS_KERNELS},
            "launch_lanes": lanes, "calls": status["calls"],
            "pubkey_updates": status["pubkey_updates"],
            **provider_health(mp, "mesh_provider")}, mp


def mesh_ladder(mesh, s0, h0, pks, sigs) -> dict:
    """The ladder walk of the JAX package's mesh resilience test at
    MESH_LADDER_LANES lanes: a lost lane gives a 3-lane sub-mesh that
    dispatches clean while the lane stays lost, an unattributed injected
    fault the single card, clearing them climbs back to the full mesh,
    and a dcn_stall past the dispatch deadline is one injected
    DispatchTimeout; every verdict CpuBlsCrypto's, and the only host
    re-verifies those of the three injected faults (no breaker fallback,
    no host pairing)."""
    from consensus_overlord_tpu_torch.crypto.cuda_provider import (
        CudaBlsCrypto)
    from consensus_overlord_tpu_torch.crypto.provider import CpuBlsCrypto
    from consensus_overlord_tpu_torch.parallel.supervisor import (
        MeshSupervisor)

    n = MESH_LADDER_LANES
    lp = CudaBlsCrypto(s0, device="cuda", mesh=mesh, device_threshold=1,
                       dispatch_deadline_s=2.0)
    sup = MeshSupervisor(lp, step_threshold=1, probe_successes=2,
                         probe_cooldown_s=60.0)
    lp.attach_supervisor(sup)
    lp.update_pubkeys(pks[:n])
    sb, vb = list(sigs[0][:n]), list(pks[:n])
    sb[3], sb[4] = sb[4], sb[3]
    hb = [h0] * n
    want = [CpuBlsCrypto(s0).verify_signature(s, h0, v)
            for s, v in zip(sb, vb)]
    steps = []

    def verify(label):
        t = time.perf_counter()
        got = lp.verify_batch(sb, hb, vb)
        steps.append({"step": label, "rung": sup.rung,
                      "lanes": lp._kernels.lanes,
                      "seconds": time.perf_counter() - t,
                      "device_failures": lp.breaker.total_failures})
        if got != want:
            fail(f"mesh ladder: {label}: verdicts differ from CpuBlsCrypto")

    verify("full_mesh")
    lane = lp.mesh_device_names()[2]
    lp.inject_device_loss(lane, 3600.0)
    verify("lane lost")
    if (sup.rung, sup.quarantined_devices(), lp._kernels.lanes) != (
            "sub_mesh", [lane], MESH_LANES - 1):
        fail(f"mesh ladder: after the loss {sup.statusz()}")
    verify("sub_mesh, lane still lost")
    lp.breaker.inject_faults(0.001, min_faults=1)
    verify("unattributed fault")
    lp.breaker.clear_injected_faults()
    if (sup.rung, lp._kernels.lanes) != ("single_chip", 1):
        fail(f"mesh ladder: after the fault {sup.statusz()}")
    verify("single_chip")
    lp.inject_device_loss(lane, 0.0)
    sup.probe_cooldown_s = 0.0
    for i in range(8):
        verify(f"climb {i}")
        if sup.rung == "full_mesh":
            break
    if (sup.rung, lp._kernels.lanes) != ("full_mesh", MESH_LANES):
        fail(f"mesh ladder: did not climb back: {sup.statusz()}")
    lp.inject_dcn_stall(30.0)
    verify("dcn_stall")
    lp.inject_dcn_stall(0.0)
    reason = lp.breaker.status()["last_failure_reason"]
    if "DispatchTimeout" not in reason or sup.rung != "single_chip":
        fail(f"mesh ladder: the stall gave {reason!r} at {sup.rung}")
    for i in range(8):
        verify(f"climb after the stall {i}")
        if sup.rung == "full_mesh":
            break
    failures = lp.breaker.total_failures
    if (sup.rung != "full_mesh" or failures != 3
            or lp.breaker.total_fallbacks or lp.pairing_host_fallbacks):
        fail(f"mesh ladder: rung {sup.rung}, {failures} device failures "
             f"(3 injected), {lp.breaker.total_fallbacks} breaker "
             f"fallbacks, {lp.pairing_host_fallbacks} host pairings")
    return {"phase": "mesh_ladder", "lanes": n, "steps": steps,
            "transitions": [(t["from"], t["to"], t["reason"])
                            for t in sup.statusz()["recent"]],
            "device_failures": failures}


def mesh_nccl(torch, mesh, inputs, want, s0, h0, pks, sigs) -> dict:
    """sharded_verify_round over a one-rank NCCL group (init_multihost
    against a coordinator on this machine, global_mesh of MESH_LANES
    logical lanes of cuda:0): its combine goes through
    torch.distributed.all_gather, and every output must equal the
    single-process mesh's.  Then CudaBlsCrypto over that group mesh: no
    supervisor may attach, and a round, its route agreed by the group
    (an all_reduce), runs on the device with every vote True."""
    import socket

    import torch.distributed as dist
    from consensus_overlord_tpu_torch.crypto.cuda_provider import (
        CudaBlsCrypto)
    from consensus_overlord_tpu_torch.parallel import (
        global_mesh, host_shard_array, init_multihost, sharded_verify_round)

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    t = time.perf_counter()
    backend = "nccl" if mesh.home.type == "cuda" else "gloo"
    if not init_multihost(f"127.0.0.1:{port}", 1, 0, backend=backend,
                          timeout_s=120.0):
        fail("mesh: init_multihost did not join the group")
    try:
        gmesh = global_mesh(MESH_LANES, device=mesh.home)
        if gmesh.group is None or gmesh.size != MESH_LANES:
            fail(f"mesh: global_mesh is {gmesh}")
        args = [host_shard_array(gmesh, a) if i < 6 else a
                for i, a in enumerate(inputs)]
        got = sharded_verify_round(gmesh)(*args)
        if mesh.home.type == "cuda":
            torch.cuda.synchronize()
        if not all(torch.equal(g, w) for g, w in zip(got, want)):
            fail("mesh: the NCCL group's round differs from the "
                 "single-process mesh's")
        backend = dist.get_backend()
        t_round = time.perf_counter() - t
        gp = CudaBlsCrypto(s0, device="cuda", mesh=gmesh)
        try:
            gp.attach_supervisor(None)
            fail("mesh: a supervisor attached to a mesh across processes")
        except ValueError:
            pass
        gp.update_pubkeys(pks)
        n = len(pks)
        if gp.verify_batch(sigs[0], [h0] * n, pks) != [True] * n:
            fail("mesh: the group provider rejected a valid vote")
        calls = gp.degraded_status()["calls"]["verify_batch"]
        if calls != {"device": 1, "host": 0}:
            fail(f"mesh: the group provider's round ran {calls}")
    finally:
        dist.destroy_process_group()
    return {"phase": "mesh_nccl", "backend": backend, "world": 1,
            "lanes": MESH_LANES, "seconds": t_round,
            "provider_seconds": time.perf_counter() - t - t_round,
            **provider_health(gp, "mesh_nccl")}


def mesh_phase(torch, kernels, prov, s0, hashes, pks, sigs, smi) -> None:
    """Cell bls8192-mesh4: the main path over MESH_LANES logical lanes of
    the one card (mesh_functions, mesh_provider, mesh_ladder, the staged
    probe, mesh_nccl), one JSON line each."""
    from consensus_overlord_tpu_torch.obs.prof import DeviceProfiler
    from consensus_overlord_tpu_torch.parallel import sharded

    sync = torch.cuda.synchronize
    t0 = time.perf_counter()
    mesh = sharded.Mesh([torch.device(MESH_DEVICE)] * MESH_LANES)
    doc, (inputs, round_out) = mesh_functions(torch, prov, mesh, s0, hashes,
                                              pks, sigs, sync)
    emit({**doc, "card": smi})
    doc, mp = mesh_provider(torch, kernels, prov, mesh, s0, hashes, pks,
                            sigs, sync)
    emit({**doc, "card": smi})
    emit({**mesh_ladder(mesh, s0, hashes[0], pks, sigs), "card": smi})
    prof = DeviceProfiler()
    mp.bind_profiler(prof)
    probe = mp.profile_sharded_stages(sigs[0], pks)
    emit({"phase": "mesh_profile", "card": smi, **probe,
          "sharded": prof.summary().get("sharded")})
    emit({**mesh_nccl(torch, mesh, inputs, round_out, s0, hashes[0], pks,
                      sigs), "card": smi,
          "phase_seconds": time.perf_counter() - t0})


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
    idle = [k for k in ("fq_mul", "g1_add", "fq_inv") if launches[k] == 0]
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
        idle = [k for k in ("fq_mul", "g2_add", "miller_product",
                            "final_exp", "fq_inv") if c["launches"][k] == 0]
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



def bad_lane_batches(s0, hashes, pks, sigs):
    """A 64-lane single-hash batch and a 96-lane 3-hash batch, each
    (signatures, hashes, voters), carrying wrong signers, malformed
    encodings, an infinity signature, undecodable and unknown voters,
    another hash's signature and order-3 components."""
    from consensus_overlord_tpu_torch.crypto import bls12381 as oracle
    from consensus_overlord_tpu_torch.crypto.provider import CpuBlsCrypto

    h0 = hashes[0]
    outsider = CpuBlsCrypto(s0 + len(pks) + 12345)
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
    return (sb, [h0] * 64, vb), (sm, hm, vm)


def bad_lane_verdicts(cpu, batches):
    """CpuBlsCrypto's verdicts on bad_lane_batches."""
    return [[cpu.verify_signature(s, h, v) for s, h, v in zip(*b)]
            for b in batches]


def drive_main_path(prov, s0, hashes, pks, sigs, sync):
    """The main path through the provider's entry points, one JSON line
    per phase; returns each phase's kernel launches, its launches by lane
    count, and its seconds."""
    from consensus_overlord_tpu_torch.crypto import bls12381 as oracle
    from consensus_overlord_tpu_torch.crypto.provider import CpuBlsCrypto
    from consensus_overlord_tpu_torch.ops import kernels

    n = len(pks)
    phase_counts, phase_sizes, phase_secs = {}, {}, {}

    def phase(name, fn):
        before, sizes0 = kernels.counts(), kernels.sizes()
        t = time.perf_counter()
        out = fn()
        sync()
        secs = phase_secs[name] = time.perf_counter() - t
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
                               phase_sizes[rnd].items() if v},
              **provider_health(prov, rnd)})

    # Bad lanes, verdict for verdict against the host oracle provider.
    cpu = CpuBlsCrypto(s0)
    batches = bad_lane_batches(s0, hashes, pks, sigs)
    (got_s, got_m), secs = phase("bad_lanes", lambda: tuple(
        prov.verify_batch(*b) for b in batches))
    if [got_s, got_m] != bad_lane_verdicts(cpu, batches):
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

    return phase_counts, phase_sizes, phase_secs


def g2_tables(torch, kernels, s0, hashes, pks, sigs, ladder) -> dict:
    """The G2 table MSM (CudaBlsCrypto(g2_table_msm=True)) over the main
    path's validators: update_pubkeys with the table build (seconds, the
    tables' bytes, the peak of device memory), then warm single-hash and
    3-hash verify_batch (every lane True, each verdict the ladder
    provider's), and the bad-lane batches against CpuBlsCrypto.  Launch
    counts are set to 0 just before each call and read just after.
    `ladder` carries the main path's launches and seconds of the same
    calls.  Any mismatch, fallback or open breaker fails the run.
    Returns the phase line and the exact lanes per launch of the build
    and of each warm call."""
    from consensus_overlord_tpu_torch.crypto.cuda_provider import (
        CudaBlsCrypto)
    from consensus_overlord_tpu_torch.crypto.provider import CpuBlsCrypto

    n = len(pks)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    prov = CudaBlsCrypto(s0, device="cuda", g2_table_msm=True)

    def timed(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t

    (_, build_s), build_launches, build_lanes = _launches_of(
        kernels, lambda: timed(lambda: prov.update_pubkeys(pks)))
    exact = {"build": kernels.sizes()}
    if prov._pk_tab is None:
        fail("g2_tables: update_pubkeys built no tables")
    tab_bytes = sum(t.numel() * t.element_size() for t in prov._pk_tab)
    peak = torch.cuda.max_memory_allocated()
    h0 = hashes[0]
    hx = [hashes[i % 3] for i in range(n)]
    sx = [sigs[i % 3][i] for i in range(n)]
    calls = {}
    for name, args in (("single_hash", (sigs[0], [h0] * n, pks)),
                       ("mixed", (sx, hx, pks))):
        if prov.verify_batch(*args) != [True] * n:  # cold: first use
            fail(f"g2_tables {name}: valid votes rejected (cold)")
        (got, secs), launches, lanes = _launches_of(
            kernels, lambda: timed(lambda: prov.verify_batch(*args)))
        exact[name] = kernels.sizes()
        if got != [True] * n:
            fail(f"g2_tables {name}: {got.count(False)} valid votes "
                 "rejected")
        idle = [k for k in ("fq_mul", "g1_add", "g1_dbl", "g2_add",
                            "miller_product", "final_exp", "fq_inv")
                if not launches[k]]
        if idle or launches["g2_dbl"]:
            fail(f"g2_tables {name}: idle {idle}, or the G2 ladder ran "
                 f"({launches['g2_dbl']} g2_dbl launches)")
        calls[name] = {"seconds": secs, "verifies_per_s": n / secs,
                       "launches": {k: v for k, v in launches.items() if v},
                       "launch_lanes": lanes,
                       "ladder_seconds": ladder["seconds"][name],
                       "ladder_launches": {
                           k: v for k, v in ladder["launches"][name].items()
                           if v}}
    # The bad batches carry voters the cache has not seen: validating
    # them changes the cache, which rebuilds the tables (the build's
    # doublings run over the cache's rows; a ladder's would run over a
    # batch's lanes).
    batches = bad_lane_batches(s0, hashes, pks, sigs)
    rows = int(prov._pk_tab[0].shape[0])
    (got, bad_s), bad_launches, _ = _launches_of(
        kernels, lambda: timed(lambda: [prov.verify_batch(*b)
                                        for b in batches]))
    ladder_dbl = {b: c for b, c in kernels.sizes()["g2_dbl"].items()
                  if b != rows}
    if got != bad_lane_verdicts(CpuBlsCrypto(s0), batches):
        fail("g2_tables: bad-lane verdicts differ from CpuBlsCrypto")
    if ladder_dbl or not bad_launches["g2_add"]:
        fail(f"g2_tables bad_lanes did not take the table path: g2_dbl "
             f"launches by lanes {ladder_dbl}")
    status = prov.degraded_status()
    if not status["g2_table_msm"] or status["calls"]["verify_batch"]["host"]:
        fail(f"g2_tables: a batch left the table path: {status}")
    doc = {"phase": "g2_tables", "validators": n,
           "cache_rows": int(prov._pk_tab[0].shape[0]),
           "update_pubkeys_s": build_s, "build_launches": {
               k: v for k, v in build_launches.items() if v},
           "build_launch_lanes": build_lanes,
           "table_bytes": tab_bytes,
           "max_memory_allocated": peak,
           "memory_before": base, "calls": calls,
           "bad_lanes": {"lanes": [len(b[0]) for b in batches],
                         "seconds": bad_s,
                         "rebuild_g2_dbl": kernels.sizes()["g2_dbl"].get(
                             rows, 0),
                         "rejected": [g.count(False) for g in got]},
           **provider_health(prov, "g2_tables")}
    del prov
    torch.cuda.empty_cache()
    return doc, exact


# -- the Ed25519, secp256k1 and SM2 paths -------------------------------------------

#: Lanes of one batch per scheme (PERF.md §4): ed25519-8192 and sm2-8192
#: are BASELINE.json config 5's 10k validators cut to the pad ladder's
#: top rung, secp256k1-1024 config 3's 1k validators.
CURVE_LANES = {"ed25519": 8192, "secp256k1": 1024, "sm2": 8192}
#: The kernels each scheme's verify path launches.
CURVE_KERNELS = {"ed25519": ("fq_mul_ed25519", "ed_add", "ed_ladder"),
                 "secp256k1": ("fq_mul_secp256k1", "secp_add", "secp_dbl"),
                 "sm2": ("fq_mul_sm2", "wp_add_general", "wp_dual_ladder")}
#: The ladders' scalar bits on the verify paths.
LADDER_BITS = 256
#: Lanes at which each ladder is held against its plain version (the
#: plain ladder is 384–512 plain adds, so it runs once).
LADDER_PLAIN_LANES = 1024
#: Lanes of each scheme's adversarial batch.
CURVE_BAD_LANES = 64


def curve_provider(scheme: str, key, **kw):
    """The scheme's provider of the port for one key (an Ed25519 seed or
    an ECDSA scalar)."""
    if scheme == "ed25519":
        from consensus_overlord_tpu_torch.crypto.ed25519_cuda import (
            Ed25519CudaCrypto)
        return Ed25519CudaCrypto(key, **kw)
    from consensus_overlord_tpu_torch.crypto.ecdsa_cuda import (
        Secp256k1Crypto, Sm2Crypto)
    cls = Secp256k1Crypto if scheme == "secp256k1" else Sm2Crypto
    return cls(key, **kw)


def curve_fixtures(seed: int, scheme: str, lanes: int):
    """Keys of `lanes` validators (Ed25519 seeds, or ECDSA scalars, from
    SHA-256 of the seed), their public keys and their signatures on one
    vote hash, made on the host and cached by (scheme, seed, lanes)."""
    import numpy as np
    from consensus_overlord_tpu_torch.core.sm3 import sm3_hash

    h = sm3_hash(f"chip_smoke:{seed}:{scheme}:vote".encode())
    keys = [hashlib.sha256(f"chip_smoke:{seed}:{scheme}:{i}".encode())
            .digest() for i in range(lanes)]
    if scheme != "ed25519":
        keys = [int.from_bytes(k, "big") for k in keys]
    path = os.path.join(FIXTURE_DIR, f"{scheme}_{seed}_{lanes}.npz")
    if os.path.exists(path):
        z = np.load(path)
        return keys, h, [bytes(r) for r in z["pks"]], [bytes(r) for r in
                                                        z["sigs"]]
    pks, sigs = [], []
    for k in keys:
        p = curve_provider(scheme, k, device="cpu")
        pks.append(p.pub_key)
        sigs.append(p.sign(h))
    os.makedirs(FIXTURE_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.npz"
    np.savez(tmp, pks=np.frombuffer(b"".join(pks), np.uint8).reshape(
        lanes, -1), sigs=np.frombuffer(b"".join(sigs), np.uint8).reshape(
            lanes, -1))
    os.replace(tmp, path)
    return keys, h, pks, sigs


def _ed_torsion8():
    """A point of order 8 of edwards25519 (extended ints): [L]·P."""
    from consensus_overlord_tpu_torch.ops import edwards as ed
    for y in range(3, 200):
        x = ed._xrecover(y, 0)
        if x is None:
            continue
        t = ed._ext_mul_ext(ed._ext_of((x, y)), ed.L)
        four = ed._ext_mul_ext(t, 4)
        if (four[1] + four[2]) % ed.P == 0:  # [4]T = (0, −1)
            return t
    fail("no order-8 point of edwards25519")


def curve_bad_batch(scheme: str, keys, h, pks, sigs):
    """CURVE_BAD_LANES lanes of valid votes with adversarial lanes: a
    wrong signer, a signature on another hash and an undecodable voter in
    every scheme; for Ed25519 s ≥ L, R with y ≥ p, an undecodable R and
    small-torsion components in R and in A (both accepted by the
    cofactored rule); for secp256k1 r = 0 and a high s; for SM2 r = 0
    and r + s ≡ 0 (mod n)."""
    n = CURVE_BAD_LANES
    sb, vb = list(sigs[:n]), list(pks[:n])
    sb[3], sb[4] = sb[4], sb[3]                              # wrong signers
    sb[9] = curve_provider(scheme, keys[9], device="cpu").sign(
        hashlib.sha256(b"another block").digest())           # another hash
    if scheme == "ed25519":
        from consensus_overlord_tpu_torch.ops import edwards as ed
        vb[13] = (2).to_bytes(32, "little")                  # undecodable A
        s = int.from_bytes(sb[17][32:], "little")
        sb[17] = sb[17][:32] + (s + ed.L).to_bytes(32, "little")  # s >= L
        sb[21] = (ed.P + 3).to_bytes(32, "little") + sb[21][32:]  # y >= p
        sb[25] = (2).to_bytes(32, "little") + sb[25][32:]    # undecodable R
        t = _ed_torsion8()

        def sign_with(i, r, r_pt, pk):
            r_enc = ed._encode_point(ed._affine(r_pt))
            k = int.from_bytes(hashlib.sha512(r_enc + pk + h).digest(),
                               "little") % ed.L
            a = ed._expand_seed(keys[i])[0]
            return r_enc + ((r + k * a) % ed.L).to_bytes(32, "little")

        sb[29] = sign_with(29, 4242, ed._ext_add(ed._base_mul(4242), t),
                           vb[29])                           # torsion in R
        vb[33] = ed._encode_point(ed._affine(ed._ext_add(
            ed._base_mul(ed._expand_seed(keys[33])[0]), t)))
        sb[33] = sign_with(33, 777, ed._base_mul(777), vb[33])  # ... in A
    else:
        from consensus_overlord_tpu_torch.crypto import ecdsa_cuda
        order = (ecdsa_cuda.SECP_HOST if scheme == "secp256k1"
                 else ecdsa_cuda.SM2_HOST).n
        vb[13] = b"\x02" + bytes(32)                         # undecodable
        sb[17] = bytes(32) + sb[17][32:]                     # r = 0
        r = int.from_bytes(sb[21][:32], "big")
        s = int.from_bytes(sb[21][32:], "big")
        bad = order - s if scheme == "secp256k1" else order - r
        sb[21] = sb[21][:32] + bad.to_bytes(32, "big")       # high s / r+s=0
    return sb, vb


def curve_lane_ops(spec) -> dict:
    """int32 instructions per lane of the 26-limb fields' kernels, by
    pipe: the field product and secp256k1's a = 0 group law (g1_point.cu
    built with 3b = 21) from the least they need in 8 words (word_ops);
    the Edwards and general-a kernels (csrc/ed_point.cu, wp_point.cu) from
    their field ops over 10-bit limbs."""
    from consensus_overlord_tpu_torch.ops import kernels

    f = field_ops(spec)
    name = spec.name
    if name == "F_ed25519":
        ed_add = _ops((9, f["mul"]), (5, f["add"]), (4, f["sub"]))
        # Per bit two adds and a select of four coordinates.
        select = {"imad": 0, "alu": 0, "either": 4 * spec.n}
        return {"fq_mul_ed25519": word_ops(spec, "mul"), "ed_add": ed_add,
                "ed_ladder": _ops((2 * LADDER_BITS, ed_add),
                                  (LADDER_BITS, select))}
    if name == "secp256k1_fq":
        return {"fq_mul_secp256k1": word_ops(spec, "mul"),
                "secp_add": word_ops(spec, "add"),
                "secp_dbl": word_ops(spec, "dbl")}
    wp_add = _ops((14, f["mul"]), (15, f["add"]), (6, f["sub"]),
                  (4, f["small3"]), (3, f["neg"]))
    # Per window LADDER_WINDOW doublings and two table adds.
    window = kernels.LADDER_WINDOW
    return {"fq_mul_sm2": word_ops(spec, "mul"), "wp_add_general": wp_add,
            "wp_dual_ladder": _ops(((window + 2) * (LADDER_BITS // window),
                                    wp_add))}


def curve_phase(torch, kernels, scheme: str, seed: int) -> dict:
    """One scheme's verify path at its deployment size through the
    provider's entry points: a cold and a warm verify_batch of every
    validator's vote (all must pass; the warm one with the launch counts
    set to 0 just before and read just after, then once more under
    torch.profiler for the device-busy split), the adversarial batch
    verdict for verdict against the port's host rule, and for the ECDSA
    schemes one QC of every vote through verify_aggregated_signature."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    lanes = CURVE_LANES[scheme]
    t0 = time.perf_counter()
    keys, h, pks, sigs = curve_fixtures(seed, scheme, lanes)
    out = {"phase": scheme, "lanes": lanes,
           "fixture_s": time.perf_counter() - t0}
    prov = curve_provider(scheme, keys[0], device="cuda")
    hs = [h] * lanes

    def timed(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        got = fn()
        torch.cuda.synchronize()
        return got, time.perf_counter() - t

    got, out["cold_s"] = timed(lambda: prov.verify_batch(sigs, hs, pks))
    if got != [True] * lanes:
        fail(f"{scheme}: {got.count(False)} valid votes rejected (cold)")
    kernels.reset_counts()
    got, out["warm_s"] = timed(lambda: prov.verify_batch(sigs, hs, pks))
    out["launches"] = {k: kernels.counts()[k] for k in CURVE_KERNELS[scheme]}
    out["launch_lanes"] = {k: kernels.size_buckets(v) for k, v in
                           kernels.sizes().items() if v}
    sizes = {k: dict(v) for k, v in kernels.sizes().items() if v}
    if got != [True] * lanes:
        fail(f"{scheme}: {got.count(False)} valid votes rejected (warm)")
    out["verifies_per_s"] = lanes / out["warm_s"]
    idle = [k for k, c in out["launches"].items() if not c]
    if idle:
        fail(f"{scheme}: the verify path never launched {idle}")
    with profile(activities=[ProfilerActivity.CUDA]) as trace:
        got, wall = timed(lambda: prov.verify_batch(sigs, hs, pks))
    kern = [e for e in trace.key_averages() if e.device_type ==
            DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kern) / 1e6
    out["profiled"] = {
        "wall_s": wall, "device_busy_s": busy,
        "device_idle_share": 1 - busy / wall,
        "kernel_launches": sum(e.count for e in kern),
        "top_kernels": [{"name": e.key[:48], "calls": e.count,
                         "ms": e.self_device_time_total / 1e3}
                        for e in sorted(kern, key=lambda e:
                                        -e.self_device_time_total)[:6]]}

    sb, vb = curve_bad_batch(scheme, keys, h, pks, sigs)
    kernels.reset_counts()
    got, out["bad_s"] = timed(lambda: prov.verify_batch(
        sb, [h] * len(sb), vb))
    out["bad_launches"] = {k: kernels.counts()[k]
                           for k in CURVE_KERNELS[scheme]}
    want = [prov.verify_signature(s, h, v) for s, v in zip(sb, vb)]
    if got != want:
        fail(f"{scheme}: bad-lane verdicts differ from the host rule: "
             f"{[i for i, (a, b) in enumerate(zip(got, want)) if a != b]}")
    out["bad_rejected"] = [i for i, v in enumerate(want) if not v]
    if scheme != "ed25519":
        agg = prov.aggregate_signatures(sigs, pks)
        kernels.reset_counts()
        ok, out["qc_verify_s"] = timed(
            lambda: prov.verify_aggregated_signature(agg, h, pks))
        out["qc_launches"] = {k: kernels.counts()[k]
                              for k in CURVE_KERNELS[scheme]}
        if ok is not True or not all(out["qc_launches"].values()):
            fail(f"{scheme}: the QC did not verify on the card: {out}")
    out["calls"] = prov.degraded_status()["calls"]
    return out, sizes


def time_once(torch, fn) -> float:
    """Device-clock ms of one call of fn (CUDA events around it; the
    host's issue inside the call counts): for the plain ladders and the
    step-by-step routes, hundreds of launches a call."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop)


def ladder_cases(torch, name: str, lanes: int, gen):
    """A ladder kernel's cases on seeded inputs (loose limbs, a row of
    each at the loose bound; random 256-bit scalars): its run at `lanes`
    with the step-by-step route there (one point-kernel launch an add),
    and its run on the first LADDER_PLAIN_LANES lanes with the plain
    ladder there.  Returns (spec, run, steps, run_m, plain, bytes)."""
    from consensus_overlord_tpu_torch.ops import edwards as ed
    from consensus_overlord_tpu_torch.ops import kernels
    from consensus_overlord_tpu_torch.ops import weierstrass as w
    from consensus_overlord_tpu_torch.ops.curve import Point

    spec = ed.FE if name == "ed_ladder" else w.FQ_SM2
    m = LADDER_PLAIN_LANES
    window, rows = kernels.LADDER_WINDOW, kernels.LADDER_TABLE
    windows = LADDER_BITS // window

    def limbs(k):
        t = torch.randint(0, spec.loose_max + 1, (k, lanes, spec.n),
                          dtype=torch.int32, device="cuda", generator=gen)
        t[:, :7] = spec.loose_max
        return list(t)

    def scalar_bits():
        return torch.randint(0, 2, (lanes, LADDER_BITS), dtype=torch.int32,
                             device="cuda", generator=gen)

    if name == "ed_ladder":
        p, bits = ed.EdPoint(*limbs(4)), scalar_bits()
        packed = ed.pack_bits(bits)
        pm = ed.EdPoint(*(c[:m] for c in p))
        return (spec, lambda: ed.ladder(p, packed, LADDER_BITS),
                lambda: ed.scalar_mul_steps(p, bits),
                lambda: ed.ladder(pm, packed[:m], LADDER_BITS),
                lambda: ed.ladder_plain(pm, packed[:m], LADDER_BITS),
                lanes * (8 * spec.n * 4 + LADDER_BITS // 8))
    g = w.SM2.from_affine(spec.constant(w.SM2_GX, "cuda")[None],
                          spec.constant(w.SM2_GY, "cuda")[None])
    tg, tq = w._tables(w.SM2, g, Point(*limbs(3)), window)
    dg, dq = (w._window_digits(scalar_bits(), window) for _ in range(2))
    packed = w.pack_digits(dg, dq)
    tqm = Point(*(c[:, :m].contiguous() for c in tq))
    row = 3 * spec.n * 4
    return (spec, lambda: w.dual_ladder(tg, tq, packed, windows),
            lambda: w._dual_steps(w.SM2, tg, tq, dg, dq, window, w.SM2.add,
                                  w.SM2.dbl),
            lambda: w.dual_ladder(tg, tqm, packed[:m], windows),
            lambda: w.dual_ladder_plain(tg, tqm, packed[:m], windows),
            lanes * (windows * (row + 1) + row) + rows * row)


def _equal(torch, got, want) -> bool:
    return all(torch.equal(a, b) for a, b in zip(got, want))


def curve_kernel_checks(torch, kernels, sizes: dict, launches: dict,
                        card: dict, seed: int, ptxas: dict):
    """Each kernel of the three schemes vs its plain version on the card
    (tolerance 0, torch.equal) on seeded loose limbs, timed beside its
    bound at the launch size that carried the most lanes on its phase's
    warm path (lanes × launches), with its registers, spills and resident
    warps.  A ladder is held to the step-by-step route at that lane
    count and to its plain version at LADDER_PLAIN_LANES (the plain
    ladder and the route timed once)."""
    from consensus_overlord_tpu_torch.ops import edwards as ed
    from consensus_overlord_tpu_torch.ops import weierstrass as w
    from consensus_overlord_tpu_torch.ops.curve import Point

    gen = torch.Generator(device="cuda").manual_seed(seed)
    rows, phase = [], {"phase": "curve_kernels", "kernels": []}
    fns = {"fq_mul": "fq_mul_kernel", "ed_add": "ed_add_kernel",
           "ed_ladder": "ed_ladder_kernel", "secp_add": "g1_add_kernel",
           "secp_dbl": "g1_dbl_kernel",
           "wp_add_general": "wp_add_general_kernel",
           "wp_dual_ladder": "wp_dual_ladder_kernel"}
    for spec in (ed.FE, w.FQ_SECP, w.FQ_SM2):
        ops = curve_lane_ops(spec)

        def limbs(lanes, k):
            t = torch.randint(0, spec.loose_max + 1, (k, lanes, spec.n),
                              dtype=torch.int32, device="cuda",
                              generator=gen)
            t[:, :7] = spec.loose_max
            return list(t)

        for name, lane_ops_ in ops.items():
            by = sizes[name]
            lanes = max(by, key=lambda b: (b * by[b], b))
            extra = {}
            if name.endswith("ladder"):
                _, run, steps, run_m, plain, nbytes = ladder_cases(
                    torch, name, lanes, gen)
                got, want = run(), steps()
                if not _equal(torch, got, want):
                    fail(f"{name} differs from the step-by-step route at "
                         f"B = {lanes}")
                got_m, want_m = run_m(), plain()
                if not (_equal(torch, got_m, want_m) and _equal(
                        torch, got_m, (c[:LADDER_PLAIN_LANES] for c in got))):
                    fail(f"{name} differs from its plain version at B = "
                         f"{LADDER_PLAIN_LANES}")
                err = max(int((a.long() - b.long()).abs().max())
                          for a, b in zip(got_m, want_m))
                ms = time_ms(torch, run, 10, card["clock_hz"])
                plain_ms = time_once(torch, plain)
                plain_lanes = LADDER_PLAIN_LANES
                extra = {"steps_ms": time_once(torch, steps)}
            else:
                c = limbs(lanes, 8)
                if name.startswith("fq_mul"):
                    run, plain = (lambda: spec.mul(c[0], c[1]),
                                  lambda: spec.mul_plain(c[0], c[1]))
                    coords = 3
                elif name == "ed_add":
                    p, q = ed.EdPoint(*c[:4]), ed.EdPoint(*c[4:])
                    run, plain = (lambda: ed.add(p, q),
                                  lambda: ed.add_plain(p, q))
                    coords = 12
                elif name == "secp_dbl":
                    p = Point(*c[:3])
                    run, plain = (lambda: w.SECP.dbl(p),
                                  lambda: w.SECP.dbl_plain(p))
                    coords = 6
                else:
                    ops_ = w.SECP if name == "secp_add" else w.SM2
                    p, q = Point(*c[:3]), Point(*c[3:6])
                    run, plain = (lambda: ops_.add(p, q),
                                  lambda: ops_.add_plain(p, q))
                    coords = 9
                got, want = run(), plain()
                got = got if isinstance(got, tuple) else (got,)
                want = want if isinstance(want, tuple) else (want,)
                if not _equal(torch, got, want):
                    fail(f"{name} differs from its plain version at B = "
                         f"{lanes}")
                err = max(int((a.long() - b.long()).abs().max())
                          for a, b in zip(got, want))
                nbytes = coords * spec.n * 4 * lanes
                ms = time_ms(torch, run, 100, card["clock_hz"])
                plain_ms = time_ms(torch, plain, 10, card["clock_hz"])
                plain_lanes = lanes
            bound_ms, bound_by = bound(lane_ops_, lanes, nbytes,
                                       card["clock_hz"])
            k = {kk.name: kk for kk in kernels.KERNELS}[name]
            fn = fns["fq_mul" if name.startswith("fq_mul") else name]
            regs = ptxas[spec.name].get(fn, {})
            if regs.get("spill_stores", 1) or regs.get("spill_loads", 1):
                fail(f"{name}: spills or missing from the ptxas report")
            row = {"name": name, "route": k.route, "source": k.source,
                   "replaces": k.replaces, "launches": launches[name],
                   "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                   "bound_ms": bound_ms, "bound_by": bound_by,
                   "time_over_bound": ms / bound_ms,
                   "library_ms": None, "lanes": lanes,
                   "plain_lanes": plain_lanes}
            rows.append(row)
            warps = (kernels.resident_warps(name, spec,
                                            torch.device("cuda"))
                     if name in kernels._OCCUPANCY else None)
            phase["kernels"].append({**row,
                                     "registers": regs.get("registers"),
                                     "spill_stores": regs["spill_stores"],
                                     "resident_warps": warps, **extra})
    return rows, phase


#: Deployments ed25519-16-sim, secp256k1-16-sim and sm2-16-sim: sim.run's
#: own factory for each scheme (crypto_factory), 16 validators, device
#: and QC threshold 2, one warm height and CURVES_SIM_HEIGHTS measured.
CURVES_SIM_VALIDATORS = 16
CURVES_SIM_HEIGHTS = 2
CURVES_SIM_INTERVAL_MS = 5000
CURVES_SIM_TIMEOUT_S = 120.0


def curves_sim(torch, kernels, seed: int) -> dict:
    """A fleet of each scheme's providers, as sim.run --crypto <scheme>
    builds it (the breaker-less providers in SimDeviceCrypto, the
    frontier on): every height must commit, each scheme must make device
    calls and launch its kernels in the measured heights, with no device
    fault, re-verify or breaker failure, and every committed proof must
    pass the scheme's host rule."""
    import asyncio

    from consensus_overlord_tpu_torch.core.bitmap import extract_voters
    from consensus_overlord_tpu_torch.core.sm3 import sm3_hash
    from consensus_overlord_tpu_torch.core.types import (
        Proof, Vote, VoteType)
    from consensus_overlord_tpu_torch.sim import SimNetwork
    from consensus_overlord_tpu_torch.sim import run as sim_run

    out = {"phase": "curves_sim", "validators": CURVES_SIM_VALIDATORS,
           "warm_heights": 1, "heights": CURVES_SIM_HEIGHTS,
           "interval_ms": CURVES_SIM_INTERVAL_MS, "device_threshold": 2,
           "schemes": {}}
    t_all = time.perf_counter()
    for scheme in CURVE_KERNELS:
        args = sim_run.make_parser().parse_args(
            ["--crypto", scheme, "--validators",
             str(CURVES_SIM_VALIDATORS), "--device-threshold", "2"])
        factory = sim_run.crypto_factory(args)

        async def drive():
            t0 = time.perf_counter()
            net = SimNetwork(
                n_validators=CURVES_SIM_VALIDATORS,
                block_interval_ms=CURVES_SIM_INTERVAL_MS, seed=seed,
                use_frontier=True, frontier_linger_s=0.002,
                crypto_factory=factory, sim_device_crypto=True,
                flight_recorder_capacity=256)
            doc = {"setup_s": time.perf_counter() - t0}
            net.start(init_height=1)
            want = 1
            try:
                t0 = time.perf_counter()
                await net.run_until_height(1, CURVES_SIM_TIMEOUT_S)
                doc["warm_s"] = time.perf_counter() - t0
                before = _fleet_totals(net)
                kernels.reset_counts()
                t0 = last = time.perf_counter()
                doc["height_ms"] = []
                for want in range(2, CURVES_SIM_HEIGHTS + 2):
                    await net.run_until_height(want, CURVES_SIM_TIMEOUT_S)
                    now = time.perf_counter()
                    doc["height_ms"].append((now - last) * 1e3)
                    last = now
                doc["total_s"] = last - t0
                doc["launches"] = {k: kernels.counts()[k]
                                   for k in CURVE_KERNELS[scheme]}
                after = _fleet_totals(net)
            except asyncio.TimeoutError:
                print(net.dump_flight_recorders(16), file=sys.stderr)
                fail(f"curves_sim {scheme}: stuck at height "
                     f"{net.controller.latest_height}, wanted {want}")
            finally:
                await net.stop()
            return net, doc, before, after

        net, doc, before, after = asyncio.run(drive())
        calls = {w: after["status"]["calls"]["verify_batch"][w]
                 - before["status"]["calls"]["verify_batch"][w]
                 for w in ("device", "host")}
        doc.update(device_calls=calls["device"], host_calls=calls["host"],
                   device_faults=after["device_faults"],
                   reverified=after["reverified"],
                   breaker_failures=after["status"]["total_failures"],
                   view_changes=len(after["view_changes"]))
        # Audit: every committed proof under the scheme's host rule.
        ctl = net.controller
        auditor = curve_provider(scheme, bytes(32) if scheme == "ed25519"
                                 else 1, device="cpu",
                                 device_threshold=10**9)
        for hgt in range(1, CURVES_SIM_HEIGHTS + 2):
            proof = Proof.decode(ctl.proofs[hgt])
            voters = extract_voters(ctl.authority_list(),
                                    proof.signature.address_bitmap)
            vote = Vote(proof.height, proof.round, VoteType.PRECOMMIT,
                        proof.block_hash)
            if not auditor.verify_aggregated_signature(
                    proof.signature.signature, sm3_hash(vote.encode()),
                    voters):
                fail(f"curves_sim {scheme}: the proof of height {hgt} "
                     "fails the audit")
        if ctl.violations:
            fail(f"curves_sim {scheme}: safety violations")
        out["schemes"][scheme] = doc
        if (not calls["device"] or after["device_faults"]
                or after["reverified"] or after["status"]["total_failures"]
                or not all(doc["launches"].values())):
            fail(f"curves_sim {scheme}: {doc}")
    out["seconds"] = time.perf_counter() - t_all
    return out


# -- tooling: the build namespace, the port's lint, the multichain twin ----------

def _mapped_libraries() -> set:
    """Paths of the shared objects mapped into this process."""
    with open("/proc/self/maps") as f:
        return {ln.split(None, 5)[5].strip() for ln in f
                if len(ln.split(None, 5)) == 6 and ".so" in ln}


def _multichain_summary(argv, rc: int, out: str, err: str) -> dict:
    """One multichain run's tenants (sheds, p50 wait) and verdict; a
    failed condition, a garbage verdict True or a missing line fails
    the run."""
    lines = [json.loads(ln) for ln in out.splitlines() if ln.startswith("{")]
    combined = [d for d in lines
                if d.get("metric") == "multichain-shared-frontier"]
    if rc != 0 or len(combined) != 1 or not combined[0]["ok"]:
        fail(f"multichain {argv}: exit {rc}: {err[-2000:]}")
    doc = combined[0]
    if doc["adversarial_flood"]["ok"]:
        fail(f"multichain {argv}: a garbage verify came back True")
    tenants = {t: {"sheds": s["sheds"], "p50_wait_ms": s["p50_wait_ms"]}
               for t, s in doc["tenants"].items()}
    if len([d for d in lines if d.get("metric") ==
            "tenant-verify-throughput"]) != len(tenants):
        fail(f"multichain {argv}: not one line per tenant")
    return {"argv": argv, "wall_s": doc["value"], "tenants": tenants,
            "adversarial_flood": doc["adversarial_flood"]}


def tooling(kernels, cold_build_s: float) -> dict:
    """Phase tooling: (a) the build namespace: its fingerprint's inputs
    and directory, a second build_all that must count no miss and a hit
    for every library, and every library this process has loaded (each
    kernel library, the native pairing backend) under build_dir() and
    mapped from there; (b) the port's lint over the checkout (exit 0,
    no actionable finding; counts by rule, suppressed ones included);
    (c) the multichain twin at its defaults and with --adversarial 1,
    one after the other (its fairness condition compares queue waits of
    a few milliseconds, which a neighbour on the cores would skew), each
    meeting its three conditions with no garbage verdict True."""
    from consensus_overlord_tpu_torch import compile_cache
    from consensus_overlord_tpu_torch.crypto import native

    t0 = time.perf_counter()
    where = compile_cache.build_dir()
    before = compile_cache.stats()
    warm_s = kernels.build_all()
    after = compile_cache.stats()
    libs = sum(len(kernels.spec_libs(s)) for s in kernels.all_specs())
    hits = after["hits"] - before["hits"]
    misses = after["misses"] - before["misses"]
    if misses or hits != libs:
        fail(f"the second build counted {hits} hits and {misses} misses "
             f"of {libs} libraries")
    loaded = sorted({h._name for h in kernels._loaded.values()}
                    | ({native._lib._name} if native._lib else set()))
    mapped = _mapped_libraries()
    stray = [p for p in loaded if os.path.dirname(p) != where
             or p not in mapped]
    if not loaded or stray:
        fail(f"libraries outside {where} or not mapped: {stray}")
    lint = subprocess.run(
        [sys.executable, "-m", "consensus_overlord_tpu_torch.analysis",
         "--json", "--root", ROOT], cwd=ROOT, capture_output=True,
        text=True, timeout=120)
    doc = json.loads(lint.stdout) if lint.stdout.strip() else {}
    if lint.returncode != 0 or doc.get("findings"):
        fail(f"the port's lint: exit {lint.returncode}: "
             f"{lint.stdout[-2000:]}{lint.stderr[-2000:]}")
    suppressed = {}
    for f in doc["suppressed"]:
        suppressed[f["rule"]] = suppressed.get(f["rule"], 0) + 1
    multichain = []
    for argv in ([], ["--adversarial", "1"]):
        run = subprocess.run(
            [sys.executable, "-m", "consensus_overlord_tpu_torch.sim.multichain"]
            + argv, cwd=ROOT, capture_output=True, text=True, timeout=300)
        multichain.append(_multichain_summary(argv, run.returncode,
                                              run.stdout, run.stderr))
    return {"phase": "tooling", "seconds": time.perf_counter() - t0,
            "fingerprint": compile_cache.host_fingerprint(),
            "fingerprint_inputs": compile_cache.fingerprint_inputs(),
            "build_dir": where, "cold_build_seconds": cold_build_s,
            "warm_build_seconds": warm_s,
            "warm_build": {"hits": hits, "misses": misses,
                           "libraries": libs},
            "loaded_libraries": [os.path.basename(p) for p in loaded],
            "lint": {"findings": doc["counts"],
                     "suppressed": suppressed,
                     "baselined": doc["baselined"]},
            "multichain": multichain}


TOOLS_PV = "consensus_overlord_tpu_torch.tools.profile_verify"
TOOLS_MESH_LANES = 1024
TOOLS_STRAGGLER = f"{MESH_DEVICE}/2"


def _tool_record(argv, run) -> dict:
    """The ledger record a tool printed last on its stdout; a non-zero
    exit or no record fails the run."""
    lines = [ln for ln in run.stdout.splitlines() if ln.startswith("{")]
    if run.returncode != 0 or not lines:
        fail(f"{' '.join(argv)}: exit {run.returncode}: "
             f"{run.stdout[-2000:]}{run.stderr[-2000:]}")
    return json.loads(lines[-1])


def tools_phase(kernels, smi) -> None:
    """Phase tools: the port's operator tools, each a subprocess on the
    card.  profile_verify at LANES lanes (4 measured rounds after a warm
    one, the first traced by torch.profiler): its split of the warm
    round into parse, dispatch, readback and pairing is printed on a
    line of its own (phase verify_split), and it must pair on the card
    with no host fallback and write its trace; profile_verify over
    MESH_LANES logical lanes at TOOLS_MESH_LANES lanes with the sharded
    probe and a straggler injected on lane 2, which must be the only
    lane flagged; then, at once (no timing is read there), pairing_smoke
    at 4 sets on one device and over MESH_LANES lanes with lane 2 lost
    (both exit 0), and warm_cache at rungs 32 and 128, whose build must
    count a hit for every library and no miss; last the ledger CLI's
    check over the two profile records (exit 0: the mesh rung is a
    metric family of its own, so the gate flags them incomparable)."""
    import tempfile

    from consensus_overlord_tpu_torch.tools.profile_verify import STAGES

    t0 = time.perf_counter()
    steps = {}

    def tool(name, argv, timeout=300):
        t = time.perf_counter()
        run = subprocess.run([sys.executable, "-m", *argv], cwd=ROOT,
                             capture_output=True, text=True,
                             timeout=timeout)
        steps[name] = time.perf_counter() - t
        return run

    with tempfile.TemporaryDirectory(prefix="chip_smoke_tools_") as tmp:
        argv = [TOOLS_PV, str(LANES), "--iters", "4", "--profile-dir",
                os.path.join(tmp, "trace")]
        split = _tool_record(argv, tool("profile_verify", argv))
        trace = os.path.join(split["trace_dir"] or "", "trace.json")
        if (set(split["stages_ms"]) != set(STAGES)
                or not split["device_pairing"]
                or split["pairing_host_fallbacks"]
                or not os.path.exists(trace)):
            fail(f"profile_verify {LANES}: stages "
                 f"{sorted(split['stages_ms'])}, device pairing "
                 f"{split['device_pairing']}, host fallbacks "
                 f"{split['pairing_host_fallbacks']}, trace {trace}")
        emit({"phase": "verify_split", "card": smi, "lanes": LANES,
              "iters": split["iters"], "stages_ms": split["stages_ms"],
              "full_ms": split["full_ms"],
              # hash_to_g1 and the pairing's issue fall between the
              # provider's dispatch and readback stages.
              "unobserved_ms": split["full_ms"] - sum(
                  split["stages_ms"].values()),
              "verifies_per_s": split["verifies_per_s"],
              "first_touch_ms": split["first_touch_ms"],
              "occupancy": split["occupancy"],
              "trace_bytes": os.path.getsize(trace)})
        argv = [TOOLS_PV, str(TOOLS_MESH_LANES), "--mesh", str(MESH_LANES),
                "--sharded-probe", "--inject-straggler", TOOLS_STRAGGLER]
        mesh = _tool_record(argv, tool("profile_verify --mesh", argv))
        if mesh["stragglers"] != [TOOLS_STRAGGLER]:
            fail(f"profile_verify --mesh: flagged {mesh['stragglers']}, "
                 f"wanted only {TOOLS_STRAGGLER}")
        t = time.perf_counter()
        jobs = {}
        for name, argv in (
                ("pairing_smoke", ["pairing_smoke", "4"]),
                ("pairing_smoke --mesh", ["pairing_smoke", "4", "--mesh",
                                          str(MESH_LANES), "--inject-loss",
                                          "2"]),
                ("warm_cache", ["warm_cache", "32", "128"])):
            argv[0] = f"consensus_overlord_tpu_torch.tools.{argv[0]}"
            jobs[name] = subprocess.Popen(
                [sys.executable, "-m", *argv], cwd=ROOT, text=True,
                stdout=subprocess.PIPE, stderr=subprocess.PIPE)
        outs, failed = {}, []
        try:
            for name, job in jobs.items():
                out, err = job.communicate(timeout=300)
                outs[name] = out
                if job.returncode != 0:
                    failed.append(f"{name}: exit {job.returncode}: "
                                  f"{out[-2000:]}{err[-2000:]}")
        finally:
            for job in jobs.values():
                if job.poll() is None:
                    job.kill()
                    job.wait()
        if failed:
            fail("; ".join(failed))
        steps["pairing_smoke and warm_cache, at once"] = \
            time.perf_counter() - t
        build = re.search(r"build: (\d+) hits, (\d+) misses",
                          outs["warm_cache"])
        libs = sum(len(kernels.spec_libs(s)) for s in kernels.all_specs())
        if not build or (int(build[1]), int(build[2])) != (libs, 0):
            fail(f"warm_cache: {outs['warm_cache'][-2000:]}")
        records = []
        for name, rec in (("profile", split), ("profile_mesh", mesh)):
            records.append(os.path.join(tmp, f"{name}.json"))
            with open(records[-1], "w") as f:
                json.dump(rec, f)
        argv = ["consensus_overlord_tpu_torch.obs.ledger", "check",
                *records]
        check = tool("ledger check", argv, timeout=60)
        if check.returncode != 0:
            fail(f"ledger check: exit {check.returncode}: "
                 f"{check.stdout[-2000:]}{check.stderr[-2000:]}")
    emit({"phase": "tools", "seconds": time.perf_counter() - t0,
          "steps_s": steps,
          "mesh": {"lanes": mesh["n"], "stages_ms": mesh["stages_ms"],
                   "stragglers": mesh["stragglers"],
                   "sharded": {k: v for k, v in mesh["sharded"].items()
                               if k.endswith("_s") and
                               isinstance(v, float)}},
          "pairing_smoke": {k: v.strip().splitlines()[-1]
                            for k, v in outs.items()
                            if k.startswith("pairing_smoke")},
          "warm_cache": outs["warm_cache"].strip().splitlines(),
          "ledger_check": check.stdout.strip().splitlines()})


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
    build_s = kernels.build_all()
    emit({"phase": "build", "nvcc_seconds": build_s,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "card": smi, "max_sm_clock_mhz": clock_mhz,
          "int32_per_s": {k: SMS * r * card["clock_hz"] for k, r in (
              ("imad", IMAD_PER_CLOCK_PER_SM), ("alu", ALU_PER_CLOCK_PER_SM),
              ("issue", ISSUE_PER_CLOCK_PER_SM))},
          "lane_ops": lane_ops(BLS12_381_FQ)})
    ptxas = ptxas_report(kernels)
    curve_ptxas = {spec.name: ptxas_report(kernels, spec)
                   for spec in kernels.all_specs()[1:]}
    emit({"phase": "ptxas", "kernels": ptxas, "curve_kernels": curve_ptxas})
    for name in ("fq_mul", "g1_add", "g1_dbl", "g2_add", "g2_dbl") + PAIRING:
        name += "_kernel"
        if name not in ptxas or ptxas[name].get("spill_stores", 1):
            fail(f"{name}: spills or missing from the ptxas report")
    for spec_name, report in curve_ptxas.items():
        for name, info in report.items():
            if info.get("spill_stores", 1) or info.get("spill_loads", 1):
                fail(f"{name} ({spec_name}): spills in the ptxas report")

    t0 = time.perf_counter()
    s0, hashes, pks, sigs = make_fixtures(args.seed, LANES)
    emit({"phase": "fixtures", "validators": len(pks), "hashes": len(hashes),
          "seconds": time.perf_counter() - t0})

    prov = CudaBlsCrypto(s0, device="cuda")
    kernels.reset_counts()
    phase_counts, phase_sizes, phase_secs = drive_main_path(
        prov, s0, hashes, pks, sigs, torch.cuda.synchronize)
    totals = kernels.counts()
    every = [k.name for k in kernels.BLS_KERNELS]
    for name, used in (("pubkeys", ["fq_mul", "g2_add", "g2_dbl"]),
                       ("single_hash", every),
                       ("bad_lanes", every), ("mixed", every)):
        idle = [k for k in used if phase_counts[name][k] == 0]
        if idle:
            fail(f"phase {name} never launched {idle}")
    per_flush = {k: {"single_hash": phase_counts["single_hash"][k],
                     "mixed": phase_counts["mixed"][k]} for k in PAIRING}
    qc = drive_qc(torch, prov, s0, hashes[0], pks, sigs[0],
                  torch.cuda.synchronize)
    tables_doc, table_sizes = g2_tables(
        torch, kernels, s0, hashes, pks, sigs,
        {"seconds": phase_secs, "launches": phase_counts})
    emit(tables_doc)
    emit(degraded(prov, s0, hashes[0], pks, sigs[0]))
    emit(pinned_upload(torch, prov, card, sigs[0], hashes[0], pks))
    emit(sim_fleet(torch, kernels, args.seed))
    emit(service_fleet(kernels))
    # The Ed25519, secp256k1 and SM2 paths, then their fleets.
    curve_sizes, curve_launches = {}, {}
    for scheme in CURVE_KERNELS:
        doc, sizes = curve_phase(torch, kernels, scheme, args.seed)
        emit(doc)
        curve_sizes.update(sizes)
        curve_launches.update(doc["launches"])
    emit(curves_sim(torch, kernels, args.seed))
    emit(chaos_fleet(kernels, args.seed, smi))
    mesh_phase(torch, kernels, prov, s0, hashes, pks, sigs, smi)

    # Host-clock phases first: the profiled round runs last.
    emit(pairing_ab(torch, prov, s0, sigs[0], hashes[0], pks,
                    torch.cuda.synchronize, card))
    emit(crosscheck(prov, s0, sigs[0], hashes[0], pks))
    emit(tooling(kernels, build_s))
    tools_phase(kernels, smi)
    # Each kernel's most frequent lane count in a warm round, and the one
    # that carries the most lanes; g1_add at every size of the round (its
    # tree sum launches once at each power of two below the batch).
    warm = phase_sizes["single_hash"]
    frequent = {k: sorted({max(v, key=lambda b: (v[b], b)),
                           max(v, key=lambda b: (b * v[b], b))})
                for k, v in warm.items() if v}
    frequent["g1_add"] = sorted(warm["g1_add"])
    operands = kernel_operands(torch, args.seed)
    rows, sized = kernel_checks(torch, totals, operands, card, frequent)
    emit({"phase": "kernels_at_main_path_sizes", "kernels": sized})
    pair_rows, pair_phase = pairing_checks(torch, totals, per_flush, card,
                                           args.seed, ptxas)
    pair_phase["launches_per_qc_phase"] = {
        k: {phase: qc[phase][k] for phase in qc} for k in PAIRING}
    emit(pair_phase)
    curve_rows, curve_phase_doc = curve_kernel_checks(
        torch, kernels, curve_sizes, curve_launches, card, args.seed,
        curve_ptxas)
    emit(curve_phase_doc)
    # The G2 kernels at every lane count of the warm single-hash round
    # (the ladder's and the tree's), and at the lane-heaviest launch of
    # the 3-hash round and of each table-path call.
    g2_sizes = {}
    for k in ("g2_add", "g2_dbl"):
        by = [phase_sizes["mixed"][k]] + [d[k] for d in table_sizes.values()]
        g2_sizes[k] = set(phase_sizes["single_hash"][k]) | {
            max(d, key=lambda b: (b * d[b], b)) for d in by if d}
    g2_rows, g2_phase = g2_kernel_checks(
        torch, kernels, totals, card, g2_operands(torch, prov, args.seed),
        g2_sizes, ptxas, prov._pk.aff)
    emit(g2_phase)
    emit(trace_round(torch, prov, sigs[0], hashes[0], pks))
    emit({"kernels": rows + g2_rows + pair_rows + curve_rows})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
