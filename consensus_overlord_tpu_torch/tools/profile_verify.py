"""Stage-by-stage breakdown of CudaBlsCrypto.verify_batch, on the card or
(under --cpu) the CPU, from the provider's own instrumentation
(obs/prof.py DeviceProfiler), so what this tool reports is what
production exports as `crypto_device_stage_seconds{stage,op}` and the
/statusz "profile" ring.  The twin of scripts/profile_verify.py, with
its arguments in the same order.

Stages, as the provider observes them (crypto/cuda_provider.py):
  parse      host prep of N compressed G1 signatures (parse, pad, the
             RLC weights, pubkey rows) and their upload (the provider's
             "prep" phase)
  dispatch   the verify round's launches (G1 validation and MSM, the
             pubkey-cache gather and G2 MSM) and the pairing's
  readback   the validity bitmap back to the host
  pairing    the pairing verdict: the device verdict's readback, or the
             host pairing where device pairing is off (the CPU default)

--sharded-probe adds the mesh split (CudaBlsCrypto.profile_sharded_stages:
the lanes' own work against the combine, and the pairing's partial
against its combine); --profile-dir captures a torch.profiler trace of
one measured batch (obs/prof.py ProfileSession).  --mesh D profiles the
provider's mesh kernel set over D logical lanes of one device
(parallel/sharded.py make_mesh(D, device="cuda:0"), or "cpu" under
--cpu).  --inject-straggler LANE delays that lane's timed shard fetches
so the straggler detector has a seeded fault to flag.

Usage:  python -m consensus_overlord_tpu_torch.tools.profile_verify [N]
            [--iters K] [--json] [--cpu] [--mesh D] [--sharded-probe]
            [--profile-dir DIR] [--inject-straggler LANE]
            [--inject-straggler-ms MS] [--straggler-ratio R]

Emits one ledger record (obs/ledger.py) on stdout, metric
h100_verify_stage_profile (h100_mesh_verify_stage_profile under --mesh:
D logical lanes of one device take turns, so their rate is no single
card's); stage lines go to stderr.  N defaults to 1024 on the card and 8
on the CPU.  Without --cpu and with no card visible it exits 2.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

METRIC = "h100_verify_stage_profile"
MESH_METRIC = "h100_mesh_verify_stage_profile"
STAGES = ("parse", "dispatch", "readback", "pairing")


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description="staged profile of CudaBlsCrypto.verify_batch")
    ap.add_argument("n", nargs="?", type=int, default=None,
                    help="batch lanes (default: 1024 on the card, 8 on "
                    "the CPU)")
    ap.add_argument("--iters", type=int, default=4,
                    help="measured iterations after the warm-up rep")
    ap.add_argument("--json", action="store_true",
                    help="(kept for compatibility — the JSON tail is "
                    "always emitted; this silences the stderr stage "
                    "lines)")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (each kernel's plain version)")
    ap.add_argument("--mesh", type=int, default=0, metavar="D",
                    help="profile the mesh kernel set over D logical "
                    "lanes of the device")
    ap.add_argument("--sharded-probe", action="store_true",
                    help="also run the mesh stage probe (the lanes' own "
                    "work vs the combine)")
    ap.add_argument("--profile-dir", default=None,
                    help="capture a torch.profiler trace of one measured "
                    "batch into this directory (ProfileSession)")
    ap.add_argument("--inject-straggler", default=None, metavar="DEVICE",
                    help="sleep inside lane DEVICE's shard-fetch timing "
                    "window (e.g. 'cuda:0/2') so the straggler detector "
                    "has a seeded fault to flag")
    ap.add_argument("--inject-straggler-ms", type=float, default=50.0,
                    help="injected per-shard delay in milliseconds "
                    "(default 50)")
    ap.add_argument("--straggler-ratio", type=float, default=1.5,
                    help="straggler flag ratio vs the mesh median "
                    "(<= 0 disables the detector)")
    return ap


def run(args, say=lambda *a: None):
    """Profile verify_batch as `args` asks; returns (the ledger record,
    the DeviceProfiler that recorded the measured iterations)."""
    from ..crypto.cuda_provider import CudaBlsCrypto
    from ..obs import ledger
    from ..obs.anomaly import AnomalyDetector
    from ..obs.fleet import StragglerDetector
    from ..obs.flightrec import FlightRecorder
    from ..obs.metrics import Metrics
    from ..obs.prof import DeviceProfiler, ProfileSession
    from .fixtures import bench_fixture

    device = "cpu" if args.cpu else "cuda:0"
    n = args.n if args.n is not None else (8 if args.cpu else 1024)
    say(f"device: {device}  N={n}")

    sigs, h, pks = bench_fixture(n)
    mesh = None
    if args.mesh:
        from ..parallel.sharded import make_mesh

        mesh = make_mesh(args.mesh, device=device)
        say(f"mesh: {mesh.size} lanes")
    provider = CudaBlsCrypto(0xA11CE, device_threshold=min(8, n),
                             device=device, mesh=mesh)
    provider.update_pubkeys(pks)

    # The warm rep takes the first touch (table upload, the pairing
    # programs, the allocator's first blocks) unmetered.
    t0 = time.perf_counter()
    provider.verify_batch(sigs, [h] * n, pks)
    first_touch_s = time.perf_counter() - t0
    say(f"{'first_touch':12s} {first_touch_s * 1e3:9.2f} ms  (unmetered)")

    metrics = Metrics()
    prof = DeviceProfiler(metrics)
    provider.bind_metrics(metrics)
    provider.bind_profiler(prof)
    recorder = FlightRecorder(256)
    straggler = None
    if args.straggler_ratio > 0:
        straggler = StragglerDetector(metrics=metrics, recorder=recorder,
                                      ratio=args.straggler_ratio)
        prof.attach_straggler(straggler)
    anomaly = AnomalyDetector(metrics=metrics, recorder=recorder,
                              straggler=straggler)
    if args.inject_straggler:
        provider.inject_straggler(args.inject_straggler,
                                  args.inject_straggler_ms / 1e3)
        say(f"straggler injection: {args.inject_straggler} "
            f"+{args.inject_straggler_ms:.0f} ms/shard")

    session = ProfileSession(args.profile_dir)
    trace_dir = None
    lat = []
    for rep in range(args.iters):
        capture = rep == 0 and session.available \
            and session.start(1, label=f"verify_n{n}")
        t0 = time.perf_counter()
        results = provider.verify_batch(sigs, [h] * n, pks)
        lat.append(time.perf_counter() - t0)
        if capture:
            trace_dir = session.stop()
        if not all(results):
            raise RuntimeError("profile_verify: a fixture signature did "
                               "not verify")

    totals = prof.stage_totals()
    stages_ms = {}
    for stage in STAGES:
        t = totals.get(f"verify_batch/{stage}")
        if t:
            stages_ms[stage] = round(t["total_s"] / t["count"] * 1e3, 3)
            say(f"{stage:12s} {stages_ms[stage]:9.2f} ms")
    full_s = sum(lat) / len(lat)
    say(f"{'full':12s} {full_s * 1e3:9.2f} ms")
    say(f"rate: {n / full_s:.0f} verifies/s")

    sharded = None
    if args.sharded_probe:
        # The straggler detector needs min_samples per lane and stage, so
        # under injection the probe repeats until the fault can flag.
        for _ in range(3 if args.inject_straggler else 1):
            sharded = provider.profile_sharded_stages(sigs, pks)
        say(f"{'partial_red':12s} "
            f"{sharded['partial_reduce_s'] * 1e3:9.2f} ms  "
            f"({sharded['devices']} lane(s))")
        say(f"{'allgather':12s} {sharded['allgather_s'] * 1e3:9.2f} ms")
        say(f"{'pair_partial':12s} "
            f"{sharded['pairing_partial_s'] * 1e3:9.2f} ms")
        say(f"{'pair_combine':12s} "
            f"{sharded['pairing_combine_s'] * 1e3:9.2f} ms")
        for key, row in sorted((sharded.get("device_stage_s")
                                or {}).items()):
            say(f"  {key:20s} {row['last_s'] * 1e3:9.3f} ms  "
                f"(n={row['count']})")
        if straggler is not None and straggler.flagged_devices():
            say(f"stragglers flagged: "
                f"{', '.join(straggler.flagged_devices())}")

    summary = prof.summary()
    # The JSON tail is a ledger record (value = verifies/s at this N), so
    # profile runs diff, trend and check against each other.
    record = ledger.annotate({
        "metric": MESH_METRIC if mesh is not None else METRIC,
        "value": round(n / full_s, 1),
        "unit": "verifies/s",
        "device": "cpu" if args.cpu else "gpu",
        "n": n,
        "iters": args.iters,
        "first_touch_ms": round(first_touch_s * 1e3, 1),
        "full_ms": round(full_s * 1e3, 3),
        "verifies_per_s": round(n / full_s, 1),
        "stages_ms": stages_ms,
        "device_pairing": provider._pairing_on_device,
        "pairing_host_fallbacks": provider.pairing_host_fallbacks,
        "mesh_devices": mesh.size if mesh is not None else 0,
        "occupancy": summary["occupancy"],
        "devices": summary["devices"],
        "sharded": sharded,
        "trace_dir": trace_dir,
        # Fleet observability: per-lane cumulative stage rows, the
        # straggler detector's verdict and the alert tally.
        "device_stages": prof.device_stage_totals(),
        "mesh": straggler.statusz() if straggler is not None else None,
        "stragglers": (straggler.flagged_devices()
                       if straggler is not None else []),
        "alerts_total": anomaly.alert_count(),
    }, profiler=prof)
    return record, prof


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    import torch

    if not args.cpu and not torch.cuda.is_available():
        print("profile_verify: no CUDA card is visible "
              "(torch.cuda.is_available() is False); pass --cpu to run "
              "on the CPU", file=sys.stderr)
        return 2
    say = (lambda *a: None) if args.json else (
        lambda *a: print(*a, file=sys.stderr, flush=True))
    if not args.cpu:
        say(f"card: {torch.cuda.get_device_name(0)}")
    record, _ = run(args, say)
    print(json.dumps(record), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
