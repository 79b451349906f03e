"""CLI entry for the simulation harness, on the port's providers.

    python -m consensus_overlord_tpu_torch.sim.run --crypto bls --validators 64

Runs an in-process validator fleet until the target height, printing per-
height commit latency and a one-line JSON summary: the main path of
consensus_overlord_tpu/sim/run.py, with its argument names and defaults.
Every node verifies on its own device provider behind a batching
frontier, on the card unless ``--device cpu`` asks for the CPU (the
kernels' plain versions); with no GPU the providers' constructors raise
and the run exits non-zero.  The schemes are the JAX package's five:
``ed25519`` (the default; Ed25519CudaCrypto, seeds 0x4000 + 7919·i),
``bls`` (CudaBlsCrypto, the reference's keys 0x1000 + 7919·i),
``secp256k1`` and ``sm2`` (Secp256k1Crypto and Sm2Crypto, keys 0x2000
and 0x3000 + 7919·i), and ``simhash``, the dependency-free sim-grade
provider.  The breaker-less providers run inside SimDeviceCrypto, whose
frontier keeps a device error as a fault: the run exits 3.

Not ported yet (ROADMAP.md): chaos, soak and tenant flags and
``--shared-frontier``, the metrics exporter (``--statusz-port``), the
causal commit tracer (``--critpath-out``) and XLA-style profile capture.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import logging
import sys
import time

#: Validator count at which runs default onto the batching frontier:
#: at fleet scale the per-message host verify path is not the
#: production shape (--no-frontier overrides).
FLEET_FRONTIER_MIN = 16

#: Fleet-scale fabric defaults: at this many validators the sim fabric
#: shards (sim/router.py ShardedRouter) and, when --interval-ms was left
#: at its default, the base round timer scales with fleet size: a 100 ms
#: timer that n=4 meets easily is a choke/view-change storm at n=1000.
FLEET_SHARD_MIN = 256
FLEET_DEFAULT_SHARDS = 8


def sum_status(docs) -> dict:
    """Sum providers' degraded_status() documents: numbers add, a bool
    counts the providers where it is true, a string counts providers by
    value, a nested dict sums the same way; None is skipped."""
    out: dict = {}
    for doc in docs:
        for key, v in doc.items():
            if v is None:
                continue
            if isinstance(v, dict):
                out[key] = sum_status([out.get(key, {}), v])
            elif isinstance(v, bool):
                out[key] = out.get(key, 0) + int(v)
            elif isinstance(v, (int, float)):
                out[key] = out.get(key, 0) + v
            else:
                counts = out.setdefault(key, {})
                counts[str(v)] = counts.get(str(v), 0) + 1
    return out


def make_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="in-process consensus fleet on the port's providers")
    parser.add_argument("--validators", type=int, default=4)
    parser.add_argument("--heights", "--target-height", type=int, default=5,
                        dest="heights",
                        help="commit this many heights (--target-height "
                        "is an alias)")
    parser.add_argument("--interval-ms", type=int, default=100)
    parser.add_argument("--shards", type=int, default=0,
                        help="sim fabric shards (sim/router.py "
                        "ShardedRouter); 0 = auto "
                        f"({FLEET_DEFAULT_SHARDS} at "
                        f">={FLEET_SHARD_MIN} validators, else 1)")
    parser.add_argument("--shard-workers", choices=("inline", "thread"),
                        default="inline",
                        help="per-shard pump workers: 'inline' (asyncio "
                        "tasks on the main loop, deterministic) or "
                        "'thread' (one worker thread per shard)")
    parser.add_argument("--drop-rate", type=float, default=0.0)
    parser.add_argument("--seed", type=int, default=0,
                        help="router RNG seed (drop/delay schedule)")
    parser.add_argument("--crypto",
                        choices=["ed25519", "bls", "secp256k1", "sm2",
                                 "simhash"],
                        default="ed25519",
                        help="the signature scheme: votes and QCs past "
                        "--device-threshold are verified by the port's "
                        "kernels (ed25519: Ed25519CudaCrypto, bls: "
                        "CudaBlsCrypto, secp256k1 / sm2: Secp256k1Crypto "
                        "/ Sm2Crypto); 'simhash' is the dependency-free "
                        "sim-grade provider (NOT real crypto)")
    parser.add_argument("--device", choices=["cuda", "cpu"],
                        default="cuda",
                        help="where the providers of every scheme but "
                        "simhash run their device paths: the card, or "
                        "the kernels' plain PyTorch versions on the CPU. "
                        " With no GPU, 'cuda' fails; nothing falls back "
                        "to the CPU")
    parser.add_argument("--frontier", action="store_true",
                        help="verify inbound signatures at the batching "
                        "frontier (always on for the device schemes: "
                        "the device path needs coalesced batches and "
                        "off-loop dispatch).  Auto-enabled at fleet "
                        f"scale (>= {FLEET_FRONTIER_MIN} validators)")
    parser.add_argument("--no-frontier", action="store_true",
                        help="force per-message host verify even at "
                        "fleet scale (simhash only)")
    parser.add_argument("--frontier-linger-ms", type=float, default=2.0)
    parser.add_argument("--dispatch-deadline-s", type=float, default=None,
                        help="watchdog deadline for each blocking device "
                        "call of the bls providers (rung-scaled; the "
                        "other schemes have no watchdog).  "
                        "Default: CONSENSUS_DISPATCH_DEADLINE_S, else "
                        "off")
    parser.add_argument("--device-threshold", type=int, default=8,
                        help="batch size at which the providers ship "
                        "work to the device instead of the host oracle "
                        "(also their QC threshold)")
    parser.add_argument("--timeout", type=float, default=120.0)
    parser.add_argument("--flightrec", type=int, default=256,
                        help="per-node flight-recorder capacity (events); "
                        "rings are dumped if the run times out.  0 = off")
    parser.add_argument("--prewarm", action="store_true",
                        help="run one batch through every device path "
                        "at every rung the fleet can hit before the fleet "
                        "starts (crypto/warm.py), so the kernels' build "
                        "and first touch stay out of the measured "
                        "heights (every scheme but simhash)")
    parser.add_argument("-v", "--verbose", action="store_true")
    return parser


def crypto_factory(args):
    """Node i's provider (the keys of the JAX package's sim.run)."""
    if args.crypto == "bls":
        from ..crypto.cuda_provider import CudaBlsCrypto

        return lambda i: CudaBlsCrypto(  # noqa: E731
            0x1000 + 7919 * i, device=args.device,
            device_threshold=args.device_threshold,
            dispatch_deadline_s=args.dispatch_deadline_s)
    if args.crypto == "ed25519":
        from ..crypto.ed25519_cuda import Ed25519CudaCrypto

        return lambda i: Ed25519CudaCrypto(  # noqa: E731
            (0x4000 + 7919 * i).to_bytes(32, "big"), device=args.device,
            device_threshold=args.device_threshold)
    if args.crypto in ("secp256k1", "sm2"):
        from ..crypto.ecdsa_cuda import Secp256k1Crypto, Sm2Crypto

        cls = Secp256k1Crypto if args.crypto == "secp256k1" else Sm2Crypto
        base = 0x2000 if args.crypto == "secp256k1" else 0x3000
        return lambda i: cls(  # noqa: E731
            base + 7919 * i, device=args.device,
            device_threshold=args.device_threshold)
    from ..crypto.provider import SimHashCrypto

    return lambda i: SimHashCrypto(  # noqa: E731
        (0x5000 + 7919 * i).to_bytes(32, "big"))


async def run(args, factory, use_frontier: bool, shards: int) -> dict:
    """Drive the fleet to args.heights; returns the JSON summary.  A
    height missed within args.timeout is a liveness failure (exit 2), a
    device fault kept by a node's frontier a device failure (exit 3):
    the flight recorders and router counters go to stderr first."""
    from ..obs.prof import DeviceProfiler
    from . import SimNetwork

    # Staged round profiles ride every run (the "profile" block); the
    # metric surface is not ported yet, so everything below runs its
    # metrics=None path.
    profiler = DeviceProfiler()
    net = SimNetwork(n_validators=args.validators,
                     block_interval_ms=args.interval_ms,
                     seed=args.seed,
                     drop_rate=args.drop_rate, crypto_factory=factory,
                     use_frontier=use_frontier,
                     frontier_linger_s=args.frontier_linger_ms / 1000.0,
                     metrics=None,
                     flight_recorder_capacity=args.flightrec,
                     # Breaker-less providers get the simulated device
                     # path; CudaBlsCrypto has its own breaker and is
                     # left as it is.
                     sim_device_crypto=True,
                     profiler=profiler,
                     shards=shards,
                     shard_workers=args.shard_workers)
    net.start(init_height=1)
    t0 = time.perf_counter()
    last = t0
    height_ms = []
    failure = None
    for h in range(1, args.heights + 1):
        try:
            await net.run_until_height(h, timeout=args.timeout)
        except asyncio.TimeoutError:
            failure = (2, f"LIVENESS FAILURE: stuck at height "
                       f"{net.controller.latest_height}, wanted {h} (of "
                       f"{args.heights}) within {args.timeout}s")
        except RuntimeError as e:
            failure = (3, f"DEVICE FAILURE at height {h}: {e}")
        if failure is not None:
            print(failure[1], file=sys.stderr)
            if args.flightrec:
                print(net.dump_flight_recorders(64), file=sys.stderr)
            print(f"router: {json.dumps(net.router.stats())}",
                  file=sys.stderr)
            try:
                await net.stop()
            except Exception:  # noqa: BLE001 — exiting anyway
                pass
            raise SystemExit(failure[0])
        now = time.perf_counter()
        height_ms.append((now - last) * 1000)
        print(f"height {h} committed (+{height_ms[-1]:.1f} ms)")
        last = now
    total = time.perf_counter() - t0
    # stop() unregisters every node: read the router while it is live.
    router_stats = net.router.stats()
    await net.stop()
    srt = sorted(height_ms)

    def pct(q: float) -> float:
        return round(srt[min(len(srt) - 1, int(q * len(srt)))], 1)

    frontier = {}
    stats = [n.frontier.stats for n in net.nodes
             if getattr(n, "frontier", None) is not None]
    if stats:
        batches = sum(s.batches for s in stats)
        frontier = {
            "frontier_batches": batches,
            "frontier_mean_batch": round(
                sum(s.requests for s in stats) / max(1, batches), 1),
            "frontier_max_batch": max(s.max_batch for s in stats),
            "frontier_reverified": sum(s.reverified for s in stats),
        }
    status = [n.crypto.degraded_status() for n in net.nodes
              if hasattr(n.crypto, "degraded_status")]
    return {
        "metric": "consensus-rounds",
        "validators": args.validators,
        "heights": args.heights,
        "shards": shards,
        "shard_workers": args.shard_workers,
        "crypto": args.crypto,
        "device": args.device if args.crypto != "simhash" else None,
        "total_s": round(total, 3),
        "ms_per_height": round(total * 1000 / args.heights, 1),
        "p50_ms": pct(0.50),
        "p95_ms": pct(0.95),
        "delivered": router_stats["delivered"],
        "dropped": router_stats["dropped"],
        "router": router_stats,
        **frontier,
        # Staged device profile: cumulative stage split per op and the
        # recent per-call ring (obs/prof.py).
        "profile": {**profiler.summary(), "recent": profiler.tail(16)},
        # Every node's breaker and fallback counters, summed.
        "crypto_status": sum_status(status),
    }


def main(argv=None) -> None:
    parser = make_parser()
    args = parser.parse_args(argv)
    logging.basicConfig(
        level=logging.DEBUG if args.verbose else logging.WARNING,
        format="%(asctime)s %(message)s")

    shards = args.shards
    if shards <= 0:
        shards = (FLEET_DEFAULT_SHARDS
                  if args.validators >= FLEET_SHARD_MIN else 1)
    if (args.validators >= FLEET_SHARD_MIN
            and args.interval_ms == parser.get_default("interval_ms")):
        # 4x headroom: a choke storm is only escapable while the capped
        # round backoff exceeds the cost of one full choke round.
        args.interval_ms = max(args.interval_ms, 4 * args.validators)
        print(f"fleet default: --interval-ms scaled to {args.interval_ms} "
              f"for {args.validators} validators (pass --interval-ms "
              "explicitly to override)")
    device_batched = args.crypto != "simhash"
    if args.no_frontier and device_batched:
        parser.error(f"--no-frontier is incompatible with --crypto "
                     f"{args.crypto}")
    use_frontier = (not args.no_frontier
                    and (args.frontier or device_batched
                         or args.validators >= FLEET_FRONTIER_MIN))
    factory = crypto_factory(args)

    if args.prewarm and device_batched:
        from ..crypto.warm import rungs_for, warm_bls, warm_simple

        t0 = time.time()
        warm = factory(10**6)  # same thresholds as the fleet's providers
        # Every rung the fleet's coalesced batches can hit: up to
        # ~validators lanes per batch, and at least the threshold.
        rungs = rungs_for(max(args.device_threshold, args.validators, 8))
        (warm_bls if args.crypto == "bls" else warm_simple)(warm, rungs)
        print(f"prewarm: device paths loaded for rungs {rungs} "
              f"in {time.time() - t0:.1f}s")

    out = asyncio.run(run(args, factory, use_frontier, shards))
    print(json.dumps(out))
    if out.get("frontier_reverified"):
        # A provider call raised and its batch was verified on the host:
        # the heights committed, but not on the path the run asked for.
        print(f"HOST RE-VERIFY: {out['frontier_reverified']} frontier "
              "batches were re-verified on the host after their provider "
              "call raised", file=sys.stderr)
        raise SystemExit(3)


if __name__ == "__main__":
    main()
