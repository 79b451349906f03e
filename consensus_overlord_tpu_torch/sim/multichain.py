"""Multi-tenant crypto-as-a-service acceptance harness: M chains × N
validators in one process, every chain's signature traffic feeding ONE
SharedFrontier (crypto/tenancy.py) — the "one device serving many
chains" economics, with one tenant deliberately saturating its lane.

The port's twin of scripts/sim_multichain.py: the same flags, defaults,
acceptance conditions and output lines, on the port's sim_crypto,
SharedFrontier, SimNetwork, Metrics and obs/ledger.py (whose env stamp
names torch, CUDA and the card).  Like the JAX script it runs on
sim_crypto alone: the shared provider is a throttled simulation-grade
provider, not a card.

Each chain is an independent SimNetwork fleet registered as one tenant
on the shared core (tenant = chain, so all N validators of a chain feed
one lane).  The shared provider is throttled (--flush-cost-ms sleeps per
batch) so device occupancy is contended like a real chip under load.
Saturating tenants run a flood task that pumps verify traffic far past
their queue bound — admission control sheds the overflow to the
host-oracle path (exact verdicts) while DWRR keeps composing fair
batches for the light tenants.  --adversarial K makes the first K
saturators flood with INVALID signatures (the Byzantine tenant): the
run then also fails if any garbage verify came back True, batched or
shed.

The run is the acceptance test; it exits nonzero unless:

  1. every chain reaches --heights (liveness under a saturating
     neighbor — the whole point of fairness + admission control);
  2. every saturating tenant shed at least once
     (frontier_admission_sheds_total nonzero — the bound engaged);
  3. no light tenant's p50 queue wait exceeds --wait-ratio × the
     lightest light tenant's (starvation bound).

Output: one ledger-stamped BenchRecord line PER TENANT (tenant id in
the emitter context, so a ledger trend can track per-tenant throughput)
plus one combined line carrying the per-tenant status map, the
shared-frontier stats, and the assertion outcomes.  --out-dir
additionally writes each line to its own JSON file.

Usage: python -m consensus_overlord_tpu_torch.sim.multichain --chains 3
       --saturate 1 [--validators 4] [--heights 3] [--interval-ms 100] ...
"""

import argparse
import asyncio
import json
import os
import sys
import time


class ThrottledProvider:
    """The shared 'device': a sim-grade provider whose verify_batch
    costs a fixed wall-clock sleep per flush — contention for the chip
    is real even on CPU, so tenant queue dynamics (linger, sheds, DWRR
    shares) behave like a loaded device instead of resolving in µs."""

    def __init__(self, base, flush_cost_s: float):
        self._base = base
        self._cost = flush_cost_s

    def __getattr__(self, name):
        return getattr(self._base, name)

    def verify_batch(self, sigs, hashes, voters):
        if self._cost > 0:
            time.sleep(self._cost)
        return self._base.verify_batch(sigs, hashes, voters)


def main(argv=None) -> int:
    """Run the harness; returns the exit code (0 when every acceptance
    condition holds, 2 otherwise)."""
    ap = argparse.ArgumentParser(
        description="M chains x N validators over one shared multi-tenant "
                    "frontier, with saturating tenants")
    ap.add_argument("--chains", type=int, default=3)
    ap.add_argument("--validators", type=int, default=4,
                    help="validators per chain")
    ap.add_argument("--heights", type=int, default=3,
                    help="target height per chain")
    ap.add_argument("--saturate", type=int, default=1,
                    help="how many chains flood their lane (first K)")
    ap.add_argument("--adversarial", type=int, default=0,
                    help="how many of the saturating tenants flood with "
                         "INVALID signatures (first K of --saturate): a "
                         "Byzantine tenant pumping garbage through the "
                         "shared pipeline — every verdict must come back "
                         "False (batched or shed), honest chains must "
                         "still commit, and the fairness gate must hold")
    ap.add_argument("--interval-ms", type=int, default=100)
    ap.add_argument("--max-batch", type=int, default=64,
                    help="shared frontier flush size cap")
    ap.add_argument("--linger-ms", type=float, default=10.0)
    ap.add_argument("--tenant-queue-bound", type=int, default=48,
                    help="per-tenant pending bound (arrivals over it shed "
                         "to the host oracle)")
    ap.add_argument("--tenant-weight", type=int, default=1)
    ap.add_argument("--flood-burst", type=int, default=256,
                    help="verify requests per flood burst (saturating "
                         "tenants; > queue bound so sheds engage)")
    ap.add_argument("--flood-pause-ms", type=float, default=10.0)
    ap.add_argument("--flush-cost-ms", type=float, default=1.0,
                    help="simulated device cost per batch flush")
    ap.add_argument("--wait-ratio", type=float, default=3.0,
                    help="max allowed light-tenant p50 queue-wait ratio")
    ap.add_argument("--timeout", type=float, default=120.0,
                    help="per-chain liveness timeout (s)")
    ap.add_argument("--out-dir", default=None,
                    help="also write each ledger line to its own JSON file")
    args = ap.parse_args(argv)
    if args.saturate >= args.chains:
        ap.error("--saturate must leave at least one light chain")
    if args.adversarial > args.saturate:
        ap.error("--adversarial tenants are a subset of --saturate")

    from ..core.sm3 import sm3_hash
    from ..crypto.provider import sim_crypto
    from ..crypto.tenancy import SharedFrontier
    from ..obs import ledger
    from ..obs.metrics import Metrics, snapshot
    from .harness import SimNetwork

    async def flood(lane, stop: asyncio.Event, burst: int, pause_s: float,
                    counters: dict, adversarial: bool = False) -> None:
        """Saturating-tenant load: bursts of gossip-class verifies far
        past the lane's queue bound.  Valid-signature floods prove flow
        control under honest overload (verdicts stay exact on the shed
        path); adversarial floods pump INVALID signatures — the
        Byzantine-tenant case — and every verdict must come back False
        whether it rode a device batch or shed to the host oracle."""
        crypto = sim_crypto(b"\x5a" * 32)
        h = sm3_hash(b"flood-traffic")
        sig = b"\x00" * len(crypto.sign(h)) if adversarial \
            else crypto.sign(h)
        voter = crypto.pub_key
        msg_type = "flood_adversarial" if adversarial else "flood"
        while not stop.is_set():
            results = await asyncio.gather(
                *(lane.verify(sig, h, voter, msg_type=msg_type)
                  for _ in range(burst)))
            counters["sent"] += len(results)
            counters["ok"] += sum(results)
            try:
                await asyncio.wait_for(stop.wait(), pause_s)
            except asyncio.TimeoutError:
                pass

    async def run() -> int:
        metrics = Metrics()
        shared_provider = ThrottledProvider(sim_crypto(b"\x11" * 32),
                                            args.flush_cost_ms / 1000.0)
        shared = SharedFrontier(shared_provider, max_batch=args.max_batch,
                                linger_s=args.linger_ms / 1000.0,
                                metrics=metrics)
        chains = []
        for i in range(args.chains):
            tid = f"chain{i}"
            lane = shared.register(tid, weight=args.tenant_weight,
                                   queue_bound=args.tenant_queue_bound)
            net = SimNetwork(
                n_validators=args.validators,
                block_interval_ms=args.interval_ms,
                seed=1000 + i,
                crypto_factory=(lambda j, i=i: sim_crypto(
                    ((0x6000 + 257 * i) * 4099 + j).to_bytes(4, "big") * 8)),
                use_frontier=True, metrics=metrics,
                frontier_factory=lambda crypto, lane=lane: lane)
            chains.append({"tenant": tid, "lane": lane, "net": net,
                           "saturating": i < args.saturate,
                           "adversarial": i < args.adversarial,
                           "reached": False, "total_s": None})

        stop_flood = asyncio.Event()
        flood_counters = {"sent": 0, "ok": 0}
        # Adversarial floods tally separately: their "ok" count must
        # stay ZERO (an accepted garbage signature would be a forgery
        # through the shared pipeline).
        adv_counters = {"sent": 0, "ok": 0}
        t0 = time.perf_counter()
        for c in chains:
            c["net"].start(init_height=1)
        flood_tasks = []
        for c in chains:
            if not c["saturating"]:
                continue
            counters = adv_counters if c["adversarial"] else flood_counters
            flood_tasks.append(asyncio.get_running_loop().create_task(
                flood(c["lane"], stop_flood, args.flood_burst,
                      args.flood_pause_ms / 1000.0, counters,
                      adversarial=c["adversarial"])))

        async def run_chain(c) -> None:
            start = time.perf_counter()
            await c["net"].run_until_height(args.heights,
                                            timeout=args.timeout)
            c["total_s"] = round(time.perf_counter() - start, 3)
            c["reached"] = True

        failures = []
        results = await asyncio.gather(*(run_chain(c) for c in chains),
                                       return_exceptions=True)
        stop_flood.set()
        for task in flood_tasks:
            task.cancel()
        await asyncio.gather(*flood_tasks, return_exceptions=True)
        for c, r in zip(chains, results):
            if isinstance(r, BaseException):
                failures.append(
                    f"LIVENESS: {c['tenant']} missed height "
                    f"{args.heights} within {args.timeout}s ({r!r})")
        wall = time.perf_counter() - t0
        for c in chains:
            await c["net"].stop()
        shared.close()
        # Let the shutdown drain's in-flight batches resolve before the
        # loop closes (close() schedules the worker release async).
        await asyncio.sleep(0.05)

        # -- acceptance: sheds engaged on every saturating tenant ---------
        for c in chains:
            s = c["lane"].tenant_stats
            if c["saturating"] and s.sheds == 0:
                failures.append(
                    f"ADMISSION: saturating tenant {c['tenant']} never "
                    f"shed (bound {args.tenant_queue_bound} too high or "
                    f"flood too weak; requests={s.requests})")

        # -- acceptance: adversarial floods were all rejected -------------
        if adv_counters["ok"] > 0:
            failures.append(
                f"FORGERY: {adv_counters['ok']} of "
                f"{adv_counters['sent']} invalid-signature flood "
                f"verifies came back True")
        if args.adversarial and adv_counters["sent"] == 0:
            failures.append("ADVERSARIAL: flood task sent nothing")

        # -- acceptance: light-tenant p50 queue-wait starvation bound -----
        light = [c for c in chains if not c["saturating"]]
        p50s = {c["tenant"]: c["lane"].tenant_stats.p50_wait_ms()
                for c in light}
        measured = {t: p for t, p in p50s.items() if p is not None}
        if len(measured) != len(light):
            failures.append(f"FAIRNESS: light tenant with no queue-wait "
                            f"samples ({p50s})")
        elif len(measured) > 1:
            # Floor the reference at 1 ms: with sub-ms p50s the ratio is
            # scheduler jitter, not starvation.
            floor = max(min(measured.values()), 1.0)
            for t, p in measured.items():
                if p > args.wait_ratio * floor:
                    failures.append(
                        f"FAIRNESS: {t} p50 queue-wait {p:.2f}ms exceeds "
                        f"{args.wait_ratio}x the lightest tenant's "
                        f"({floor:.2f}ms)")

        # -- per-tenant ledger records + combined line --------------------
        out_dir = args.out_dir
        if out_dir:
            os.makedirs(out_dir, exist_ok=True)

        def emit(record: dict, name: str) -> None:
            print(json.dumps(record))
            if out_dir:
                with open(os.path.join(out_dir, name + ".json"), "w") as f:
                    json.dump(record, f, indent=2)

        for c in chains:
            status = c["lane"].status()
            rate = (status["requests"] / wall) if wall > 0 else 0.0
            emit(ledger.annotate({
                "metric": "tenant-verify-throughput",
                "value": round(rate, 2),
                "unit": "verifies/s",
                "context": {
                    "tenant": c["tenant"],
                    "saturating": c["saturating"],
                    "adversarial": c["adversarial"],
                    "chains": args.chains,
                    "validators_per_chain": args.validators,
                    "heights": args.heights,
                    "queue_bound": args.tenant_queue_bound,
                    "weight": args.tenant_weight,
                },
                "tenant": status,
                "reached_height": c["reached"],
                "chain_total_s": c["total_s"],
            }), f"tenant_{c['tenant']}")

        scraped = snapshot(metrics.registry)
        obs = {k: v for k, v in scraped.items()
               if k.split("{", 1)[0].endswith(("_count", "_sum", "_total"))}
        emit(ledger.annotate({
            "metric": "multichain-shared-frontier",
            "value": round(wall, 3),
            "unit": "wall_s",
            "context": {
                "chains": args.chains,
                "saturating": args.saturate,
                "validators_per_chain": args.validators,
                "heights_per_chain": args.heights,
                "max_batch": args.max_batch,
                "linger_ms": args.linger_ms,
                "flush_cost_ms": args.flush_cost_ms,
                "queue_bound": args.tenant_queue_bound,
            },
            "tenants": shared.tenants_status(),
            "frontier": {
                "requests": shared.stats.requests,
                "batches": shared.stats.batches,
                "mean_batch": round(shared.stats.mean_batch, 2),
                "max_batch": shared.stats.max_batch,
                "failures": shared.stats.failures,
            },
            "flood": flood_counters,
            "adversarial_flood": adv_counters,
            "light_p50_wait_ms": p50s,
            "failures": failures,
            "ok": not failures,
            "metrics": obs,
        }), "multichain_combined")

        if failures:
            for f in failures:
                print(f, file=sys.stderr)
            return 2
        return 0

    return asyncio.run(run())


if __name__ == "__main__":
    sys.exit(main())
