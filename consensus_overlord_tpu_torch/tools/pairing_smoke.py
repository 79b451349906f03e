"""Pairing smoke: the device multi-pairing verdict against the host oracle.
The twin of scripts/pairing_smoke.py, with its arguments and exit codes.

Checks, per seeded (sig, pk, msg) set (every second one forged):
  * the device staged verdict (ops/pairing.py multi_pairing_is_one_staged:
    the batched Miller product and ONE final exponentiation, the
    kernels of csrc/pairing.cu on the card) equals the port oracle's
    crypto/bls12381.py multi_pairing_is_one;
  * both equal the a-priori expectation (valid sets True, forged False).

--mesh D runs the sharded pair instead (parallel/sharded.py
sharded_multi_pairing_is_one) over D logical lanes of the device: the
pairs shard over the lanes, each lane Miller-loops its shard, the D
Fq12 partials combine once and one final exponentiation finishes; the
pair set is padded to a multiple of D with masked lanes.

--inject-loss LANE (with --mesh) also walks one step of the mesh ladder
through the production provider (crypto/cuda_provider.py CudaBlsCrypto
and parallel/supervisor.py MeshSupervisor): a warm full-mesh verify,
then the loss of lane LANE; the supervisor must quarantine exactly that
lane and rebuild a (D-1)-lane sub-mesh that dispatches clean while the
lane stays lost, every verdict the host oracle's.

Runs on the card; --cpu runs it on the CPU (each kernel's plain
version).  Exit 0 on full agreement, 1 with a per-set report otherwise,
2 when no card is visible without --cpu.

Usage: python -m consensus_overlord_tpu_torch.tools.pairing_smoke [N]
           [--mesh D] [--inject-loss LANE] [--cpu]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description="device pairing verdicts against the host oracle")
    ap.add_argument("n", nargs="?", type=int, default=4,
                    help="pair sets (default 4)")
    ap.add_argument("--mesh", type=int, default=0, metavar="D",
                    help="the sharded pair over D logical lanes")
    ap.add_argument("--inject-loss", type=int, default=-1, metavar="LANE",
                    help="with --mesh: lose lane LANE and walk the ladder")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (each kernel's plain version)")
    return ap


def make_sets(n: int):
    """n (sig, pk, H(m), expected) sets: set i is signed by sk = 0xC0FFEE
    + 31·i on sm3("pairing-smoke-i"), and every odd set's signature is
    multiplied by 7 (a valid point, a forged signature)."""
    from ..core.sm3 import sm3_hash
    from ..crypto import bls12381 as oracle

    sets = []
    for i in range(n):
        sk = 0xC0FFEE + 31 * i
        h = sm3_hash(b"pairing-smoke-%d" % i)
        sig = oracle.g1_decompress(oracle.sign(sk, h))
        pk = oracle.g2_decompress(oracle.sk_to_pk(sk))
        if i % 2 == 1:
            sig = oracle.g1_mul(sig, 7)
        sets.append((sig, pk, oracle.hash_to_g1(h, b""), i % 2 == 0))
    return sets


def _verdict_fn(lanes: int, device: str):
    """The verdict under test: the single-device staged pair, or the
    sharded pair over `lanes` logical lanes (the same contract)."""
    from ..ops import pairing

    if not lanes:
        return pairing.multi_pairing_is_one_staged
    from ..parallel.sharded import make_mesh, sharded_multi_pairing_is_one

    return sharded_multi_pairing_is_one(make_mesh(lanes, device=device))


def _ladder_smoke(lanes: int, lost: int, device: str) -> int:
    """--inject-loss: one step of the mesh ladder, end to end.

    full_mesh verify (warm) -> inject_device_loss(lane) -> the loss
    surfaces as a DeviceLossError, the verdicts come from the exact host
    re-verify, the supervisor quarantines the lane and rebuilds a
    (D-1)-lane sub-mesh -> the sub-mesh dispatches clean while the lane
    is still lost, verdicts equal to the host oracle's."""
    from ..core.sm3 import sm3_hash
    from ..crypto import bls12381 as oracle
    from ..crypto.cuda_provider import CudaBlsCrypto
    from ..parallel.sharded import make_mesh
    from ..parallel.supervisor import MeshSupervisor

    provider = CudaBlsCrypto(0xD1CE, device_threshold=1,
                             mesh=make_mesh(lanes, device=device))
    # One failure steps down; the probe budget and dwell keep the ladder
    # on sub_mesh for the rest of the smoke.
    sup = MeshSupervisor(provider, step_threshold=1,
                         probe_successes=10_000, probe_cooldown_s=3600.0)
    provider.attach_supervisor(sup)

    batch = 2 * lanes
    h = sm3_hash(b"ladder-smoke-block")
    sks = [9000 + 17 * i for i in range(batch)]
    sigs = [oracle.sign(sk, h) for sk in sks]
    pks = [oracle.sk_to_pk(sk) for sk in sks]
    provider.update_pubkeys(pks)
    expect = [i != 3 for i in range(batch)]  # one forged lane
    sigs[3] = oracle.sign(sks[3], sm3_hash(b"other message"))

    got = provider.verify_batch(sigs, [h] * batch, pks)
    if got != expect or sup.rung != "full_mesh":
        print(f"FAIL: full-mesh verdicts {got} (rung={sup.rung})")
        return 1
    print(f"full_mesh: {batch}-sig verdicts identical to the host oracle",
          flush=True)

    lane = provider.mesh_device_names()[lost]
    provider.inject_device_loss(lane, seconds=3600.0)
    got = provider.verify_batch(sigs, [h] * batch, pks)
    if got != expect:
        print(f"FAIL: host-fallback verdicts wrong under loss: {got}")
        return 1
    if sup.rung != "sub_mesh" or sup.quarantined_devices() != [lane]:
        print(f"FAIL: wanted sub_mesh quarantining [{lane}], got "
              f"rung={sup.rung} quarantined={sup.quarantined_devices()}")
        return 1
    print(f"lane {lane} lost: exact host fallback, supervisor stepped "
          f"full_mesh -> sub_mesh ({lanes - 1} lanes)", flush=True)

    fallbacks0 = provider.breaker.total_fallbacks
    got = provider.verify_batch(sigs, [h] * batch, pks)
    if got != expect:
        print(f"FAIL: sub-mesh verdicts wrong: {got}")
        return 1
    if provider.breaker.total_fallbacks != fallbacks0:
        print("FAIL: sub-mesh pass fell back to the host "
              "(the rebuilt kernel set should dispatch clean)")
        return 1
    print(f"ok: sub-mesh verdicts identical to the host oracle with "
          f"lane {lane} still lost")
    return 0


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    import torch

    if not args.cpu and not torch.cuda.is_available():
        print("pairing_smoke: no CUDA card is visible "
              "(torch.cuda.is_available() is False); pass --cpu to run "
              "on the CPU", file=sys.stderr)
        return 2
    from ..crypto import bls12381 as oracle
    from ..ops import pairing

    device = "cpu" if args.cpu else "cuda:0"
    neg_g2 = (oracle.G2_GEN[0], oracle.fq2_neg(oracle.G2_GEN[1]))
    verdict = _verdict_fn(args.mesh, device)
    lanes = args.mesh or 1
    failures = 0
    for i, (sig, pk, h_pt, want) in enumerate(make_sets(args.n)):
        # Pad the 2-pair set to a multiple of the lanes with masked pairs
        # (the provider's mesh path does the same).
        size = -(-2 // lanes) * lanes
        pad = [None] * (size - 2)
        host = (*pairing.g1_affine_from_oracle([sig, h_pt] + pad),
                *pairing.g2_affine_from_oracle([neg_g2, pk] + pad),
                np.arange(size) < 2)
        got = bool(verdict(*(torch.as_tensor(a, device=device)
                             for a in host)))
        oracle_says = oracle.multi_pairing_is_one([(sig, neg_g2),
                                                   (h_pt, pk)])
        ok = got == oracle_says == want
        print(f"set {i}: device={got} host={oracle_says} expected={want}"
              f" {'OK' if ok else 'MISMATCH'}", flush=True)
        failures += 0 if ok else 1
    kind = f"mesh({args.mesh})" if args.mesh else "device"
    if failures:
        print(f"FAIL: {failures}/{args.n} sets disagree")
        return 1
    print(f"ok: {args.n}/{args.n} {kind} verdicts identical to the host "
          "oracle")
    if args.inject_loss >= 0:
        if not args.mesh:
            print("FAIL: --inject-loss needs --mesh D")
            return 1
        return _ladder_smoke(args.mesh, args.inject_loss, device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
