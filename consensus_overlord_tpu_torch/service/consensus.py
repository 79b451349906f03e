"""The Consensus adapter core: owns the engine, WAL, crypto, Brain, and the
reconfiguration state — the reference's `Consensus` struct
(src/consensus.rs:44-293) rebuilt over the asyncio engine.

Public surface (mirrors src/consensus.rs:59, 84, 97, 144, 210, 264):

  run()              — start the SMR engine from the stored configuration
  proc_reconfigure() — controller-pushed config, monotonic-height guarded
  check_block()      — the proof audit behind ConsensusService.CheckBlock
  proc_network_msg() — inbound envelope → decode → frontier verify → engine
  ping_controller()  — the u64::MAX sentinel commit that fishes the current
                       configuration out of the controller

The inbound signature hot path goes through the batching frontier
(crypto/frontier.py): concurrent ProcessNetworkMsg handlers coalesce their
signature checks into device-sized batches — the device-shaped replacement for
the reference's one-at-a-time native verifies (src/consensus.rs:397-416).

The port's own copy of consensus_overlord_tpu/service/consensus.py.  The
"cuda" backend is CudaBlsCrypto on the card; the reference's multi-device
mesh is not ported (ROADMAP item 14), so no mesh is built and a provider
without `attach_supervisor` leaves `supervisor` None.  Clients and the
server run on a transport (service/rpc.py): None = the gRPC wire.
"""

from __future__ import annotations

import logging
from typing import Optional

from ..core import rlp as rlp_codec
from ..core.bitmap import extract_voters
from ..core.sm3 import sm3_hash
from ..core.types import (
    Proof,
    Status,
    Vote,
    VoteType,
    decode_wire_message,
    validators_to_nodes,
)
from ..crypto.frontier import BatchingVerifier
from ..engine.smr import Engine
from ..engine.wal import FileWal
from ..obs.prof import DeviceProfiler, ProfileSession
from .brain import GrpcBrain
from .config import ConsensusConfig
from .pb import pb2
from .rpc import ControllerClient, NetworkClient

logger = logging.getLogger("consensus_overlord_tpu_torch.consensus")

#: The ping_controller sentinel height (reference src/consensus.rs:266:
#: `height: u64::MAX` — the controller answers with its current config
#: instead of committing anything).
PING_HEIGHT = 2**64 - 1


def _make_crypto(backend: str, private_key: int,
                 config: Optional[ConsensusConfig] = None,
                 device: str = "cuda"):
    """The configured provider: "cuda" is CudaBlsCrypto on `device` (the
    card unless the caller asks for the CPU, where each kernel's plain
    version runs), "cpu" the host oracle CpuBlsCrypto."""
    if backend == "cuda":
        from ..crypto.cuda_provider import CudaBlsCrypto
        if config is None:
            return CudaBlsCrypto(private_key, device=device)
        return CudaBlsCrypto(
            private_key, device=device,
            device_pairing=config.device_pairing_flag,
            dispatch_deadline_s=config.dispatch_deadline_s)
    if backend == "cpu":
        from ..crypto.provider import CpuBlsCrypto
        return CpuBlsCrypto(private_key)
    raise ValueError(f"unknown crypto_backend {backend!r} (cuda|cpu)")


class Consensus:
    """One node's consensus service core (reference src/consensus.rs:44-82).

    Wires crypto + WAL + Brain + engine together; the gRPC server layer
    (service/server.py) forwards its three inbound RPCs here.
    """

    def __init__(self, config: ConsensusConfig, private_key: int,
                 controller: Optional[ControllerClient] = None,
                 network: Optional[NetworkClient] = None,
                 crypto=None, tracer=None, metrics=None, recorder=None,
                 causal=None, transport=None, device: str = "cuda"):
        self.config = config
        # Explicit compat: method paths bake at construction, and the
        # global default is shared process-wide (rpc.full_service_name).
        self.controller = controller or ControllerClient(
            config.controller_port, compat=config.proto_compat,
            transport=transport)
        self.network = network or NetworkClient(
            config.network_port, compat=config.proto_compat,
            transport=transport)
        self.crypto = crypto or _make_crypto(config.crypto_backend,
                                             private_key, config, device)
        # One metric surface threads through every hot-path layer: the
        # WAL (append/fsync), the frontier (batch shape + queue wait),
        # the provider (device dispatch phases), and the engine (rounds,
        # view changes, commits).  None everywhere = the pre-obs paths.
        self.metrics = metrics
        self.recorder = recorder
        self.wal = FileWal(config.wal_path, metrics=metrics,
                           recorder=recorder)
        self.brain = GrpcBrain(self.crypto, self.controller, self.network)
        # The frontier is the single inbound verification point; the engine
        # is constructed WITH it, so "inbound_verified" cannot drift from
        # whether a frontier actually guards the injection path.
        self.frontier = BatchingVerifier(
            self.crypto, max_batch=config.frontier_max_batch,
            linger_s=config.frontier_linger_ms / 1000.0, metrics=metrics,
            max_pending=config.effective_tenant_queue_bound,
            weight=config.tenant_weight,
            priority_lanes=config.tenant_priority_lanes,
            recorder=recorder)
        bind = getattr(self.crypto, "bind_metrics", None)
        if bind is not None and metrics is not None:
            bind(metrics)
        # Device profiling: staged round profiles (per-call stage split
        # + the /statusz "profile" ring) whenever metrics are on, and
        # the config-gated torch.profiler capture session (profile_dir /
        # profile_every_n_rounds / the /debug/profile trigger).
        self.profiler = (DeviceProfiler(metrics,
                                        config.profile_ring_capacity)
                         if metrics is not None else None)
        bindp = getattr(self.crypto, "bind_profiler", None)
        if bindp is not None and self.profiler is not None:
            bindp(self.profiler)
        self.profile_session = ProfileSession(
            config.profile_dir, config.profile_every_n_rounds)
        # The device breaker's transitions belong in the same event ring
        # as the engine's (degraded mode is exactly when the post-mortem
        # needs an interleaved timeline).
        breaker = getattr(self.crypto, "breaker", None)
        if breaker is not None and recorder is not None:
            breaker.recorder = recorder
        # Mesh supervisor: the reference attaches its escalation ladder
        # (full mesh -> survivor sub-mesh -> single chip -> host oracle)
        # to any provider that can host one.  The port has no
        # MeshSupervisor yet (ROADMAP item 14), and CudaBlsCrypto no
        # attach_supervisor, so `supervisor` stays None, as the
        # reference leaves it for such a provider.
        self.supervisor = None
        if getattr(self.crypto, "attach_supervisor", None) is not None:
            raise NotImplementedError(
                "MeshSupervisor is not ported (ROADMAP item 14)")
        # tracer: the engine emits height/round/QC-verify spans through the
        # same exporter the gRPC layer uses (reference #[instrument]
        # coverage, src/consensus.rs:96,143,209).
        # causal: the commit tracer (obs/causal.py) — receive/quorum/
        # aggregate/WAL/commit events keyed per height, solved into
        # critical-path stage attributions on every commit.
        self.causal = causal
        self.engine = Engine(self.crypto.pub_key, self.brain, self.crypto,
                             self.wal, frontier=self.frontier, tracer=tracer,
                             metrics=metrics, recorder=recorder,
                             causal=causal)
        # Round-boundary pings drive the capture cadence; attaching here
        # (not in main.py) keeps embedded uses — tests, sim — working.
        self.engine.profile = self.profile_session
        #: Last applied configuration (reference `reconfigure:
        #: Arc<RwLock<Option<ConsensusConfiguration>>>`, src/consensus.rs:55).
        self.reconfigure: Optional[pb2.ConsensusConfiguration] = None

    @property
    def name(self) -> bytes:
        """Node identity = serialized BLS pubkey (src/consensus.rs:352-357)."""
        return self.crypto.pub_key

    # -- lifecycle ----------------------------------------------------------

    async def run(self) -> None:
        """Start the engine from the stored configuration (reference
        src/main.rs:228-245 + src/consensus.rs:84-94).  Blocks until
        stop()."""
        assert self.reconfigure is not None, "run() before reconfiguration"
        cfg = self.reconfigure
        await self.engine.run(
            cfg.height, cfg.block_interval * 1000,
            validators_to_nodes(cfg.validators))

    def stop(self) -> None:
        self.engine.stop()

    async def close(self) -> None:
        self.frontier.close()  # release the dispatch worker thread
        await self.controller.close()
        await self.network.close()

    # -- inbound RPC bodies -------------------------------------------------

    def proc_reconfigure(self, configuration: pb2.ConsensusConfiguration
                         ) -> None:
        """Apply a controller configuration iff it advances the height
        (reference src/consensus.rs:97-141: apply when old == 0 or new >
        old).  Injects RichStatus(height+1), refreshes the Brain node list
        and the provider pubkey cache, then stores the config."""
        old_height = self.reconfigure.height if self.reconfigure else 0
        if not (old_height == 0 or configuration.height > old_height):
            logger.debug("stale reconfigure(%d) ignored (have %d)",
                         configuration.height, old_height)
            return
        nodes = validators_to_nodes(configuration.validators)
        self.engine.handler.send_msg(Status(
            height=configuration.height + 1,
            interval=configuration.block_interval * 1000,
            timer_config=None,
            authority_list=nodes,
        ))
        self.brain.set_nodes(nodes)
        # The reference unwrap-panics on a malformed validator key
        # (src/consensus.rs:133); the provider cache surfaces bad keys
        # per-key instead, so one bad validator can't take the node down.
        update = getattr(self.crypto, "update_pubkeys", None)
        if update is not None:
            update(list(configuration.validators))
        self.reconfigure = configuration
        logger.info("reconfigured to height %d (%d validators)",
                    configuration.height, len(configuration.validators))

    async def check_block(self, pwp: pb2.ProposalWithProof) -> bool:
        """The public proof audit (reference src/consensus.rs:144-207):
        proof.block_hash must equal sm3(proposal.data) and proof.height the
        proposal height; the aggregated signature must verify over
        sm3(rlp(Vote{height, round, Precommit, block_hash})) for exactly
        the voters named in the bitmap.  The aggregate check runs through
        the frontier's off-loop dispatch worker — a large-bitmap audit
        never stalls the gRPC event loop on a device round-trip."""
        proposal_hash = sm3_hash(pwp.proposal.data)
        authority_list = self.brain.get_nodes()
        try:
            proof = Proof.from_rlp(rlp_codec.decode(pwp.proof))
        except Exception:  # noqa: BLE001 — malformed proof is just False
            logger.warning("check_block: proof decode failed")
            return False
        if proof.block_hash != proposal_hash or \
                proof.height != pwp.proposal.height:
            logger.warning("check_block: proof height/hash mismatch")
            return False
        try:
            voters = extract_voters(authority_list,
                                    proof.signature.address_bitmap)
        except ValueError:
            logger.warning("check_block: extract voters failed")
            return False
        vote = Vote(proof.height, proof.round, VoteType.PRECOMMIT,
                    proof.block_hash)
        vote_hash = sm3_hash(vote.encode())
        ok = await self.frontier.verify_aggregated(
            proof.signature.signature, vote_hash, voters)
        if not ok:
            logger.warning("check_block: aggregated signature failed")
        return ok

    async def proc_network_msg(self, msg: pb2.NetworkMsg) -> None:
        """Decode an inbound envelope by type string and inject it into the
        engine (reference src/consensus.rs:210-262), with the signature
        check batched at the frontier.  Malformed or badly signed input is
        logged and dropped, never an error to the peer."""
        try:
            decoded = decode_wire_message(msg.type, msg.msg)
        except Exception:  # noqa: BLE001
            logger.warning("dropped malformed %s from %016x", msg.type,
                           msg.origin)
            return
        await self.engine.inject_inbound(decoded)

    async def ping_controller(self) -> None:
        """Fish the current configuration out of the controller with the
        sentinel commit (reference src/consensus.rs:264-292) — the startup /
        crash-recovery self-healing path."""
        try:
            resp = await self.controller.commit_block(PING_HEIGHT, b"", b"")
        except Exception as e:  # noqa: BLE001
            logger.warning("ping_controller: commit_block error: %s", e)
            return
        if resp.status.code == 0 and resp.HasField("config"):
            self.proc_reconfigure(resp.config)
        else:
            logger.warning("ping_controller: commit_block status %d",
                           resp.status.code)
