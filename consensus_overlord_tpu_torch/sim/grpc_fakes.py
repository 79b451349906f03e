"""In-process RPC stand-ins for the sibling microservices: the network
service each node registers with, and the controller that serves/commits
blocks — the full-fidelity test bed for the service process (SURVEY.md §4:
"an in-process fake controller + fake network router lets N engine
instances run a real consensus in one pytest process").

Unlike sim/router.py + sim/controller.py (which plug straight into the
engine), these speak the service's RPCs, so a ServiceRuntime boots
against them exactly as against real CITA-Cloud siblings: registration
retry, ping_controller bootstrap, NetworkMsg push delivery, reconfigure
pushes after each commit.

The port's own copy of consensus_overlord_tpu/sim/grpc_fakes.py.  The
fakes run on either transport of service/rpc.py (None = the gRPC wire),
which must be the one the ServiceRuntimes they serve use.
"""

from __future__ import annotations

import argparse
import asyncio
import logging
import sys
from typing import Dict, List, Optional, Sequence

from ..core import rlp
from ..core.sm3 import sm3_hash
from ..core.types import validator_to_origin
from ..service.pb import pb2
from ..service.rpc import (
    CONTROLLER_SERVICE,
    NETWORK_MSG_HANDLER_SERVICE,
    NETWORK_SERVICE,
    Code,
    RetryClient,
    GrpcTransport,
    generic_handler,
)

logger = logging.getLogger("consensus_overlord_tpu_torch.sim.grpc")

PING_HEIGHT = 2**64 - 1


class HandlerClient(RetryClient):
    """Client of a node's NetworkMsgHandlerService (the push-delivery side
    of the network service, reference src/main.rs:133-154)."""

    def __init__(self, address: str, **kw):
        super().__init__(address, "NetworkMsgHandlerService",
                         NETWORK_MSG_HANDLER_SERVICE, **kw)

    async def process_network_msg(self, msg: pb2.NetworkMsg) -> int:
        return (await self.call("ProcessNetworkMsg", msg)).code


class NetworkFabric:
    """Shared routing state across all fake network siblings: which node
    owns which validator origin, and where its consensus handler listens.
    transport: the one every node serves on (None = the gRPC wire)."""

    def __init__(self, transport=None):
        self.transport = transport if transport is not None \
            else GrpcTransport()
        #: node index → consensus handler address ("localhost:port")
        self.handler_addr: Dict[int, str] = {}
        #: origin (u64 prefix of validator address) → node index
        self.origin_to_node: Dict[int, int] = {}
        self._clients: Dict[int, HandlerClient] = {}
        self.dropped = 0

    def set_validators(self, validators: Sequence[bytes]) -> None:
        self.origin_to_node = {
            validator_to_origin(bytes(v)): i
            for i, v in enumerate(validators)}

    def client_for(self, node: int) -> Optional[HandlerClient]:
        addr = self.handler_addr.get(node)
        if addr is None:
            return None
        client = self._clients.get(node)
        if client is None or client.address != addr:
            client = HandlerClient(addr, retries=1,
                                   transport=self.transport)
            self._clients[node] = client
        return client

    async def deliver(self, node: int, msg: pb2.NetworkMsg) -> None:
        client = self.client_for(node)
        if client is None:
            self.dropped += 1
            return
        try:
            await client.process_network_msg(msg)
        except Exception as e:  # noqa: BLE001 — lossy network is legal BFT
            self.dropped += 1
            logger.debug("delivery to node %d failed: %s", node, e)

    async def close(self) -> None:
        for c in self._clients.values():
            await c.close()
        self._clients.clear()


class FakeNetworkService:
    """One node's network sibling: accepts the registration handshake and
    routes Broadcast (to every other node) / SendMsg (by origin prefix,
    reference src/util.rs:93-97) through the shared fabric."""

    def __init__(self, fabric: NetworkFabric, owner: int):
        self.fabric = fabric
        self.owner = owner

    async def register_network_msg_handler(self, request: pb2.RegisterInfo,
                                           context) -> pb2.StatusCode:
        if request.module_name != "consensus":
            return pb2.StatusCode(code=Code.INVALID_ARGUMENT)
        self.fabric.handler_addr[self.owner] = \
            f"{request.hostname}:{request.port}"
        return pb2.StatusCode(code=Code.SUCCESS)

    async def broadcast(self, request: pb2.NetworkMsg,
                        context) -> pb2.StatusCode:
        loop = asyncio.get_running_loop()
        for node in self.fabric.origin_to_node.values():
            if node != self.owner:
                loop.create_task(self.fabric.deliver(node, request))
        return pb2.StatusCode(code=Code.SUCCESS)

    async def send_msg(self, request: pb2.NetworkMsg,
                       context) -> pb2.StatusCode:
        node = self.fabric.origin_to_node.get(request.origin)
        if node is None:
            return pb2.StatusCode(code=Code.INVALID_ARGUMENT)
        asyncio.get_running_loop().create_task(
            self.fabric.deliver(node, request))
        return pb2.StatusCode(code=Code.SUCCESS)


class FakeController:
    """The shared controller: serves deterministic proposals, audits
    commits (fork check), answers the ping sentinel with the current
    configuration, and pushes Reconfigure to every node after each commit
    — the chain side of reference src/consensus.rs:517-657 plus the
    controller behavior implied by src/consensus.rs:264-292."""

    def __init__(self, validators: Sequence[bytes], block_interval: int = 1,
                 transport=None):
        self.transport = transport if transport is not None \
            else GrpcTransport()
        self.validators = [bytes(v) for v in validators]
        self.block_interval = block_interval
        self.chain: Dict[int, bytes] = {}
        self.proofs: Dict[int, bytes] = {}
        self.commit_log: List[tuple[int, bytes]] = []
        #: consensus service addresses to push Reconfigure to after commits
        self.consensus_addrs: List[str] = []
        self._consensus_clients: Dict[str, RetryClient] = {}
        self._height_event = asyncio.Event()

    # -- chain logic --------------------------------------------------------

    def make_content(self, height: int) -> bytes:
        return rlp.encode([height, b"grpc sim block", b"\x00" * 32])

    @property
    def latest_height(self) -> int:
        return max(self.chain) if self.chain else 0

    def current_config(self) -> pb2.ConsensusConfiguration:
        return pb2.ConsensusConfiguration(
            height=self.latest_height,
            block_interval=self.block_interval,
            validators=self.validators)

    async def wait_for_height(self, height: int, timeout: float = 60.0
                              ) -> None:
        loop = asyncio.get_running_loop()
        deadline = loop.time() + timeout
        while self.latest_height < height:
            remaining = deadline - loop.time()
            if remaining <= 0:
                raise asyncio.TimeoutError(
                    f"chain stuck at {self.latest_height}, wanted {height}")
            try:
                await asyncio.wait_for(
                    asyncio.shield(self._height_event.wait()), remaining)
            except asyncio.TimeoutError:
                continue

    # -- gRPC handlers ------------------------------------------------------

    async def get_proposal(self, request: pb2.Empty,
                           context) -> pb2.ProposalResponse:
        height = self.latest_height + 1
        return pb2.ProposalResponse(
            status=pb2.StatusCode(code=Code.SUCCESS),
            proposal=pb2.Proposal(height=height,
                                  data=self.make_content(height)))

    async def check_proposal(self, request: pb2.Proposal,
                             context) -> pb2.StatusCode:
        ok = request.data == self.make_content(request.height)
        return pb2.StatusCode(
            code=Code.SUCCESS if ok else Code.PROPOSAL_CHECK_ERROR)

    async def commit_block(self, request: pb2.ProposalWithProof,
                           context) -> pb2.ConsensusConfigurationResponse:
        height = request.proposal.height
        if height == PING_HEIGHT:
            # the ping sentinel: no commit, just the current config
            return pb2.ConsensusConfigurationResponse(
                status=pb2.StatusCode(code=Code.SUCCESS),
                config=self.current_config())
        existing = self.chain.get(height)
        if existing is not None and existing != request.proposal.data:
            raise AssertionError(
                f"FORK at height {height}: two distinct blocks committed")
        fresh = existing is None
        if fresh:
            self.chain[height] = request.proposal.data
            self.proofs[height] = request.proof
            self._height_event.set()
            self._height_event = asyncio.Event()
        self.commit_log.append((height, sm3_hash(request.proposal.data)))
        resp = pb2.ConsensusConfigurationResponse(
            status=pb2.StatusCode(code=Code.SUCCESS),
            config=pb2.ConsensusConfiguration(
                height=height, block_interval=self.block_interval,
                validators=self.validators))
        if fresh:
            # push Reconfigure to every node (lagging-node resync path)
            loop = asyncio.get_running_loop()
            loop.create_task(self._push_reconfigure(resp.config))
        return resp

    async def _push_reconfigure(self, config) -> None:
        for addr in list(self.consensus_addrs):
            client = self._consensus_clients.get(addr)
            if client is None:
                from ..service.rpc import CONSENSUS_SERVICE
                client = RetryClient(addr, "ConsensusService",
                                     CONSENSUS_SERVICE, retries=1,
                                     transport=self.transport)
                self._consensus_clients[addr] = client
            try:
                await client.call("Reconfigure", config)
            except Exception:  # noqa: BLE001
                pass

    async def close(self) -> None:
        for c in self._consensus_clients.values():
            await c.close()
        self._consensus_clients.clear()


async def start_fake_network(fabric: NetworkFabric, owner: int,
                             port: int = 0):
    """Serve one node's FakeNetworkService on the fabric's transport
    (port 0: the transport picks); returns (server, port)."""
    server, port = fabric.transport.server(
        (generic_handler("NetworkService", NETWORK_SERVICE,
                         FakeNetworkService(fabric, owner)),),
        port=port, host="localhost")
    await server.start()
    return server, port


async def start_fake_controller(controller: FakeController, port: int = 0):
    """Serve the FakeController on its transport (port 0: the transport
    picks); returns (server, port)."""
    server, port = controller.transport.server(
        (generic_handler("Consensus2ControllerService", CONTROLLER_SERVICE,
                         controller),),
        port=port, host="localhost")
    await server.start()
    return server, port


async def serve_one_validator(private_key: int, network_port: int,
                              controller_port: int, consensus_port: int,
                              block_interval: int, heights: int) -> int:
    """The siblings of one validator on the gRPC wire: its network
    service on `network_port` and a controller on `controller_port`
    that pushes Reconfigure to `consensus_port`.  Returns after
    `heights` committed heights (0: runs until cancelled)."""
    from ..crypto.provider import CpuBlsCrypto

    fabric = NetworkFabric()
    validators = [CpuBlsCrypto(private_key).pub_key]
    fabric.set_validators(validators)
    controller = FakeController(validators, block_interval=block_interval,
                                transport=fabric.transport)
    controller.consensus_addrs.append(f"localhost:{consensus_port}")
    servers = [(await start_fake_network(fabric, 0, network_port))[0],
               (await start_fake_controller(controller, controller_port))[0]]
    try:
        if heights:
            await controller.wait_for_height(heights,
                                             timeout=60 + 10 * heights)
        else:
            await asyncio.Event().wait()
    finally:
        for server in servers:
            await server.stop(0.5)
        await controller.close()
        await fabric.close()
    return controller.latest_height


def main(argv=None) -> int:
    """`python -m consensus_overlord_tpu_torch.sim.grpc_fakes -p
    private_key`: serve one validator's network and controller siblings
    on localhost for a `service.main run` node with the same key and
    matching ports; prints the committed height and exits after
    --heights (0: serve until interrupted)."""
    from ..crypto.provider import load_private_key

    ap = argparse.ArgumentParser(description=main.__doc__.split("\n\n")[0])
    ap.add_argument("-p", "--private_key_path", default="private_key")
    ap.add_argument("--network-port", type=int, default=50000)
    ap.add_argument("--controller-port", type=int, default=50004)
    ap.add_argument("--consensus-port", type=int, default=50001)
    ap.add_argument("--block-interval", type=int, default=3)
    ap.add_argument("--heights", type=int, default=0)
    args = ap.parse_args(argv)
    try:
        height = asyncio.run(serve_one_validator(
            load_private_key(args.private_key_path), args.network_port,
            args.controller_port, args.consensus_port, args.block_interval,
            args.heights))
    except asyncio.TimeoutError as e:
        print(f"grpc_fakes: {e}", file=sys.stderr)
        return 2
    print(f"committed height {height}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
