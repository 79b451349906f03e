"""The server surface: ConsensusService + NetworkMsgHandlerService +
Health (reference src/main.rs:77-155, src/health_check.rs:22-36), assembled
into one server (src/main.rs:262-296).

Handlers are thin: gate, decode, forward to the Consensus core, map the
result to a status code.  Every inbound message's signature work lands on
the batching frontier inside the core, not here.

The port's own copy of consensus_overlord_tpu/service/server.py.  The
handlers take either transport's context (service/rpc.py): `abort`
takes a status code's name, and the gRPC transport maps it to
grpc.StatusCode.
"""

from __future__ import annotations

import logging
import time
from typing import Optional, Sequence

from .consensus import Consensus
from .pb import pb2
from .rpc import (
    CONSENSUS_SERVICE,
    HEALTH_SERVICE,
    NETWORK_MSG_HANDLER_SERVICE,
    Code,
    GrpcTransport,
    generic_handler,
)

logger = logging.getLogger("consensus_overlord_tpu_torch.server")


class ConsensusServer:
    """ConsensusService + NetworkMsgHandlerService implementation
    (reference src/main.rs:77-155)."""

    def __init__(self, consensus: Consensus):
        self.consensus = consensus

    # -- ConsensusService ---------------------------------------------------

    async def reconfigure(self, request: pb2.ConsensusConfiguration,
                          context) -> pb2.StatusCode:
        """Forward to proc_reconfigure; always replies Success — a stale
        config is ignored, not an error (src/main.rs:92-104)."""
        self.consensus.proc_reconfigure(request)
        return pb2.StatusCode(code=Code.SUCCESS)

    async def check_block(self, request: pb2.ProposalWithProof,
                          context) -> pb2.StatusCode:
        """NotReady until the first reconfiguration (src/main.rs:112-115),
        then the full proof audit (src/main.rs:116-123)."""
        if self.consensus.reconfigure is None:
            logger.warning("check_block: server not ready")
            return pb2.StatusCode(code=Code.NOT_READY)
        ok = await self.consensus.check_block(request)
        return pb2.StatusCode(
            code=Code.SUCCESS if ok else Code.PROPOSAL_CHECK_ERROR)

    # -- NetworkMsgHandlerService -------------------------------------------

    async def process_network_msg(self, request: pb2.NetworkMsg,
                                  context) -> pb2.StatusCode:
        """Reject foreign modules with INVALID_ARGUMENT (src/main.rs:139-142);
        everything else is decode-verify-inject, always Success (inbound
        garbage is dropped, never an error to the peer)."""
        if request.module != "consensus":
            logger.warning("invalid module %r", request.module)
            await context.abort("INVALID_ARGUMENT", "wrong module")
        await self.consensus.proc_network_msg(request)
        return pb2.StatusCode(code=Code.SUCCESS)


class HealthServer:
    """Liveness-aware health service.  The reference answers SERVING
    unconditionally (src/health_check.rs:29-35) — which means a node
    whose engine has been wedged at one height for minutes still passes
    grpc-health-probe and never gets restarted.  Here the probe carries
    real liveness: SERVING while the engine's height advances (or hasn't
    started yet — startup wait is not a stall), NOT_SERVING once the
    height has sat still past `stall_window_s`, SERVING again as soon as
    it moves.

    stall_window_s <= 0 disables the check (the reference's
    unconditional behavior).  `engine` needs only `.height` and
    `.running` — plain attribute reads, safe from any thread."""

    def __init__(self, engine=None, stall_window_s: float = 0.0,
                 clock=time.monotonic):
        self._engine = engine
        self._stall_window = stall_window_s
        self._clock = clock
        self._last_height: Optional[int] = None
        self._last_advance: Optional[float] = None

    def stalled(self) -> bool:
        """Has the engine's height sat still past the stall window?"""
        eng = self._engine
        if eng is None or self._stall_window <= 0:
            return False
        if not getattr(eng, "running", True):
            # Not started (waiting for the controller's configuration) or
            # stopped for shutdown: liveness is undefined, not stalled —
            # reset the baseline so a later start gets a fresh window.
            self._last_height = self._last_advance = None
            return False
        height, now = eng.height, self._clock()
        if height != self._last_height or self._last_advance is None:
            self._last_height, self._last_advance = height, now
            return False
        return now - self._last_advance > self._stall_window

    def status(self) -> dict:
        """JSON-encodable snapshot for /statusz."""
        stalled = self.stalled()
        since = (self._clock() - self._last_advance
                 if self._last_advance is not None else 0.0)
        return {
            "serving": not stalled,
            "stall_window_s": self._stall_window,
            "height": self._last_height,
            "height_age_s": round(since, 3),
        }

    async def check(self, request: pb2.HealthCheckRequest,
                    context) -> pb2.HealthCheckResponse:
        if self.stalled():
            logger.warning(
                "health: height %s stalled past %.1fs -> NOT_SERVING",
                self._last_height, self._stall_window)
            return pb2.HealthCheckResponse(
                status=pb2.HealthCheckResponse.NOT_SERVING)
        return pb2.HealthCheckResponse(
            status=pb2.HealthCheckResponse.SERVING)


def build_server(consensus_server: ConsensusServer,
                 port: int = 0,
                 interceptors: Optional[Sequence] = None,
                 host: str = "[::]",
                 compat: Optional[str] = None,
                 health: Optional[HealthServer] = None,
                 transport=None):
    """Assemble the three services into one server (reference
    src/main.rs:262-296) on `transport` (None = the gRPC wire).  Returns
    (server, bound_port) — port 0 lets the transport pick (used by
    tests).  interceptors: transport-neutral middleware (obs/logctx.py
    TraceContext, obs/metrics.py RpcMetrics) or grpc interceptors.
    compat: proto_compat mode for the served method paths (None =
    process default).  health: a liveness-wired HealthServer (default:
    one with the check disabled)."""
    transport = transport if transport is not None else GrpcTransport()
    tables = (
        generic_handler("ConsensusService", CONSENSUS_SERVICE,
                        consensus_server, compat=compat),
        generic_handler("NetworkMsgHandlerService",
                        NETWORK_MSG_HANDLER_SERVICE, consensus_server,
                        compat=compat),
        generic_handler("Health", HEALTH_SERVICE,
                        health if health is not None else HealthServer(),
                        compat=compat),
    )
    return transport.server(tables, port=port, host=host,
                            interceptors=list(interceptors or ()))
