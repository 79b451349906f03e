"""RPC plumbing without generated stubs: method tables, transport-neutral
handler tables, retrying clients, and two transports.

The port's own copy of consensus_overlord_tpu/service/rpc.py, with the
transport split from the clients.  A client calls
``channel.unary(path, request_bytes)`` and parses the reply with the
message class of service/pb; a server is a list of handler tables
(``generic_handler``) that a transport serves:

  GrpcTransport      the network wire: grpc.aio channels and servers.
                     It imports `grpc` when it is built, and maps
                     grpc.aio.AioRpcError to RpcError.
  LoopbackTransport  in-process: a server registers its handler tables
                     under a port, and a call serializes the request,
                     runs the handler in a fresh context and parses the
                     reply, so the wire encoding runs on every call.

Failures of either transport raise ``RpcError(code, details)``, whose
code is the name of a gRPC status code ("UNAVAILABLE", ...).  Server
middleware (obs/logctx.py TraceContext, obs/metrics.py RpcMetrics) is
transport-neutral too: ``wrap(method, metadata, inner)`` returns the
handler to run; the gRPC transport serves it as a
grpc.aio.ServerInterceptor.

Status codes in replies are this stack's own enum (the reference returns
members of its ecosystem's status-code set, reference
src/main.rs:100-124; ours is self-consistent across the services we both
serve and consume).
"""

from __future__ import annotations

import asyncio
import contextvars
import itertools
import logging
import random
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Sequence, Tuple

from .pb import pb2

logger = logging.getLogger("consensus_overlord_tpu_torch.rpc")

_PKG = "consensus_overlord_tpu"

#: CITA-Cloud wire-compat service naming: the reference serves/consumes
#: `cita_cloud_proto` package paths (src/main.rs:64-73:
#: consensus.ConsensusService, network.NetworkMsgHandlerService /
#: network.NetworkService, controller.Consensus2ControllerService,
#: grpc.health.v1.Health), while this framework's native mode namespaces
#: everything under its own package.  `set_proto_compat("cita_cloud")`
#: switches every served and dialed method path to the reference's names
#: so a node can join a reference mesh.
_CITA_CLOUD_SERVICES = {
    "ConsensusService": "consensus.ConsensusService",
    "NetworkMsgHandlerService": "network.NetworkMsgHandlerService",
    "NetworkService": "network.NetworkService",
    "Consensus2ControllerService": "controller.Consensus2ControllerService",
    "Health": "grpc.health.v1.Health",
}
_proto_compat = "native"


def set_proto_compat(mode: str) -> None:
    """'native' (default) or 'cita_cloud' — applies to handlers/clients
    built AFTER the call (service startup sets it before wiring)."""
    global _proto_compat
    if mode not in ("native", "cita_cloud"):
        raise ValueError(f"unknown proto_compat mode {mode!r}")
    _proto_compat = mode


def full_service_name(service_name: str,
                      compat: Optional[str] = None) -> str:
    """compat=None falls back to the process default (set_proto_compat).
    Handlers/clients bake method paths at construction, so components
    built for a specific runtime should pass their config's mode
    explicitly — two runtimes with different modes in one process would
    otherwise race on the global."""
    mode = compat if compat is not None else _proto_compat
    if mode == "cita_cloud":
        return _CITA_CLOUD_SERVICES[service_name]
    if mode != "native":
        raise ValueError(f"unknown proto_compat mode {mode!r}")
    return f"{_PKG}.{service_name}"


class Code:
    SUCCESS = 0
    PROPOSAL_CHECK_ERROR = 1
    NOT_READY = 2
    INVALID_ARGUMENT = 3
    INTERNAL_ERROR = 4
    NO_PROPOSAL = 5


#: The names of gRPC's status codes, the codes an RpcError carries.
STATUS_CODES = (
    "OK", "CANCELLED", "UNKNOWN", "INVALID_ARGUMENT", "DEADLINE_EXCEEDED",
    "NOT_FOUND", "ALREADY_EXISTS", "PERMISSION_DENIED",
    "RESOURCE_EXHAUSTED", "FAILED_PRECONDITION", "ABORTED", "OUT_OF_RANGE",
    "UNIMPLEMENTED", "INTERNAL", "UNAVAILABLE", "DATA_LOSS",
    "UNAUTHENTICATED")


class RpcError(Exception):
    """A failed call on either transport: `code` is a gRPC status-code
    name (STATUS_CODES), `details` the server's message."""

    def __init__(self, code: str, details: str = ""):
        if code not in STATUS_CODES:
            raise ValueError(f"unknown status code {code!r}")
        super().__init__(f"{code}: {details}" if details else code)
        self.code = code
        self.details = details


#: Status codes worth retrying: the peer may recover (restarting
#: sibling, overloaded server, lost race, missed deadline).  Everything
#: else — INVALID_ARGUMENT, UNIMPLEMENTED, PERMISSION_DENIED, ... — is a
#: contract violation that will fail identically on every retry; burning
#: the retry budget on it just delays the engine's own recovery paths.
TRANSIENT_CODES = frozenset({
    "UNAVAILABLE",
    "DEADLINE_EXCEEDED",
    "RESOURCE_EXHAUSTED",
    "ABORTED",
    "UNKNOWN",  # server-side unhandled raise: may clear
})


def is_transient(code) -> bool:
    """Is this status code (a name, or a grpc.StatusCode) a retry-worthy
    transport/peer hiccup?"""
    return getattr(code, "name", code) in TRANSIENT_CODES


# method name → (request class, response class), per service.
CONSENSUS_SERVICE = {
    "Reconfigure": (pb2.ConsensusConfiguration, pb2.StatusCode),
    "CheckBlock": (pb2.ProposalWithProof, pb2.StatusCode),
}
NETWORK_MSG_HANDLER_SERVICE = {
    "ProcessNetworkMsg": (pb2.NetworkMsg, pb2.StatusCode),
}
HEALTH_SERVICE = {
    "Check": (pb2.HealthCheckRequest, pb2.HealthCheckResponse),
}
NETWORK_SERVICE = {
    "RegisterNetworkMsgHandler": (pb2.RegisterInfo, pb2.StatusCode),
    "Broadcast": (pb2.NetworkMsg, pb2.StatusCode),
    "SendMsg": (pb2.NetworkMsg, pb2.StatusCode),
}
CONTROLLER_SERVICE = {
    "GetProposal": (pb2.Empty, pb2.ProposalResponse),
    "CheckProposal": (pb2.Proposal, pb2.StatusCode),
    "CommitBlock": (pb2.ProposalWithProof, pb2.ConsensusConfigurationResponse),
}


@dataclass
class HandlerTable:
    """One served service: its full name and, per method, the handler
    coroutine `fn(request, context)` with its request and response
    classes.  Either transport serves it."""

    service: str
    methods: Dict[str, Tuple[Callable, type, type]]

    def paths(self) -> Dict[str, Tuple[Callable, type, type]]:
        return {f"/{self.service}/{m}": entry
                for m, entry in self.methods.items()}


def generic_handler(service_name: str, methods: Dict[str, tuple],
                    impl, compat: Optional[str] = None) -> HandlerTable:
    """Bind `impl.<snake_case>` coroutines to the service's methods."""
    handlers = {}
    for method, (req_cls, resp_cls) in methods.items():
        snake = "".join(
            ("_" + c.lower()) if c.isupper() else c for c in method
        ).lstrip("_")
        handlers[method] = (getattr(impl, snake), req_cls, resp_cls)
    return HandlerTable(full_service_name(service_name, compat), handlers)


# -- the gRPC transport ---------------------------------------------------------


def _grpc():
    import grpc  # noqa: PLC0415 — only the network wire needs it

    return grpc


async def _intercept(grpc, middleware, continuation, details):
    """grpc.aio.ServerInterceptor.intercept_service over a
    transport-neutral middleware's `wrap`."""
    handler = await continuation(details)
    if handler is None or handler.unary_unary is None:
        return handler
    inner = handler.unary_unary
    wrapped = middleware.wrap(details.method,
                              tuple(details.invocation_metadata or ()),
                              inner)
    if wrapped is inner:
        return handler
    return grpc.unary_unary_rpc_method_handler(
        wrapped, request_deserializer=handler.request_deserializer,
        response_serializer=handler.response_serializer)


def grpc_interceptor_class(middleware_cls, name: str):
    """A grpc.aio.ServerInterceptor subclass of a transport-neutral
    middleware class (obs/logctx.py TraceContextInterceptor, obs/metrics.py
    MetricsInterceptor).  Imports grpc: call it only for the wire."""
    grpc = _grpc()

    async def intercept_service(self, continuation, details):
        return await _intercept(grpc, self, continuation, details)

    return type(name, (grpc.aio.ServerInterceptor, middleware_cls),
                {"intercept_service": intercept_service,
                 "__module__": middleware_cls.__module__})


class _GrpcContext:
    """The handler-side context on the gRPC wire: `abort` takes a status
    code's name."""

    def __init__(self, grpc, context):
        self._grpc = grpc
        self._context = context

    async def abort(self, code: str, details: str = "") -> None:
        await self._context.abort(self._grpc.StatusCode[code], details)


class _GrpcChannel:
    def __init__(self, grpc, address: str):
        self._grpc = grpc
        self._channel = grpc.aio.insecure_channel(address)
        self._calls: dict = {}

    async def unary(self, path: str, request: bytes, timeout: float,
                    metadata=None) -> bytes:
        call = self._calls.get(path)
        if call is None:  # no serializers: bytes in, bytes out
            call = self._calls[path] = self._channel.unary_unary(path)
        try:
            return await call(request, timeout=timeout, metadata=metadata)
        except self._grpc.aio.AioRpcError as e:
            raise RpcError(e.code().name, e.details() or "") from e

    async def close(self) -> None:
        await self._channel.close()


class GrpcTransport:
    """The network wire: grpc.aio channels and servers.  Building one
    imports `grpc` (the grpcio package); the service cannot listen
    without it."""

    name = "grpc"

    def __init__(self):
        self._grpc = _grpc()

    def channel(self, address: str) -> _GrpcChannel:
        return _GrpcChannel(self._grpc, address)

    def server(self, tables: Sequence[HandlerTable], port: int = 0,
               host: str = "[::]", interceptors: Sequence = ()):
        """A grpc.aio server for `tables` bound to host:port (0 = OS
        pick); returns (server, bound_port).  `interceptors`: the
        transport-neutral middleware, each served as a grpc interceptor."""
        grpc = self._grpc

        class _Adapter(grpc.aio.ServerInterceptor):
            def __init__(self, middleware):
                self.middleware = middleware

            async def intercept_service(self, continuation, details):
                return await _intercept(grpc, self.middleware,
                                        continuation, details)

        server = grpc.aio.server(
            interceptors=[_Adapter(m) for m in interceptors])
        generic = []
        for table in tables:
            handlers = {}
            for method, (fn, req_cls, resp_cls) in table.methods.items():
                async def call(request, context, fn=fn):
                    return await fn(request, _GrpcContext(grpc, context))
                handlers[method] = grpc.unary_unary_rpc_method_handler(
                    call, request_deserializer=req_cls.FromString,
                    response_serializer=resp_cls.SerializeToString)
            generic.append(grpc.method_handlers_generic_handler(
                table.service, handlers))
        server.add_generic_rpc_handlers(tuple(generic))
        bound = server.add_insecure_port(f"{host}:{port}")
        return server, bound


# -- the in-process transport ---------------------------------------------------


class LoopbackContext:
    """The handler-side context of an in-process call: `abort` raises
    the RpcError the caller gets, and `code()` reads it back (as a grpc
    context's does, for obs/metrics.py RpcMetrics)."""

    def __init__(self):
        self._code: Optional[str] = None

    async def abort(self, code: str, details: str = "") -> None:
        self._code = code
        raise RpcError(code, details)

    def code(self) -> Optional[str]:
        return self._code


class LoopbackServer:
    """Handler tables served in process under one port of a
    LoopbackTransport; `start` and `stop(grace)` as a grpc.aio server."""

    def __init__(self, transport: "LoopbackTransport", port: int,
                 tables: Sequence[HandlerTable], interceptors: Sequence):
        self._transport = transport
        self.port = port
        self._methods: Dict[str, tuple] = {}
        for table in tables:
            self._methods.update(table.paths())
        self._interceptors = list(interceptors)
        self.serving = False

    async def start(self) -> None:
        self.serving = True

    async def stop(self, grace: Optional[float] = None) -> None:
        self.serving = False
        self._transport._servers.pop(self.port, None)

    async def handle(self, path: str, request: bytes, timeout: float,
                     metadata) -> bytes:
        entry = self._methods.get(path)
        if entry is None:
            raise RpcError("UNIMPLEMENTED", f"method {path} not found")
        fn, req_cls, _ = entry
        try:
            req = req_cls.FromString(request)
        except Exception as e:  # noqa: BLE001 — pb2.DecodeError
            raise RpcError("INTERNAL", f"request parse: {e}") from e
        handler = fn
        for middleware in reversed(self._interceptors):
            handler = middleware.wrap(path, tuple(metadata or ()), handler)
        # A fresh context, as a server task has: the caller's trace
        # contextvars must not leak into the handler.
        task = asyncio.get_running_loop().create_task(
            handler(req, LoopbackContext()),
            context=contextvars.Context())
        try:
            resp = await asyncio.wait_for(task, timeout)
        except RpcError:
            raise
        except asyncio.TimeoutError as e:
            raise RpcError("DEADLINE_EXCEEDED", path) from e
        except Exception as e:  # noqa: BLE001 — an unhandled server raise
            raise RpcError("UNKNOWN", f"{type(e).__name__}: {e}") from e
        return resp.SerializeToString()


class _LoopbackChannel:
    def __init__(self, transport: "LoopbackTransport", address: str):
        self._transport = transport
        self._address = address
        self._port = int(address.rsplit(":", 1)[1])

    async def unary(self, path: str, request: bytes, timeout: float,
                    metadata=None) -> bytes:
        server = self._transport._servers.get(self._port)
        if server is None or not server.serving:
            raise RpcError("UNAVAILABLE", f"nothing serves {self._address}")
        return await server.handle(path, bytes(request), timeout, metadata)

    async def close(self) -> None:
        pass


class LoopbackTransport:
    """In-process transport: servers register under a port of this
    transport (ports are its own, not the host's), and every call runs
    the wire encoding of service/pb both ways."""

    name = "loopback"

    def __init__(self):
        self._servers: Dict[int, LoopbackServer] = {}
        self._ports = itertools.count(40000)

    def channel(self, address: str) -> _LoopbackChannel:
        return _LoopbackChannel(self, address)

    def server(self, tables: Sequence[HandlerTable], port: int = 0,
               host: str = "", interceptors: Sequence = ()):
        if port == 0:
            port = next(p for p in self._ports if p not in self._servers)
        elif port in self._servers:
            raise RpcError("ALREADY_EXISTS", f"port {port} is taken")
        server = LoopbackServer(self, port, tables, interceptors)
        self._servers[port] = server
        return server, port


# -- clients --------------------------------------------------------------------


class RetryClient:
    """Async unary client for one service with bounded-retry semantics —
    the analog of the retry middleware every reference outbound call is
    wrapped in (reference src/util.rs:20, 25-29) — hardened with an
    exponential-backoff + jitter schedule and a transient-vs-fatal
    split: only TRANSIENT_CODES are retried (a sibling that answers
    INVALID_ARGUMENT will answer it identically N times), and the delay
    doubles per attempt with ±50% jitter so N restarting consensus nodes
    don't re-dial their controller in lockstep.  transport: None = the
    gRPC wire."""

    def __init__(self, address: str, service_name: str,
                 methods: Dict[str, tuple], retries: int = 3,
                 retry_delay_s: float = 0.3, max_delay_s: float = 5.0,
                 compat: Optional[str] = None, transport=None):
        transport = transport if transport is not None else GrpcTransport()
        self.address = address
        self._channel = transport.channel(address)
        self._retries = retries
        self._delay = retry_delay_s
        self._max_delay = max_delay_s
        self._rng = random.Random()  # jitter: deliberately unseeded
        full = full_service_name(service_name, compat)
        self._calls = {method: (f"/{full}/{method}", resp_cls)
                       for method, (_, resp_cls) in methods.items()}

    def _backoff_s(self, attempt: int) -> float:
        """Exponential backoff with ±50% jitter, capped."""
        base = min(self._delay * (2 ** attempt), self._max_delay)
        return base * (0.5 + self._rng.random())

    async def call(self, method: str, request, timeout: float = 10.0):
        # Propagate the current trace over the wire (the reference's
        # cloud_util::tracer propagation, src/main.rs:96): the active
        # request's trace id + span id become the outbound traceparent,
        # so cross-service traces survive the hop.
        from ..obs.logctx import span_context, trace_context
        metadata = None
        tid = trace_context.get()
        if tid != "-":
            span = span_context.get() or "0" * 16
            metadata = (("traceparent", f"00-{tid}-{span}-01"),)
        path, resp_cls = self._calls[method]
        data = request.SerializeToString()
        last_exc: Optional[Exception] = None
        for attempt in range(self._retries):
            try:
                reply = await self._channel.unary(path, data, timeout,
                                                  metadata)
            except RpcError as e:
                last_exc = e
                if not is_transient(e.code):
                    raise  # fatal: identical on every retry
                if attempt + 1 < self._retries:
                    delay = self._backoff_s(attempt)
                    logger.debug("%s transient %s; retry %d in %.2fs",
                                 method, e.code, attempt + 1, delay)
                    await asyncio.sleep(delay)
                continue
            try:
                return resp_cls.FromString(reply)
            except pb2.DecodeError as e:
                raise RpcError("INTERNAL", f"response parse: {e}") from e
        raise last_exc

    async def close(self) -> None:
        await self._channel.close()


class NetworkClient(RetryClient):
    """Client of the sibling network microservice (reference
    src/util.rs:25-44)."""

    def __init__(self, port: int, host: str = "localhost", **kw):
        super().__init__(f"{host}:{port}", "NetworkService",
                         NETWORK_SERVICE, **kw)

    async def register_network_msg_handler(self, module: str, hostname: str,
                                           port: int) -> int:
        resp = await self.call("RegisterNetworkMsgHandler", pb2.RegisterInfo(
            module_name=module, hostname=hostname, port=str(port)))
        return resp.code

    async def broadcast(self, msg: pb2.NetworkMsg) -> int:
        return (await self.call("Broadcast", msg)).code

    async def send_msg(self, msg: pb2.NetworkMsg) -> int:
        return (await self.call("SendMsg", msg)).code


class ControllerClient(RetryClient):
    """Client of the sibling controller microservice (reference
    src/util.rs:46-59)."""

    def __init__(self, port: int, host: str = "localhost", **kw):
        super().__init__(f"{host}:{port}", "Consensus2ControllerService",
                         CONTROLLER_SERVICE, **kw)

    async def get_proposal(self) -> pb2.ProposalResponse:
        return await self.call("GetProposal", pb2.Empty())

    async def check_proposal(self, height: int, data: bytes) -> int:
        resp = await self.call(
            "CheckProposal", pb2.Proposal(height=height, data=data))
        return resp.code

    async def commit_block(
            self, height: int, data: bytes,
            proof: bytes) -> pb2.ConsensusConfigurationResponse:
        return await self.call("CommitBlock", pb2.ProposalWithProof(
            proposal=pb2.Proposal(height=height, data=data), proof=proof))
