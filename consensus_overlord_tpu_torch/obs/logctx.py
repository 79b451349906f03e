"""Logging init + distributed trace-context propagation.

The reference initializes a tracer from the TOML log config (rolling file,
level, optional Jaeger agent; reference src/main.rs:173-175, README.md:58-63)
and restores the W3C trace parent from inbound gRPC metadata on every
handler (`cloud_util::tracer::set_parent`, src/main.rs:96, 111, 137).

Here: stdlib logging configured from LogConfig, and a server middleware
that parses the `traceparent` metadata key into a contextvar which a log
filter stamps onto every record — so one request's log lines across
engine/frontier/brain share its trace id, greppable end-to-end.

The port's own copy of consensus_overlord_tpu/obs/logctx.py.  The
middleware (`TraceContext`) is transport-neutral; `TraceContextInterceptor`,
its grpc.aio.ServerInterceptor form, is built on first use, since only
the gRPC wire imports `grpc`.
"""

from __future__ import annotations

import contextvars
import logging
import logging.handlers
import re
import time
from typing import Optional

#: current request's trace id ("-" outside any traced request)
trace_context: contextvars.ContextVar[str] = contextvars.ContextVar(
    "trace_context", default="-")
#: current request's span id (hex16; "" outside any traced request).
#: Outbound calls use it as the parent when injecting traceparent
#: (service/rpc.py RetryClient.call).
span_context: contextvars.ContextVar[str] = contextvars.ContextVar(
    "span_context", default="")

_FORMAT = ("%(asctime)s %(levelname)-5s %(name)s "
           "[trace=%(trace_id)s] %(message)s")


class _TraceFilter(logging.Filter):
    def filter(self, record: logging.LogRecord) -> bool:
        record.trace_id = trace_context.get()
        return True


def init_logging(log_config=None, service_name: str = "consensus") -> None:
    """Configure root logging per LogConfig (service/config.py): level from
    max_level, optional rolling file via rolling_file_path (the reference's
    rolling-file tracer output, README.md:62)."""
    level = getattr(logging, (log_config.max_level if log_config else
                              "info").upper(), logging.INFO)
    handlers: list = [logging.StreamHandler()]
    if log_config is not None and log_config.rolling_file_path:
        handlers.append(logging.handlers.RotatingFileHandler(
            log_config.rolling_file_path, maxBytes=64 << 20, backupCount=4))
    trace_filter = _TraceFilter()
    for h in handlers:
        h.setFormatter(logging.Formatter(_FORMAT))
        h.addFilter(trace_filter)
    root = logging.getLogger()
    root.setLevel(level)
    root.handlers = handlers


_TRACEPARENT_FULL_RE = re.compile(
    r"^[0-9a-f]{2}-([0-9a-f]{32})-([0-9a-f]{16})-[0-9a-f]{2}$")


class TraceContext:
    """Extract `traceparent` from request metadata into the contextvars —
    the set_parent analog (reference src/main.rs:96, 111, 137) — and,
    when a span exporter is configured (log_config.agent_endpoint,
    reference src/main.rs:173-175), record one server span per request
    with the inbound span as parent.  Transport-neutral server
    middleware: `wrap(method, metadata, inner)` returns the handler to
    run (service/rpc.py)."""

    def __init__(self, exporter=None):
        #: obs.tracing.JaegerExporter (or None: context-only, no export)
        self._exporter = exporter

    def wrap(self, method: str, metadata, inner):
        trace_id: Optional[str] = None
        parent_span: int = 0
        for key, value in metadata or ():
            if key == "traceparent" and isinstance(value, str):
                m = _TRACEPARENT_FULL_RE.match(value)
                if m:
                    trace_id = m.group(1)
                    parent_span = int(m.group(2), 16)
        if trace_id is None and self._exporter is None:
            return inner  # nothing to propagate, nothing to record
        exporter = self._exporter
        operation = method or "rpc"

        from .tracing import Span, new_span_id, new_trace_id

        tid = trace_id if trace_id is not None else f"{new_trace_id():032x}"
        pspan = parent_span

        async def with_ctx(request, context):
            span_id = new_span_id()
            t_token = trace_context.set(tid)
            s_token = span_context.set(f"{span_id:016x}")
            start = time.time()
            try:
                return await inner(request, context)
            finally:
                if exporter is not None:
                    exporter.report(Span(
                        trace_id=int(tid, 16), span_id=span_id,
                        parent_span_id=pspan, operation=operation,
                        start_us=int(start * 1e6),
                        duration_us=int((time.time() - start) * 1e6)))
                span_context.reset(s_token)
                trace_context.reset(t_token)

        return with_ctx


def __getattr__(name):
    if name == "TraceContextInterceptor":
        from ..service.rpc import grpc_interceptor_class

        cls = grpc_interceptor_class(TraceContext, name)
        globals()[name] = cls
        return cls
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
