"""Span export to a Jaeger agent — thrift compact protocol over UDP,
dependency-free.

The reference initializes its tracer with an optional Jaeger
`agent_endpoint` (reference src/main.rs:173-175, example/config.toml:14)
and ships every request span there.  No OpenTelemetry/Jaeger SDK is baked
into this environment, so the agent's wire format — a one-way
``emitBatch(Batch)`` thrift CALL in TCompactProtocol, datagram per batch —
is implemented directly below (~100 lines).  The encoding is pinned by
tests/test_tracing.py: a loopback UDP listener receives a batch and the
span's trace id / operation / service name are asserted present.

Span model (jaeger.thrift):
  Batch   { 1: Process process, 2: list<Span> spans }
  Process { 1: string serviceName }
  Span    { 1: i64 traceIdLow, 2: i64 traceIdHigh, 3: i64 spanId,
            4: i64 parentSpanId, 5: string operationName, 7: i32 flags,
            8: i64 startTime(µs), 9: i64 duration(µs), 10: list<Tag> }
  Tag     { 1: string key, 2: i32 vType(0=STRING), 3: string vStr }

The port's own copy of consensus_overlord_tpu/obs/tracing.py
(the port imports nothing of the JAX package).
"""

from __future__ import annotations

import logging
import queue
import secrets
import socket
import threading
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

logger = logging.getLogger("consensus_overlord_tpu_torch.tracing")

_DEFAULT_AGENT_PORT = 6831  # jaeger agent compact-thrift UDP


@dataclass
class Span:
    trace_id: int            # 128-bit
    span_id: int             # 64-bit
    parent_span_id: int      # 64-bit, 0 = root
    operation: str
    start_us: int
    duration_us: int
    tags: Dict[str, str] = field(default_factory=dict)


# -- thrift compact encoding -------------------------------------------------

_CT_I32 = 5
_CT_I64 = 6
_CT_BINARY = 8
_CT_LIST = 9
_CT_STRUCT = 12


def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _zigzag64(v: int) -> int:
    v &= (1 << 64) - 1
    if v >= 1 << 63:
        v -= 1 << 64
    return ((v << 1) ^ (v >> 63)) & ((1 << 64) - 1)


def _zigzag32(v: int) -> int:
    v &= (1 << 32) - 1
    if v >= 1 << 31:
        v -= 1 << 32
    return ((v << 1) ^ (v >> 31)) & ((1 << 32) - 1)


class _Struct:
    """Field writer tracking the compact protocol's field-id deltas."""

    def __init__(self):
        self.buf = bytearray()
        self._last = 0

    def _header(self, fid: int, ctype: int) -> None:
        delta = fid - self._last
        if 0 < delta < 16:
            self.buf.append((delta << 4) | ctype)
        else:
            self.buf.append(ctype)
            self.buf += _varint(_zigzag32(fid) & 0xFFFF)
        self._last = fid

    def i32(self, fid: int, v: int) -> None:
        self._header(fid, _CT_I32)
        self.buf += _varint(_zigzag32(v))

    def i64(self, fid: int, v: int) -> None:
        self._header(fid, _CT_I64)
        self.buf += _varint(_zigzag64(v))

    def string(self, fid: int, s: str) -> None:
        raw = s.encode()
        self._header(fid, _CT_BINARY)
        self.buf += _varint(len(raw)) + raw

    def list_of_structs(self, fid: int, items: List[bytes]) -> None:
        self._header(fid, _CT_LIST)
        if len(items) < 15:
            self.buf.append((len(items) << 4) | _CT_STRUCT)
        else:
            self.buf.append(0xF0 | _CT_STRUCT)
            self.buf += _varint(len(items))
        for it in items:
            self.buf += it

    def struct(self, fid: int, inner: bytes) -> None:
        self._header(fid, _CT_STRUCT)
        self.buf += inner

    def done(self) -> bytes:
        return bytes(self.buf) + b"\x00"


def _encode_tag(key: str, val: str) -> bytes:
    s = _Struct()
    s.string(1, key)
    s.i32(2, 0)  # vType STRING
    s.string(3, val)
    return s.done()


def _encode_span(sp: Span) -> bytes:
    s = _Struct()
    s.i64(1, sp.trace_id & ((1 << 64) - 1))
    s.i64(2, sp.trace_id >> 64)
    s.i64(3, sp.span_id)
    s.i64(4, sp.parent_span_id)
    s.string(5, sp.operation)
    s.i32(7, 1)  # flags: sampled
    s.i64(8, sp.start_us)
    s.i64(9, sp.duration_us)
    if sp.tags:
        s.list_of_structs(10, [_encode_tag(k, v)
                               for k, v in sorted(sp.tags.items())])
    return s.done()


def encode_batch(service_name: str, spans: List[Span]) -> bytes:
    """One ``emitBatch`` compact-protocol CALL message (= one datagram)."""
    proc = _Struct()
    proc.string(1, service_name)
    batch = _Struct()
    batch.struct(1, proc.done())
    batch.list_of_structs(2, [_encode_span(sp) for sp in spans])
    args = _Struct()
    args.struct(1, batch.done())
    head = bytes([0x82, 0x21])  # protocol id; version 1 | (CALL << 5)
    head += _varint(0)  # seqid
    name = b"emitBatch"
    head += _varint(len(name)) + name
    return head + args.done()


# -- exporter ---------------------------------------------------------------

class JaegerExporter:
    """Queue + background thread shipping span batches to the agent.
    Lossy by design (UDP, bounded queue): tracing never backpressures
    consensus."""

    def __init__(self, agent_endpoint: str, service_name: str = "consensus",
                 max_batch: int = 32, linger_s: float = 0.5):
        host, _, port = agent_endpoint.partition(":")
        self._addr: Tuple[str, int] = (host or "127.0.0.1",
                                       int(port) if port
                                       else _DEFAULT_AGENT_PORT)
        self._service = service_name
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self._queue: "queue.Queue[Optional[Span]]" = queue.Queue(maxsize=4096)
        self._max_batch = max_batch
        self._linger = linger_s
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="jaeger-export")
        self._thread.start()

    def report(self, span: Span) -> None:
        try:
            self._queue.put_nowait(span)
        except queue.Full:  # drop — never block the caller
            pass

    def close(self) -> None:
        # Event first: even with the queue full (sentinel dropped), the
        # worker notices within one linger tick and exits.
        self._stop.set()
        try:
            self._queue.put_nowait(None)
        except queue.Full:
            pass
        self._thread.join(timeout=2.0)
        self._sock.close()

    def _run(self) -> None:
        while True:
            batch: List[Span] = []
            try:
                item = self._queue.get(timeout=self._linger)
            except queue.Empty:
                if self._stop.is_set():
                    return
                continue
            if item is None:
                return
            batch.append(item)
            while len(batch) < self._max_batch:
                try:
                    item = self._queue.get_nowait()
                except queue.Empty:
                    break
                if item is None:
                    self._flush(batch)
                    return
                batch.append(item)
            self._flush(batch)

    def _flush(self, batch: List[Span]) -> None:
        if not batch:
            return
        try:
            self._sock.sendto(encode_batch(self._service, batch), self._addr)
        except OSError as e:  # pragma: no cover — agent down is non-fatal
            logger.debug("jaeger send failed: %s", e)


def new_span_id() -> int:
    return int.from_bytes(secrets.token_bytes(8), "big") or 1


def new_trace_id() -> int:
    return int.from_bytes(secrets.token_bytes(16), "big") or 1
