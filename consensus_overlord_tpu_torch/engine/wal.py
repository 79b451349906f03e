"""File-backed write-ahead log.

Mirrors the reference's ConsensusWal (src/consensus.rs:295-332): one
overwrite-in-place file `<wal_path>/overlord.wal` with set/get semantics, the
directory auto-created at construction (src/consensus.rs:303-311), a lock
guarding concurrent save/load (src/consensus.rs:299), and load returning None
when nothing was ever saved (src/consensus.rs:324-331).

Two hardenings over the reference's bare fs::write/fs::read:

  * the overwrite is atomic (write-to-temp + rename), so a crash mid-save
    can never leave a half-written file behind;
  * every record is framed (magic + version + CRC32 + length) and load
    VERIFIES the frame.  A torn, bit-flipped, or legacy unframed file is
    quarantined to `overlord.wal.corrupt` and reported as empty —
    recovery proceeds from chain state (the controller's RichStatus
    resync) instead of feeding garbage into RLP decode.  The reference
    would panic-or-garbage here; a WAL must never be the thing that
    keeps a restarted validator down.

Every save happens on the consensus critical path (write-ahead of each
vote cast), so both WALs accept an optional obs.Metrics and observe
append latency — the file WAL additionally isolates the fsync portion,
the usual stall source on loaded disks.

The port's own copy of consensus_overlord_tpu/engine/wal.py
(the port imports nothing of the JAX package).
"""

from __future__ import annotations

import asyncio
import logging
import os
import struct
import time
import zlib
from typing import Optional

logger = logging.getLogger("consensus_overlord_tpu_torch.wal")

OVERLORD_WAL_NAME = "overlord.wal"  # reference src/consensus.rs:301
#: Quarantine suffix for corrupt WAL files (kept beside the live path so
#: a post-mortem can still decode whatever survived).
CORRUPT_SUFFIX = ".corrupt"

#: Record frame: magic(4) | version(1) | payload_crc32(4, BE) |
#: payload_len(4, BE) | payload.  The CRC covers the payload only; the
#: length field catches truncation before the CRC is even computed.
WAL_MAGIC = b"OWAL"
WAL_VERSION = 1
_HEADER = struct.Struct(">4sBII")


class WalCorruption(Exception):
    """A WAL blob failed frame validation (reason in str())."""


def frame_record(payload: bytes) -> bytes:
    """Wrap one WAL payload in the integrity frame."""
    return _HEADER.pack(WAL_MAGIC, WAL_VERSION,
                        zlib.crc32(payload) & 0xFFFFFFFF,
                        len(payload)) + payload


def unframe_record(blob: bytes) -> bytes:
    """Validate + strip the frame; raises WalCorruption on any mismatch
    (bad magic — including legacy unframed files — unknown version,
    truncation, trailing garbage, CRC failure)."""
    if len(blob) < _HEADER.size:
        raise WalCorruption(f"short header ({len(blob)} bytes)")
    magic, version, crc, length = _HEADER.unpack_from(blob)
    if magic != WAL_MAGIC:
        raise WalCorruption("bad magic (legacy unframed or foreign file)")
    if version != WAL_VERSION:
        raise WalCorruption(f"unknown version {version}")
    payload = blob[_HEADER.size:]
    if len(payload) != length:
        raise WalCorruption(
            f"length mismatch: header says {length}, have {len(payload)}")
    if zlib.crc32(payload) & 0xFFFFFFFF != crc:
        raise WalCorruption("CRC mismatch (bit rot or torn write)")
    return payload


class FileWal:
    def __init__(self, wal_path: str, metrics=None, recorder=None):
        os.makedirs(wal_path, exist_ok=True)
        self._path = os.path.join(wal_path, OVERLORD_WAL_NAME)
        self._tmp_path = self._path + ".tmp"
        self._lock = asyncio.Lock()
        self._metrics = metrics
        self._recorder = recorder
        #: Path the last corrupt file was quarantined to (None = never).
        self.quarantined_path: Optional[str] = None

    async def save(self, data: bytes) -> None:
        async with self._lock:
            await asyncio.to_thread(self._write_atomic, bytes(data))

    def _write_atomic(self, data: bytes) -> None:
        t0 = time.perf_counter()
        with open(self._tmp_path, "wb") as f:
            f.write(frame_record(data))
            f.flush()
            t_sync = time.perf_counter()
            os.fsync(f.fileno())
            fsync_s = time.perf_counter() - t_sync
        os.replace(self._tmp_path, self._path)
        if self._metrics is not None:
            self._metrics.wal_fsync_ms.observe(fsync_s * 1000.0)
            self._metrics.wal_append_ms.observe(
                (time.perf_counter() - t0) * 1000.0)

    def size_bytes(self) -> int:
        """On-disk size of the live WAL file (0 = never saved).  The
        soak sampler's WAL-growth series (obs/telemetry.py): the
        overwrite-in-place design means this should track the engine's
        state-blob size, not grow monotonically — unbounded growth here
        IS the finding."""
        try:
            return os.path.getsize(self._path)
        except OSError:
            return 0

    async def load(self) -> Optional[bytes]:
        async with self._lock:
            return await asyncio.to_thread(self._read)

    def _read(self) -> Optional[bytes]:
        try:
            with open(self._path, "rb") as f:
                blob = f.read()
        except FileNotFoundError:
            return None
        if not blob:
            return None  # zero bytes: nothing was ever saved
        try:
            return unframe_record(blob)
        except WalCorruption as e:
            self._quarantine(str(e))
            return None

    def _quarantine(self, reason: str) -> None:
        """Move the corrupt file aside and report empty: recovery must
        proceed (from chain state) rather than crash-loop on garbage."""
        target = self._path + CORRUPT_SUFFIX
        moved = True
        try:
            os.replace(self._path, target)
            self.quarantined_path = target
        except OSError:  # the file vanished or FS is read-only: proceed
            moved = False
            logger.exception("WAL quarantine rename failed")
        # The breadcrumbs must say what actually happened: an operator
        # chasing a wal_corrupt event goes looking for the .corrupt file.
        if moved:
            logger.warning("corrupt WAL quarantined to %s: %s", target,
                           reason)
        else:
            logger.warning("corrupt WAL ignored (quarantine rename "
                           "FAILED, file left in place): %s", reason)
        if self._metrics is not None:
            self._metrics.wal_corruptions.inc()
        if self._recorder is not None:
            self._recorder.record("wal_corrupt", reason=reason,
                                  quarantined=target if moved else None)


class MemoryWal:
    """In-process WAL for simulations and tests.  Stores the FRAMED blob
    and validates it on load — the same integrity path as FileWal, so
    engine tests exercise production corruption semantics (bit-flip
    `wal.data` and load() quarantines + returns None).  Observes append
    latency (if given metrics) so sim runs exercise the same metric
    surface as a production FileWal — minus the fsync, which has no
    analog here."""

    def __init__(self, metrics=None, recorder=None):
        #: The framed blob exactly as FileWal would put it on disk.
        self.data: Optional[bytes] = None
        #: Last corrupt blob, moved aside on a failed load (the in-memory
        #: twin of FileWal's `overlord.wal.corrupt`).
        self.quarantined: Optional[bytes] = None
        self._metrics = metrics
        self._recorder = recorder

    async def save(self, data: bytes) -> None:
        t0 = time.perf_counter()
        self.data = frame_record(bytes(data))
        if self._metrics is not None:
            self._metrics.wal_append_ms.observe(
                (time.perf_counter() - t0) * 1000.0)

    def size_bytes(self) -> int:
        """Framed-blob size — the FileWal twin, so sim soaks chart the
        same WAL-growth series a production FileWal would."""
        return len(self.data) if self.data is not None else 0

    async def load(self) -> Optional[bytes]:
        if self.data is None:
            return None
        try:
            return unframe_record(self.data)
        except WalCorruption as e:
            self.quarantined, self.data = self.data, None
            logger.warning("corrupt MemoryWal quarantined: %s", e)
            if self._metrics is not None:
                self._metrics.wal_corruptions.inc()
            if self._recorder is not None:
                self._recorder.record("wal_corrupt", reason=str(e),
                                      quarantined="<memory>")
            return None
