"""Per-call device profiling: staged round profiles of the provider's
device crypto ops.

The part of consensus_overlord_tpu/obs/prof.py the provider binds, as
the port's own copy:

  DeviceProfiler   — staged per-call profiles for the device crypto ops.
                     A provider opens a `StagedCall` per dispatch
                     (op = verify_batch / aggregate / verify_aggregated),
                     marks the stage split (parse / dispatch / readback /
                     pairing), and finishes it at resolve time.  Every
                     stage lands in `crypto_device_stage_seconds{stage,op}`
                     of a bound metric surface; the batch's real/padded
                     shape drives the `crypto_device_batch_occupancy`
                     gauge; the finished record enters a bounded ring.
                     `set_devices` fills `mesh_devices` / `device_kind`.

  annotate(name)   — a `torch.profiler.record_function` range, the
                     counterpart of the reference's
                     `jax.profiler.TraceAnnotation`: a torch.profiler
                     trace shows the annotated host span aligned with the
                     kernels it enqueued.

The capture session (ProfileSession) is not ported yet.  Recording sits
on the dispatch/resolve hot path — no formatting, no I/O, never raises;
rings are bounded; every hook is optional (`prof=None` keeps the
instrumented code on its unprofiled path).
"""

from __future__ import annotations

import logging
import threading
import time
from collections import deque
from contextlib import nullcontext
from typing import Dict, List, Optional, Sequence

from .fleet import current_round_id, next_round_id

logger = logging.getLogger(__name__)

__all__ = ["DeviceProfiler", "NULL_CALL", "StagedCall", "annotate",
           "device_kind", "device_name"]


def annotate(name: str):
    """A torch.profiler range named `name` (a cheap no-op record while no
    trace is active), or a nullcontext if the profiler cannot open one."""
    try:
        from torch.profiler import record_function  # noqa: PLC0415
        return record_function(name)
    except Exception:  # noqa: BLE001 — profiling never breaks the path
        return nullcontext()


def device_name(device) -> str:
    """A torch device as "type:index" (index 0 when it names none), the
    lane name of the chaos hooks and the profiler's device list."""
    index = device.index if device.index is not None else 0
    return f"{device.type}:{index}"


def device_kind(device) -> str:
    """The card's name for a CUDA device, else the device type."""
    if device.type == "cuda":
        import torch  # noqa: PLC0415 — obs/ itself needs no torch
        return torch.cuda.get_device_name(device)
    return device.type


class StagedCall:
    """One in-flight device-path call being profiled.  Created by
    `DeviceProfiler.begin`; the provider observes stage durations as it
    crosses each boundary (possibly from different threads — dispatch
    happens on the frontier's worker, resolve on a resolver thread; the
    stages are strictly sequential in time, so plain attribute writes
    are safe) and calls `finish()` once the result is in hand."""

    __slots__ = ("_prof", "op", "batch", "padded", "ts", "stages",
                 "stages_at_s", "round_id", "_done")

    def __init__(self, prof: "DeviceProfiler", op: str, batch: int,
                 padded: Optional[int] = None,
                 round_id: Optional[int] = None):
        self._prof = prof
        self.op = op
        self.batch = int(batch)
        self.padded = int(padded) if padded else None
        self.ts = time.time()
        self.stages: Dict[str, float] = {}
        #: Offset (seconds since `ts`) at which each stage COMPLETED —
        #: with `stages` (durations) this is enough to reconstruct the
        #: round waterfall (start = at - duration) without putting a
        #: second clock read on every boundary.
        self.stages_at_s: Dict[str, float] = {}
        #: The frontier flush this call serves (obs/fleet.py tag_round,
        #: read off the dispatcher thread); freshly drawn when untagged
        #: so ad-hoc/sim calls are still one-call-one-round.
        self.round_id = round_id
        self._done = False

    def observe(self, stage: str, seconds: float) -> None:
        """One stage took `seconds`.  Repeated observations of a stage
        accumulate (a split dispatch plan crosses 'dispatch' once per
        sub-batch)."""
        try:
            self.stages[stage] = self.stages.get(stage, 0.0) + seconds
            self.stages_at_s[stage] = time.time() - self.ts
            self._prof.observe_stage(self.op, stage, seconds)
        except Exception:  # noqa: BLE001 — profiling never breaks crypto
            pass

    def pad(self, batch: int, padded: int) -> None:
        """Record the batch's padded shape (drives the occupancy gauge)."""
        try:
            self.batch = int(batch)
            self.padded = int(padded)
            self._prof.occupancy(batch, padded)
        except Exception:  # noqa: BLE001
            pass

    def finish(self, ok: bool = True) -> None:
        """Push the completed record into the profiler's ring.  Safe to
        call more than once (only the first wins) and never raises."""
        if self._done:
            return
        self._done = True
        try:
            self._prof.complete(self, ok)
        except Exception:  # noqa: BLE001
            pass


class _NullCall:
    """The no-profiler twin of StagedCall: every hook is a no-op, so
    instrumented providers run one truthy-check of overhead when no
    profiler is bound."""

    __slots__ = ()

    def observe(self, stage: str, seconds: float) -> None:
        pass

    def pad(self, batch: int, padded: int) -> None:
        pass

    def finish(self, ok: bool = True) -> None:
        pass


NULL_CALL = _NullCall()


class DeviceProfiler:
    """The device-side profile surface: staged per-call records and the
    device set, optionally mirrored into a metric surface with the JAX
    package's obs.Metrics attribute names.

    One per node (like Metrics); `capacity` bounds the per-call ring so
    observability can't grow memory under sustained load."""

    def __init__(self, metrics=None, capacity: int = 256):
        self.metrics = metrics
        self._ring: deque = deque(maxlen=max(int(capacity), 1))
        self._seq = 0
        self._lock = threading.Lock()  # seq + cumulative stage totals
        #: cumulative {op: {stage: [count, total_seconds]}} — the cheap
        #: aggregation a JSON summary embeds without a registry scrape.
        self._totals: Dict[str, Dict[str, List[float]]] = {}
        self._last_occupancy: Optional[float] = None
        self._devices: List[str] = []

    # -- staged calls ------------------------------------------------------

    def begin(self, op: str, batch: int,
              padded: Optional[int] = None) -> StagedCall:
        # Tagged by the frontier's dispatcher (tag_round); a fresh id
        # otherwise, so every stage-ring record carries one.
        round_id = current_round_id()
        if round_id is None:
            round_id = next_round_id()
        return StagedCall(self, op, batch, padded, round_id=round_id)

    def observe_stage(self, op: str, stage: str, seconds: float) -> None:
        with self._lock:
            per_op = self._totals.setdefault(op, {})
            tot = per_op.setdefault(stage, [0, 0.0])
            tot[0] += 1
            tot[1] += seconds
        if self.metrics is not None:
            self.metrics.device_stage_seconds.labels(
                stage=stage, op=op).observe(seconds)

    def occupancy(self, batch: int, padded: int) -> None:
        """Real lanes / padded lanes of the batch being dispatched."""
        if padded <= 0:
            return
        occ = batch / padded
        self._last_occupancy = occ
        if self.metrics is not None:
            self.metrics.device_batch_occupancy.set(occ)

    def complete(self, call: StagedCall, ok: bool) -> None:
        with self._lock:
            self._seq += 1
            seq = self._seq
        record = {"seq": seq, "ts": call.ts, "op": call.op,
                  "batch": call.batch, "ok": bool(ok),
                  "stages_s": {k: round(v, 6)
                               for k, v in call.stages.items()}}
        if call.round_id is not None:
            record["round_id"] = call.round_id
        if call.stages_at_s:
            record["stages_at_s"] = {k: round(v, 6)
                                     for k, v in call.stages_at_s.items()}
        if call.padded:
            record["padded"] = call.padded
            record["occupancy"] = round(call.batch / call.padded, 4)
        self._ring.append(record)

    # -- device set -------------------------------------------------------

    def set_devices(self, devices: Sequence) -> None:
        """Record the device set a provider dispatches to: `mesh_devices`
        (count) + `device_kind{kind}` (1 per distinct kind present — a
        heterogeneous set is itself a finding).  Takes torch devices:
        each is named "type:index" and its kind is the card's name."""
        try:
            names = [device_name(d) for d in devices]
            kinds = sorted({device_kind(d) for d in devices})
        except Exception:  # noqa: BLE001 — exotic device objects
            names, kinds = [str(d) for d in devices], ["unknown"]
        self._devices = names
        if self.metrics is not None:
            self.metrics.mesh_devices.set(len(names))
            for kind in kinds:
                self.metrics.device_kind.labels(kind=kind).set(1)

    # -- read side ---------------------------------------------------------

    def tail(self, n: Optional[int] = None) -> List[dict]:
        """Newest `n` per-call records, oldest first."""
        records = list(self._ring)  # snapshot: writers may be appending
        if n is not None:
            records = records[-n:] if n > 0 else []
        return records

    def stage_totals(self) -> Dict[str, dict]:
        """Cumulative {op/stage: {count, total_s}} — the JSON-summary
        form of crypto_device_stage_seconds."""
        with self._lock:
            return {f"{op}/{stage}": {"count": int(c),
                                      "total_s": round(s, 6)}
                    for op, stages in self._totals.items()
                    for stage, (c, s) in stages.items()}

    def summary(self) -> dict:
        """The JSON "profile" block: stage totals, the last occupancy,
        the device set and the number of records in the ring."""
        return {
            "crypto_device_stage_seconds": self.stage_totals(),
            "occupancy": self._last_occupancy,
            "devices": self._devices,
            "calls": len(self._ring),
        }

    def statusz(self, tail: int = 32) -> dict:
        """The /statusz "profile" section: summary + the recent ring."""
        doc = self.summary()
        doc["recent"] = self.tail(tail)
        return doc
