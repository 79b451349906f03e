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
                     `device_stage` records per-device stage timings
                     (`sharded_device_stage_seconds{device,stage}`) and
                     feeds an attached StragglerDetector
                     (`attach_straggler`, obs/fleet.py); with one device
                     set, every readback stage is that device's.

  annotate(name)   — a `torch.profiler.record_function` range, the
                     counterpart of the reference's
                     `jax.profiler.TraceAnnotation`: a torch.profiler
                     trace shows the annotated host span aligned with the
                     kernels it enqueued.

  ProfileSession   — config-gated torch.profiler capture (CPU and CUDA
                     activity) of whole consensus rounds into
                     `profile_dir`: every `profile_every_n_rounds`, or on
                     `/debug/profile?rounds=N`.  With no profile_dir every
                     method is a clean no-op.

Recording sits on the dispatch/resolve hot path — no formatting, no
I/O, never raises; rings are bounded; every hook is optional
(`prof=None` keeps the instrumented code on its unprofiled path).
"""

from __future__ import annotations

import logging
import os
import threading
import time
from collections import deque
from contextlib import nullcontext
from typing import Dict, List, Optional, Sequence

from .fleet import current_round_id, next_round_id

logger = logging.getLogger(__name__)

__all__ = ["DeviceProfiler", "NULL_CALL", "ProfileSession", "StagedCall",
           "annotate", "device_kind", "device_name"]


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
        #: {(device, stage): [count, total_s, last_s]} — the per-device
        #: attribution summary (obs/fleet.py's raw feed).
        self._device_stages: Dict[tuple, List[float]] = {}
        #: Optional StragglerDetector fed by device_stage().
        self.straggler = None

    # -- staged calls ------------------------------------------------------

    def begin(self, op: str, batch: int,
              padded: Optional[int] = None) -> StagedCall:
        # Tagged by the frontier's dispatcher (tag_round); a fresh id
        # otherwise, so every stage-ring record carries one.
        round_id = current_round_id()
        if round_id is None:
            round_id = next_round_id()
        return StagedCall(self, op, batch, padded, round_id=round_id)

    def attach_straggler(self, detector) -> None:
        """Feed every device_stage observation through a
        fleet.StragglerDetector (service/sim wiring)."""
        self.straggler = detector

    def observe_stage(self, op: str, stage: str, seconds: float) -> None:
        with self._lock:
            per_op = self._totals.setdefault(op, {})
            tot = per_op.setdefault(stage, [0, 0.0])
            tot[0] += 1
            tot[1] += seconds
        if self.metrics is not None:
            self.metrics.device_stage_seconds.labels(
                stage=stage, op=op).observe(seconds)
        if stage == "readback" and len(self._devices) == 1:
            # One device: the call's readback is that device's.
            self.device_stage(self._devices[0], stage, seconds)

    def device_stage(self, device: str, stage: str, seconds: float,
                     round_id: Optional[int] = None) -> None:
        """Per-device timing of one stage: lands in
        `sharded_device_stage_seconds{device,stage}`, the per-device
        summary, and the attached StragglerDetector."""
        device = str(device)
        with self._lock:
            tot = self._device_stages.setdefault((device, stage),
                                                 [0, 0.0, 0.0])
            tot[0] += 1
            tot[1] += seconds
            tot[2] = seconds
        if self.metrics is not None:
            self.metrics.sharded_device_stage_seconds.labels(
                device=device, stage=stage).observe(seconds)
        if self.straggler is not None:
            self.straggler.observe(device, stage, seconds,
                                   round_id=round_id)

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

    def device_stage_totals(self) -> Dict[str, dict]:
        """Per-device stage attribution, {device/stage: {count, total_s,
        last_s}} — the JSON form of sharded_device_stage_seconds."""
        with self._lock:
            return {f"{dev}/{stage}": {"count": int(c),
                                       "total_s": round(t, 6),
                                       "last_s": round(last, 6)}
                    for (dev, stage), (c, t, last)
                    in self._device_stages.items()}

    def summary(self) -> dict:
        """The JSON "profile" block: stage totals, the last occupancy,
        the device set and the number of records in the ring."""
        doc = {
            "crypto_device_stage_seconds": self.stage_totals(),
            "occupancy": self._last_occupancy,
            "devices": self._devices,
            "calls": len(self._ring),
        }
        device_stages = self.device_stage_totals()
        if device_stages:
            doc["device_stages"] = device_stages
        return doc

    def statusz(self, tail: int = 32) -> dict:
        """The /statusz "profile" section: summary + the recent ring."""
        doc = self.summary()
        doc["recent"] = self.tail(tail)
        return doc


#: torch.profiler is process-wide: held by the one running capture.
_CAPTURE = threading.Lock()


class ProfileSession:
    """Config-gated torch.profiler capture of whole consensus rounds.

    profile_dir      — where trace subdirectories land; None/"" disables
                       everything (every method a clean no-op).
    every_n_rounds   — start a one-round capture at every Nth round the
                       attached engine enters (0 = only explicit
                       requests via `request()` / the
                       /debug/profile?rounds=N trigger).

    The engine calls `on_round(height, round)` at each round entry
    (engine/smr.py); captures open and close on those boundaries so a
    trace file holds whole consensus rounds, aligned with the
    `annotate()`d frontier/dispatch/commit host spans.  A capture records
    CPU activity, and CUDA activity where a card is visible, and is
    written as `trace.json` (Chrome trace format) in its own
    subdirectory.  The profiler is process-wide, so one capture runs at
    a time across every session of a process."""

    def __init__(self, profile_dir: Optional[str] = None,
                 every_n_rounds: int = 0):
        self.profile_dir = profile_dir or None
        self.every_n_rounds = max(int(every_n_rounds or 0), 0)
        self._lock = threading.Lock()
        self._active_dir: Optional[str] = None
        self._profiler = None
        self._last_dir: Optional[str] = None
        self._rounds_left = 0
        self._round_ix = 0
        self._requested = 0
        self._captures = 0

    @property
    def available(self) -> bool:
        """Can this session capture at all?  (profile_dir configured AND
        torch.profiler importable.)"""
        if self.profile_dir is None:
            return False
        try:
            import torch.profiler  # noqa: F401, PLC0415
        except Exception:  # noqa: BLE001
            return False
        return True

    @property
    def active(self) -> bool:
        return self._active_dir is not None

    # -- capture control ---------------------------------------------------

    def start(self, rounds: int = 1, label: str = "manual") -> bool:
        """Begin a capture spanning the next `rounds` round entries (or
        until stop()).  False — never an exception — when unavailable or
        when a capture is already running in this process."""
        if not self.available:
            return False
        import torch  # noqa: PLC0415
        from torch.profiler import ProfilerActivity, profile  # noqa: PLC0415

        with self._lock:
            if self._active_dir is not None or not _CAPTURE.acquire(
                    blocking=False):
                return False
            trace_dir = os.path.join(
                self.profile_dir, f"{label}_{int(time.time() * 1000):x}")
            activities = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                activities.append(ProfilerActivity.CUDA)
            try:
                prof = profile(activities=activities)
                prof.start()
            except Exception as e:  # noqa: BLE001 — another tracer active
                _CAPTURE.release()
                logger.warning("profile start failed: %s", e)
                return False
            self._profiler = prof
            self._active_dir = trace_dir
            self._rounds_left = max(int(rounds), 1)
            self._captures += 1
            return True

    def stop(self) -> Optional[str]:
        """End the capture and write it; returns the trace directory
        (None if no capture was active)."""
        with self._lock:
            if self._active_dir is None:
                return None
            trace_dir, self._active_dir = self._active_dir, None
            prof, self._profiler = self._profiler, None
            self._last_dir = trace_dir
            self._rounds_left = 0
            try:
                prof.stop()
                os.makedirs(trace_dir, exist_ok=True)
                prof.export_chrome_trace(
                    os.path.join(trace_dir, "trace.json"))
            except Exception as e:  # noqa: BLE001
                logger.warning("profile stop failed: %s", e)
            finally:
                _CAPTURE.release()
            return trace_dir

    def request(self, rounds: int = 1) -> dict:
        """The /debug/profile?rounds=N trigger: capture the next N rounds
        (starting at the next round boundary).  Returns a status dict
        (JSON-encodable) describing what will happen."""
        if not self.available:
            return {"ok": False,
                    "reason": ("profile_dir not configured"
                               if self.profile_dir is None
                               else "torch.profiler unavailable")}
        with self._lock:
            self._requested = max(int(rounds), 1)
        return {"ok": True, "rounds": self._requested,
                "dir": self.profile_dir}

    def on_round(self, height: int, round_: int) -> None:
        """Round-boundary hook (engine/smr.py _enter_round).  Closes a
        capture whose round budget is spent, then opens one when a
        /debug/profile request is pending or the every_n_rounds cadence
        hits.  Hot-path cheap; never raises."""
        try:
            self._round_ix += 1
            if self.active:
                self._rounds_left -= 1
                if self._rounds_left > 0:
                    return
                # Fall through after closing: this same boundary may
                # start the next capture (every_n_rounds=1 means EVERY
                # round, and a pending request must not slip a round).
                self.stop()
            if self.profile_dir is None or self.active:
                return
            if self._requested > 0:
                rounds, self._requested = self._requested, 0
                self.start(rounds, label=f"req_h{height}")
            elif (self.every_n_rounds
                  and self._round_ix % self.every_n_rounds == 0):
                self.start(1, label=f"round_h{height}_r{round_}")
        except Exception:  # noqa: BLE001 — profiling never breaks SMR
            pass

    def status(self) -> dict:
        """JSON-encodable snapshot for /statusz."""
        return {
            "available": self.available,
            "dir": self.profile_dir,
            "active": self.active,
            "every_n_rounds": self.every_n_rounds,
            "captures": self._captures,
            "last_capture_dir": self._last_dir,
            "pending_request": self._requested,
        }
