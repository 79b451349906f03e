"""Fleet observability: round tagging, straggler detection, cross-host
telemetry aggregation.

A multi-device deployment asks three questions the single-host
profiling substrate (DeviceProfiler, TelemetrySampler) can't answer:

  * WHICH device is slow?  Every stage number is a mesh aggregate — a
    straggling chip is indistinguishable from uniform slowness.
    `StragglerDetector` keeps a per-(device, stage) rolling window of
    the per-device shard-fetch timings the provider already measures
    (`DeviceProfiler.device_stage`), compares each device's rolling
    median against the mesh median for that stage, and flags any device
    whose skew ratio exceeds a configurable threshold (default 1.5x) —
    a `straggler` flightrec event, `mesh_straggler_total{device,stage}`,
    and the /statusz "mesh" section.

  * WHICH host is drifting?  Each host's TelemetrySampler already
    serializes its trend block under /statusz "trend"; `FleetAggregator`
    (host 0) pulls peers' /statusz over the same loopback-style HTTP
    exporter that serves /metrics and merges per-host RSS/WAL/occupancy
    rows plus a max-skew summary into the /statusz "fleet" section.
    With no peers configured it degrades to a single-host view of the
    local trend — the degenerate mode CPU CI exercises.

  * WHICH round was slow?  `next_round_id()` hands the frontier a
    process-monotonic round id at each flush; `tag_round` carries it
    onto the dispatcher thread (plain thread-local — the frontier's
    executor serializes dispatches, and `loop.run_in_executor` does not
    propagate contextvars) so DeviceProfiler.begin stamps it into every
    stage-ring record and the flush's flightrec events.
    scripts/waterfall.py joins the two streams on that id.

Same posture as prof.py/flightrec.py: every hook optional, recording
never raises, rings bounded, stdlib-only (urllib for the peer pull).

The port's own copy of consensus_overlord_tpu/obs/fleet.py.  On one
card the straggler detector sees one device (obs/prof.py feeds it each
readback), so it never flags: it needs two devices to compare.
"""

from __future__ import annotations

import itertools
import json
import statistics
import threading
import time
import urllib.request
from collections import deque
from contextlib import contextmanager
from typing import Callable, Dict, List, Optional, Sequence, Tuple

__all__ = ["FleetAggregator", "StragglerDetector", "current_round_id",
           "next_round_id", "tag_round"]

# ---------------------------------------------------------------------------
# round tagging (frontier flush -> dispatch -> readback -> verdict)
# ---------------------------------------------------------------------------

_round_counter = itertools.count(1)
_round_tls = threading.local()


def next_round_id() -> int:
    """A process-monotonic round id.  The frontier draws one per flush;
    everything the flush touches (flightrec events, stage-ring records)
    carries it so scripts/waterfall.py can reassemble the timeline."""
    return next(_round_counter)


def current_round_id() -> Optional[int]:
    """The round id tagged on THIS thread (None outside a tag_round
    scope) — DeviceProfiler.begin reads it to stamp StagedCalls."""
    return getattr(_round_tls, "round_id", None)


@contextmanager
def tag_round(round_id: Optional[int]):
    """Tag the current thread with `round_id` for the duration of the
    block.  A plain thread-local, NOT a contextvar: the frontier hands
    work to its dispatcher thread via `loop.run_in_executor`, which
    does not propagate contextvars — the executor callable re-enters
    this context on the worker thread instead.  Nests safely (restores
    the outer tag on exit)."""
    prev = getattr(_round_tls, "round_id", None)
    _round_tls.round_id = round_id
    try:
        yield round_id
    finally:
        _round_tls.round_id = prev


# ---------------------------------------------------------------------------
# straggler detection
# ---------------------------------------------------------------------------

class StragglerDetector:
    """Rolling per-device skew detector over the per-(device, stage)
    timings `DeviceProfiler.device_stage` feeds it.

    Model: for each stage, every device keeps a bounded window of its
    recent timings; a device is a straggler when its rolling median
    exceeds `ratio` x the mesh median (median of the per-device
    medians — robust to the straggler itself dragging a mean).  Each
    flag increments `mesh_straggler_total{device,stage}`, records a
    `straggler` flightrec event, and lands in the /statusz "mesh"
    section's per-device rows.

    min_samples gates flagging until a device has enough history that a
    single cold-cache fetch can't trip it; the comparison also needs at
    least two devices reporting (a 1-device mesh has no skew).
    min_excess_s is an absolute noise floor: when per-shard timings sit
    at the microsecond scale (virtual CPU lanes, tiny shards) relative
    jitter routinely exceeds any sane ratio, so a device must also run
    at least this much slower than the mesh median before it flags.
    """

    def __init__(self, metrics=None, recorder=None, ratio: float = 1.5,
                 window: int = 32, min_samples: int = 3,
                 min_excess_s: float = 1e-3):
        self.metrics = metrics
        self.recorder = recorder
        self.ratio = max(float(ratio), 1.0)
        self.window = max(int(window), 2)
        self.min_samples = max(int(min_samples), 1)
        self.min_excess_s = max(float(min_excess_s), 0.0)
        self._lock = threading.Lock()
        #: {stage: {device: deque[seconds]}}
        self._series: Dict[str, Dict[str, deque]] = {}
        #: {(device, stage): flag count} — the /statusz + test surface.
        self._flags: Dict[Tuple[str, str], int] = {}
        self._last_flag: Optional[dict] = None

    def observe(self, device: str, stage: str, seconds: float,
                round_id: Optional[int] = None) -> bool:
        """One per-device stage timing.  Returns True when this
        observation flagged `device` as a straggler.  Never raises."""
        try:
            return self._observe(str(device), str(stage), float(seconds),
                                 round_id)
        except Exception:  # noqa: BLE001 — detection never breaks crypto
            return False

    def _observe(self, device: str, stage: str, seconds: float,
                 round_id: Optional[int]) -> bool:
        with self._lock:
            per_stage = self._series.setdefault(stage, {})
            series = per_stage.setdefault(
                device, deque(maxlen=self.window))
            series.append(seconds)
            if len(series) < self.min_samples or len(per_stage) < 2:
                return False
            medians = {d: statistics.median(s)
                       for d, s in per_stage.items()
                       if len(s) >= self.min_samples}
            if len(medians) < 2 or device not in medians:
                return False
            mesh_median = statistics.median(medians.values())
            if mesh_median <= 0:
                return False
            skew = medians[device] / mesh_median
            if skew <= self.ratio:
                return False
            if medians[device] - mesh_median <= self.min_excess_s:
                return False
            self._flags[(device, stage)] = \
                self._flags.get((device, stage), 0) + 1
            flag = {"ts": time.time(), "device": device, "stage": stage,
                    "skew": round(skew, 3),
                    "median_s": round(medians[device], 6),
                    "mesh_median_s": round(mesh_median, 6)}
            if round_id is not None:
                flag["round_id"] = round_id
            self._last_flag = flag
        if self.metrics is not None:
            try:
                self.metrics.mesh_straggler_total.labels(
                    device=device, stage=stage).inc()
            except Exception:  # noqa: BLE001
                pass
        if self.recorder is not None:
            self.recorder.record("straggler", **flag)
        return True

    # -- read side ---------------------------------------------------------

    def flag_count(self, device: Optional[str] = None) -> int:
        """Total flags (optionally for one device) — the soak gate and
        the seeded-injection CI assertion read this."""
        with self._lock:
            return sum(n for (d, _), n in self._flags.items()
                       if device is None or d == device)

    def flagged_devices(self) -> List[str]:
        with self._lock:
            return sorted({d for (d, _), n in self._flags.items() if n})

    def statusz(self) -> dict:
        """The /statusz "mesh" section: per-device rolling medians and
        skew ratio per stage, plus cumulative flag counts."""
        with self._lock:
            stages: Dict[str, dict] = {}
            for stage, per_stage in self._series.items():
                medians = {d: statistics.median(s)
                           for d, s in per_stage.items() if s}
                mesh_median = (statistics.median(medians.values())
                               if medians else None)
                stages[stage] = {
                    "mesh_median_s": (round(mesh_median, 6)
                                      if mesh_median else None),
                    "devices": {
                        d: {"median_s": round(m, 6),
                            "samples": len(per_stage[d]),
                            "skew": (round(m / mesh_median, 3)
                                     if mesh_median else None)}
                        for d, m in sorted(medians.items())},
                }
            return {
                "ratio": self.ratio,
                "window": self.window,
                "min_excess_s": self.min_excess_s,
                "stages": stages,
                "flags": {f"{d}/{s}": n
                          for (d, s), n in sorted(self._flags.items())},
                "flagged_devices": sorted(
                    {d for (d, _), n in self._flags.items() if n}),
                "last_flag": self._last_flag,
            }


# ---------------------------------------------------------------------------
# cross-host telemetry aggregation
# ---------------------------------------------------------------------------

#: Trend-block fields worth a per-host fleet row (the merge is an
#: allowlist for the same reason telemetry's COUNTER_ALLOWLIST is: the
#: fleet section must stay a summary, not D concatenated trend dumps).
_HOST_ROW_FIELDS = ("samples", "span_s", "rss_delta_bytes",
                    "rss_slope_bytes_per_s", "wal_delta_bytes",
                    "wal_growth_bytes_per_s", "flightrec_drop_per_s",
                    "telemetry_jsonl_bytes")


class FleetAggregator:
    """Host 0's fleet-merged view of every host's telemetry trend.

    Each host already serves its TelemetrySampler trend under /statusz
    "trend" on the metrics exporter; the aggregator (run on host 0, or
    any operator box) pulls `http://{peer}/statusz` for each configured
    peer, extracts the trend block, and merges it with the local one
    into per-host rows plus a max-skew summary (the host whose RSS
    slope / occupancy most diverges from the fleet median).  A dead or
    slow peer degrades to an {"error": ...} row — the fleet section
    must render *because* a host is sick, not only when all are well.

    peers=() is the single-process degenerate mode: the merge runs over
    the local row alone, so CPU CI exercises the exact render path a
    pod-scale deployment serves."""

    def __init__(self, local_name: str,
                 local_trend_fn: Optional[Callable[[], dict]] = None,
                 peers: Sequence[str] = (), timeout_s: float = 1.0):
        self.local_name = str(local_name)
        self._local_trend_fn = local_trend_fn
        self.peers = [p for p in (peers or []) if p]
        self.timeout_s = max(float(timeout_s), 0.05)

    # -- collection --------------------------------------------------------

    def _fetch_peer(self, peer: str) -> dict:
        """One peer's /statusz trend block (or an error row)."""
        url = peer if "://" in peer else f"http://{peer}"
        if not url.rstrip("/").endswith("/statusz"):
            url = url.rstrip("/") + "/statusz"
        try:
            with urllib.request.urlopen(url,
                                        timeout=self.timeout_s) as resp:
                doc = json.loads(resp.read().decode())
            trend = doc.get("trend")
            if not isinstance(trend, dict):
                return {"error": "no trend section"}
            return trend
        except Exception as e:  # noqa: BLE001 — sick peers still render
            return {"error": repr(e)}

    @staticmethod
    def _host_row(trend: dict) -> dict:
        if "error" in trend:
            return {"error": trend["error"]}
        row = {k: trend[k] for k in _HOST_ROW_FIELDS if k in trend}
        last = trend.get("last") or {}
        for key in ("rss_bytes", "wal_bytes", "occupancy", "uptime_s"):
            if key in last:
                row[key] = last[key]
        return row

    def collect(self) -> Dict[str, dict]:
        """{host: row} over local + every configured peer."""
        rows: Dict[str, dict] = {}
        if self._local_trend_fn is not None:
            try:
                rows[self.local_name] = self._host_row(
                    self._local_trend_fn() or {})
            except Exception as e:  # noqa: BLE001
                rows[self.local_name] = {"error": repr(e)}
        for peer in self.peers:
            rows[peer] = self._host_row(self._fetch_peer(peer))
        return rows

    # -- read side ---------------------------------------------------------

    @staticmethod
    def _skew(rows: Dict[str, dict], field: str) -> Optional[dict]:
        """Max |value - fleet median| over hosts reporting `field`."""
        values = {h: r[field] for h, r in rows.items()
                  if isinstance(r.get(field), (int, float))}
        if len(values) < 2:
            return None
        med = statistics.median(values.values())
        host = max(values, key=lambda h: abs(values[h] - med))
        return {"host": host, "value": values[host],
                "fleet_median": med,
                "abs_skew": round(abs(values[host] - med), 6)}

    def statusz(self) -> dict:
        """The /statusz "fleet" section: per-host rows + max-skew
        summary.  Runs the peer pulls on the exporter's HTTP thread —
        bounded by timeout_s per peer."""
        rows = self.collect()
        summary: Dict[str, dict] = {}
        for field in ("rss_bytes", "wal_bytes", "occupancy",
                      "rss_slope_bytes_per_s"):
            skew = self._skew(rows, field)
            if skew is not None:
                summary[field] = skew
        return {
            "hosts": len(rows),
            "peers_configured": len(self.peers),
            "degenerate": not self.peers,
            "rows": rows,
            "max_skew": summary,
            "errors": sorted(h for h, r in rows.items() if "error" in r),
        }
