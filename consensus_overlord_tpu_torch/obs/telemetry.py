"""Soak telemetry: a bounded time-series sampler over the live process.

Prometheus histograms answer "how fast is it right now"; the ROADMAP's
long-soak lane asks a different question — "what is DRIFTING over
hours": WAL growth, flight-recorder churn, RSS creep, compile-cache
behavior, breaker flapping.  Those are only visible as a time axis, so
`TelemetrySampler` snapshots the process every `interval_s` seconds
into

  * a bounded in-memory ring (the /statusz "trend" section reads it:
    deltas over the retained window, live, not post-mortem), and
  * optionally a JSONL file (one sample per line — the artifact the
    nightly soak lane uploads), size-bounded by rewriting the file from
    the ring once it exceeds `max_file_samples` lines.

Sample shape (every field best-effort; a failing collector records an
absent key, never an exception):

  {"seq": 12, "ts": 1770000000.0, "uptime_s": 241.2,
   "rss_bytes": 181000000,
   "wal_bytes": 4096,
   "flightrec": {"events": 256, "recorded": 8121, "dropped": 7865},
   "compile_cache": {"hits": 4, "misses": 1, "hit_ratio": 0.8},
   "breaker": {"state": "closed", ...},          # provider degraded_status
   "occupancy": 0.875,                            # last device batch
   "counters": {"consensus_committed_heights_total": 122, ...}}

Wiring: `sim/run.py --soak-seconds S --sample-every N` (the nightly
soak-smoke lane), `service/main.py` via the `telemetry_sample_every_s`
config knob, and `Metrics.add_status_source("trend", sampler.trend)`.

Same posture as flightrec.py/prof.py: sampling must never break the
process it watches — every collector is wrapped, the thread is daemon,
rings are bounded.

The port's own copy of consensus_overlord_tpu/obs/telemetry.py; its
compile-cache column counts the kernel build cache (compile_cache.py).
The sim's soak flags are not ported yet (ROADMAP item 8c).
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional

__all__ = ["DRIFT_THRESHOLD_DEFAULTS", "TelemetrySampler", "drift_check",
           "rss_bytes", "wal_size_bytes"]

#: Counter/gauge series worth carrying per sample (summed across label
#: sets).  Deliberately a short allowlist: a soak file at 2 s cadence
#: for hours must stay greppable and bounded, not a registry dump.
COUNTER_ALLOWLIST = (
    "consensus_committed_heights_total",
    "consensus_view_changes_total",
    "consensus_byzantine_rejections_total",
    "frontier_batch_size_count",          # = batches flushed
    "frontier_verify_failures_total",
    "frontier_padded_lanes_total",
    "wal_append_ms_count",                # = WAL saves
    "wal_corruptions_total",
    "crypto_device_failures_total",
    "crypto_host_fallbacks_total",
    "crypto_breaker_open",
)


def rss_bytes() -> Optional[int]:
    """Resident set size of this process.  /proc/self/statm on Linux
    (the deploy target); ru_maxrss (peak, kb) as the portable fallback —
    labeled the same because a soak cares about the slope, and on the
    fallback platform the peak's slope still catches a leak."""
    try:
        with open("/proc/self/statm") as f:
            pages = int(f.read().split()[1])  # field 2: resident pages
        return pages * os.sysconf("SC_PAGE_SIZE")
    except Exception:  # noqa: BLE001 — non-Linux
        try:
            import resource

            return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
        except Exception:  # noqa: BLE001
            return None


def wal_size_bytes(wal) -> Optional[int]:
    """Size of one WAL via its size_bytes() hook (engine/wal.py); None
    for WAL-less or hook-less objects."""
    fn = getattr(wal, "size_bytes", None)
    if fn is None:
        return None
    try:
        return fn()
    except Exception:  # noqa: BLE001
        return None


class TelemetrySampler:
    """Periodic process snapshots into a bounded ring + optional JSONL.

    Collectors (all optional — pass what the host process has):
      metrics            — obs.Metrics; feeds the counter allowlist and
                           the occupancy gauge
      wal_size_fn        — () -> total WAL bytes (a service passes one
                           FileWal's size, a sim fleet sums its nodes')
      recorders_fn       — () -> iterable of FlightRecorders (callable
                           because chaos crash-restarts swap node
                           objects mid-run); churn = sum of dropped
      breaker_status_fn  — () -> provider degraded_status() dict
      profiler           — obs.prof.DeviceProfiler (occupancy fallback
                           when no metrics registry is attached)
      extra_fn           — () -> dict merged into each sample (tenant
                           lanes, soak-specific context)
    """

    def __init__(self, metrics=None, interval_s: float = 30.0,
                 out_path: Optional[str] = None, window: int = 512,
                 max_file_samples: int = 20_000,
                 wal_size_fn: Optional[Callable[[], Optional[int]]] = None,
                 recorders_fn: Optional[Callable[[], list]] = None,
                 breaker_status_fn: Optional[Callable[[], dict]] = None,
                 profiler=None,
                 extra_fn: Optional[Callable[[], dict]] = None):
        self.interval_s = max(float(interval_s), 0.05)
        self.out_path = out_path or None
        self.max_file_samples = max(int(max_file_samples), 1)
        self._metrics = metrics
        self._wal_size_fn = wal_size_fn
        self._recorders_fn = recorders_fn
        self._breaker_status_fn = breaker_status_fn
        self._profiler = profiler
        self._extra_fn = extra_fn
        self._ring: deque = deque(maxlen=max(int(window), 2))
        self._seq = 0
        self._written = 0
        self._t0 = time.time()
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        #: Per-sample observers (obs/anomaly.py AnomalyDetector): each
        #: gets every sample doc, after it entered the ring.
        self._observers: List[Callable[[dict], None]] = []
        #: Baseline for per-sample stage means (cumulative stage totals
        #: at the previous sample).
        self._last_stage_totals: Dict[str, tuple] = {}
        self._rotate_existing()

    def _rotate_existing(self) -> None:
        """Enforce the JSONL size bound against a PRE-EXISTING file
        (e.g. left by a crashed soak): count its lines into `_written`
        so the append-time bound applies from sample one, and rewrite
        immediately when it already exceeds the bound — keeping the
        newest `window` lines, the same retention the ring gives."""
        if self.out_path is None:
            return
        try:
            if not os.path.exists(self.out_path):
                return
            with open(self.out_path) as f:
                lines = f.readlines()
            if len(lines) >= self.max_file_samples:
                keep = lines[-self._ring.maxlen:]
                with open(self.out_path, "w") as f:
                    f.writelines(keep)
                with self._lock:
                    self._written = len(keep)
            else:
                with self._lock:
                    self._written = len(lines)
        except Exception:  # noqa: BLE001 — a sick file must not kill boot
            pass

    def add_observer(self, fn: Callable[[dict], None]
                     ) -> "TelemetrySampler":
        """Register a per-sample observer (called synchronously on the
        sampler thread with each sample doc)."""
        self._observers.append(fn)
        return self

    # -- collection --------------------------------------------------------

    def _counters(self) -> Dict[str, float]:
        if self._metrics is None:
            return {}
        from .metrics import snapshot  # local: keeps module stdlib-light

        out: Dict[str, float] = {}
        for key, value in snapshot(self._metrics.registry).items():
            name = key.split("{", 1)[0]
            if name in COUNTER_ALLOWLIST:
                out[name] = out.get(name, 0.0) + value
        return out

    def _occupancy(self) -> Optional[float]:
        if self._profiler is not None:
            occ = getattr(self._profiler, "_last_occupancy", None)
            if occ is not None:
                return occ
        if self._metrics is not None:
            try:
                occ = self._metrics.device_batch_occupancy.get()
                # A real occupancy is real/padded lanes in (0, 1] —
                # exactly 0.0 is the gauge's never-set initial value.
                # Recording it would fabricate a "device stalled to
                # zero occupancy" signal in the series; omit instead.
                return occ if occ else None
            except Exception:  # noqa: BLE001 — client internals shifted
                return None
        return None

    def sample_now(self) -> dict:
        """Take one sample synchronously: collect, append to the ring,
        and (if configured) the JSONL file.  Never raises."""
        with self._lock:
            self._seq += 1
            seq = self._seq
        now = time.time()
        doc: dict = {"seq": seq, "ts": now,
                     "uptime_s": round(now - self._t0, 3)}
        rss = rss_bytes()
        if rss is not None:
            doc["rss_bytes"] = rss
        for key, fn in (("wal_bytes", self._wal_size_fn),
                        ("breaker", self._breaker_status_fn)):
            if fn is None:
                continue
            try:
                value = fn()
                if value is not None:
                    doc[key] = value
            except Exception:  # noqa: BLE001 — collectors are best-effort
                pass
        if self._recorders_fn is not None:
            try:
                recs = [r for r in self._recorders_fn() if r is not None]
                doc["flightrec"] = {
                    "events": sum(len(r) for r in recs),
                    "recorded": sum(getattr(r, "recorded", 0)
                                    for r in recs),
                    "dropped": sum(getattr(r, "dropped", 0)
                                   for r in recs),
                }
            except Exception:  # noqa: BLE001
                pass
        try:
            from .. import compile_cache as _cc

            stats = _cc.stats()
            total = stats.get("hits", 0) + stats.get("misses", 0)
            doc["compile_cache"] = {
                **stats,
                "hit_ratio": round(stats.get("hits", 0) / total, 4)
                if total else None,
            }
        except Exception:  # noqa: BLE001
            pass
        occ = self._occupancy()
        if occ is not None:
            doc["occupancy"] = round(occ, 4)
        stage_means = self._stage_means()
        if stage_means:
            doc["stage_means_s"] = stage_means
        counters = self._counters()
        if counters:
            doc["counters"] = counters
        if self.out_path is not None:
            try:
                doc["telemetry_jsonl_bytes"] = os.path.getsize(
                    self.out_path)
            except Exception:  # noqa: BLE001 — no file yet
                pass
        if self._extra_fn is not None:
            try:
                doc.update(self._extra_fn() or {})
            except Exception:  # noqa: BLE001
                pass
        with self._lock:
            self._ring.append(doc)
        self._write(doc)
        for observer in self._observers:
            try:
                observer(doc)
            except Exception:  # noqa: BLE001 — observers are best-effort
                pass
        return doc

    def _stage_means(self) -> Dict[str, float]:
        """Mean seconds per stage over the calls since the LAST sample
        (differencing the profiler's cumulative totals) — the series
        the anomaly layer's stage_time_spike detector watches."""
        if self._profiler is None:
            return {}
        try:
            totals = self._profiler.stage_totals()
        except Exception:  # noqa: BLE001
            return {}
        out: Dict[str, float] = {}
        for key, tot in totals.items():
            count, total_s = tot["count"], tot["total_s"]
            last_count, last_total = self._last_stage_totals.get(
                key, (0, 0.0))
            if count > last_count:
                out[key] = round(
                    (total_s - last_total) / (count - last_count), 6)
            self._last_stage_totals[key] = (count, total_s)
        return out

    def _write(self, doc: dict) -> None:
        if self.out_path is None:
            return
        try:
            with self._lock:
                if self._written >= self.max_file_samples:
                    # Bound the file the way the ring bounds memory:
                    # rewrite from the retained window (hours-long soaks
                    # must not fill the disk through their own
                    # observability).
                    with open(self.out_path, "w") as f:
                        for kept in self._ring:
                            f.write(json.dumps(kept, default=repr) + "\n")
                    self._written = len(self._ring)
                    return
                with open(self.out_path, "a") as f:
                    f.write(json.dumps(doc, default=repr) + "\n")
                self._written += 1
        except Exception:  # noqa: BLE001 — a full disk must not kill SMR
            pass

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> "TelemetrySampler":
        """Begin background sampling (daemon thread; one immediate
        sample so short runs still record a baseline).  Idempotent."""
        if self._thread is not None:
            return self
        self._stop.clear()

        def loop() -> None:
            self.sample_now()
            while not self._stop.wait(self.interval_s):
                self.sample_now()

        self._thread = threading.Thread(target=loop, name="obs-telemetry",
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self, final_sample: bool = True) -> None:
        """Stop the thread; takes one last sample by default so the
        series always covers the run's end state."""
        self._stop.set()
        thread, self._thread = self._thread, None
        if thread is not None:
            thread.join(timeout=5.0)
        if final_sample:
            self.sample_now()

    # -- read side ---------------------------------------------------------

    @property
    def samples_taken(self) -> int:
        return self._seq

    def tail(self, n: Optional[int] = None) -> List[dict]:
        """Newest `n` samples, oldest first."""
        with self._lock:
            samples = list(self._ring)
        if n is not None:
            samples = samples[-n:] if n > 0 else []
        return samples

    def trend(self, window: Optional[int] = None) -> dict:
        """Deltas over the retained window (newest vs oldest sample):
        the /statusz "trend" section.  Rates are per second of span, so
        a scrape reads drift directly instead of differencing raw
        counters by hand."""
        samples = self.tail(window)
        doc: dict = {"samples": len(samples),
                     "interval_s": self.interval_s,
                     "out_path": self.out_path}
        if not samples:
            return doc
        first, last = samples[0], samples[-1]
        span = max(last["ts"] - first["ts"], 1e-9)
        doc["span_s"] = round(span, 3)
        doc["last"] = last

        def delta(key: str, sub: Optional[str] = None):
            a = first.get(key, {}).get(sub) if sub else first.get(key)
            b = last.get(key, {}).get(sub) if sub else last.get(key)
            if isinstance(a, (int, float)) and isinstance(b, (int, float)):
                return b - a
            return None

        for name, key, sub in (("rss_delta_bytes", "rss_bytes", None),
                               ("wal_delta_bytes", "wal_bytes", None),
                               ("flightrec_dropped_delta",
                                "flightrec", "dropped"),
                               ("flightrec_recorded_delta",
                                "flightrec", "recorded")):
            d = delta(key, sub)
            if d is not None:
                doc[name] = d
        # Slopes/rates over the window: the soak lane's drift gate
        # (drift_check) reads these directly instead of re-deriving
        # delta/span by hand.
        for rate, src in (("rss_slope_bytes_per_s", "rss_delta_bytes"),
                          ("wal_growth_bytes_per_s", "wal_delta_bytes"),
                          ("flightrec_drop_per_s",
                           "flightrec_dropped_delta")):
            if src in doc:
                doc[rate] = round(doc[src] / span, 3)
        cache = (last.get("compile_cache") or {})
        if cache.get("hit_ratio") is not None:
            doc["compile_cache_hit_ratio"] = cache["hit_ratio"]
        # JSONL sink size: the bound-enforcement surface (rotation
        # keeps this sawtoothing below max_file_samples lines).
        if last.get("telemetry_jsonl_bytes") is not None:
            doc["telemetry_jsonl_bytes"] = last["telemetry_jsonl_bytes"]
        churn = doc.get("flightrec_recorded_delta")
        if churn is not None:
            doc["flightrec_events_per_s"] = round(churn / span, 3)
        rates: Dict[str, float] = {}
        for name in ((last.get("counters") or {}).keys()
                     & (first.get("counters") or {}).keys()):
            d = last["counters"][name] - first["counters"][name]
            rates[name + "_per_s"] = round(d / span, 4)
        if rates:
            doc["counter_rates"] = rates
        return doc

    def statusz(self) -> dict:
        """Richer /statusz form: trend + the recent window tail."""
        doc = self.trend()
        doc["recent"] = self.tail(8)
        return doc


# ---------------------------------------------------------------------------
# drift gates (the soak-chaos survival lane)
# ---------------------------------------------------------------------------

#: Default drift ceilings for a soak run.  Deliberately generous — a
#: soak gate exists to catch a *leak* (monotone growth that would kill
#: an hours-long run), not to flinch at warmup noise.  Ratios are
#: floors (None/absent sample = not gated: a CPU sim may never touch
#: the compile cache).
DRIFT_THRESHOLD_DEFAULTS = {
    "max_rss_slope_bytes_per_s": 4 * 1024 * 1024,
    "max_wal_growth_bytes_per_s": 4 * 1024 * 1024,
    "max_flightrec_drop_per_s": 50_000.0,
    "min_compile_cache_hit_ratio": 0.0,
}


def drift_check(trend: dict, thresholds: Optional[dict] = None
                ) -> List[str]:
    """Evaluate a TelemetrySampler.trend() block against drift
    ceilings; returns human-readable violations (empty = the soak
    holds).  Pure and stdlib-only so the gate is unit-testable and the
    CI lane can re-run it over an uploaded trend block.

    Thresholds (missing keys fall back to DRIFT_THRESHOLD_DEFAULTS;
    set a max to None to disable that gate):
      max_rss_slope_bytes_per_s, max_wal_growth_bytes_per_s,
      max_flightrec_drop_per_s, min_compile_cache_hit_ratio.
    """
    th = dict(DRIFT_THRESHOLD_DEFAULTS)
    th.update(thresholds or {})
    out: List[str] = []
    if trend.get("samples", 0) < 2:
        out.append(f"drift: too few samples to judge "
                   f"({trend.get('samples', 0)} < 2)")
        return out
    for key, limit_key, label in (
            ("rss_slope_bytes_per_s", "max_rss_slope_bytes_per_s",
             "RSS slope"),
            ("wal_growth_bytes_per_s", "max_wal_growth_bytes_per_s",
             "WAL growth"),
            ("flightrec_drop_per_s", "max_flightrec_drop_per_s",
             "flight-recorder drop rate")):
        limit = th.get(limit_key)
        value = trend.get(key)
        if limit is None or value is None:
            continue
        if value > limit:
            out.append(f"drift: {label} {value:,.1f}/s exceeds "
                       f"{limit:,.1f}/s over {trend.get('span_s')}s")
    floor = th.get("min_compile_cache_hit_ratio")
    ratio = trend.get("compile_cache_hit_ratio")
    if floor and ratio is not None and ratio < floor:
        out.append(f"drift: compile-cache hit ratio {ratio:.3f} below "
                   f"{floor:.3f}")
    return out
