"""Anomaly/alert layer: EWMA z-score detectors over the telemetry series.

The drift gates (telemetry.drift_check) judge a soak ONCE, at the end,
against static ceilings; an operator watching a live fleet needs the
complementary signal — "this series just departed from its own recent
behavior".  `AnomalyDetector` rides the TelemetrySampler's per-sample
observer hook and keeps an exponentially-weighted mean/variance per
watched series (the classic Welford-style EWMA pair); a sample whose
z-score against that baseline crosses the detector's threshold raises
an alert:

  occupancy_collapse    — device batch occupancy drops hard below its
                          EWMA (a mis-tuned linger, a tenant gone quiet,
                          a frontier wedged half-full)
  stage_time_spike      — a device stage's per-sample mean jumps above
                          baseline (thermal throttling, a degraded ICI
                          link, a host swapping)
  shed_storm            — the admission-shed counter's rate spikes
                          (bounded tenant queues overflowing to the
                          host oracle)
  straggler_persistence — a StragglerDetector keeps flagging across
                          samples (one flag is noise; flags in most
                          recent samples is a sick chip)
  ladder_step_down      — the MeshSupervisor degraded the dispatch
                          rung (parallel/supervisor.py; raised by the
                          supervisor itself, not a z-score detector)

Each alert: one `alert` flightrec event, `obs_alerts_total{kind}`, and
a bounded ring served as the /statusz "alerts" section.  `alert_count`
feeds the sim lane's `--soak-max-alerts` gate (exit 3).

EWMA, not a windowed deque: the sampler may run for hours at a 2 s
cadence — two floats per series is the whole memory cost, and the decay
(alpha) gives recent behavior the weight a drift detector wants.  Same
posture as the rest of obs/: observing never raises, rings bounded,
stdlib-only.

The port's own copy of consensus_overlord_tpu/obs/anomaly.py.
"""

from __future__ import annotations

import math
import threading
import time
from collections import deque
from typing import Dict, List, Optional

__all__ = ["ALERT_KINDS", "AnomalyDetector", "EwmaSeries"]

#: The alert taxonomy (the obs_alerts_total{kind} label set).
ALERT_KINDS = ("occupancy_collapse", "stage_time_spike", "shed_storm",
               "straggler_persistence", "ladder_step_down")


class EwmaSeries:
    """Exponentially-weighted mean/variance over one scalar series,
    with a warm-up floor before z-scores are trusted."""

    __slots__ = ("alpha", "min_samples", "n", "mean", "var")

    def __init__(self, alpha: float = 0.3, min_samples: int = 5):
        self.alpha = min(max(float(alpha), 1e-6), 1.0)
        self.min_samples = max(int(min_samples), 2)
        self.n = 0
        self.mean = 0.0
        self.var = 0.0

    def update(self, value: float) -> Optional[float]:
        """Feed one sample; returns the z-score of `value` against the
        PRIOR baseline (None while warming up), then folds it in."""
        value = float(value)
        z = None
        if self.n >= self.min_samples:
            std = math.sqrt(self.var)
            if std > 0:
                z = (value - self.mean) / std
            else:
                # A flat baseline: any departure is infinitely
                # surprising; report a large finite score instead.
                z = 0.0 if value == self.mean else math.copysign(
                    float("inf"), value - self.mean)
        if self.n == 0:
            self.mean = value
        else:
            diff = value - self.mean
            incr = self.alpha * diff
            self.mean += incr
            self.var = (1.0 - self.alpha) * (self.var + diff * incr)
        self.n += 1
        return z


class AnomalyDetector:
    """The telemetry-fed alert engine.  Wire it as a TelemetrySampler
    observer (`sampler.add_observer(det.observe_sample)`); every sample
    doc flows through the detectors below, and alerts land in the ring,
    the counter, and the flight recorder.

    Thresholds are deliberately one knob (`z_threshold`) plus per-kind
    structural gates — the point of a z-score layer is that the
    baselines tune themselves."""

    def __init__(self, metrics=None, recorder=None,
                 straggler: Optional[object] = None,
                 z_threshold: float = 4.0, alpha: float = 0.3,
                 min_samples: int = 5, capacity: int = 128,
                 straggler_window: int = 5,
                 straggler_min_flagged: int = 3):
        self.metrics = metrics
        self.recorder = recorder
        self.straggler = straggler
        self.z_threshold = max(float(z_threshold), 0.5)
        self._alpha = alpha
        self._min_samples = min_samples
        self._ring: deque = deque(maxlen=max(int(capacity), 1))
        self._lock = threading.Lock()
        self._total = 0
        self._by_kind: Dict[str, int] = {}
        #: EWMA baselines, keyed by series name.
        self._series: Dict[str, EwmaSeries] = {}
        #: shed_storm differences the cumulative shed counter.
        self._last_sheds: Optional[float] = None
        #: straggler_persistence: recent per-sample "did the detector
        #: flag since last sample" bits.
        self._straggler_bits: deque = deque(
            maxlen=max(int(straggler_window), 2))
        self._straggler_min_flagged = max(int(straggler_min_flagged), 1)
        self._last_straggler_flags = 0

    # -- internals ---------------------------------------------------------

    def _ewma(self, name: str) -> EwmaSeries:
        series = self._series.get(name)
        if series is None:
            series = self._series[name] = EwmaSeries(
                self._alpha, self._min_samples)
        return series

    def raise_alert(self, kind: str, **fields) -> None:
        """Record one alert (also the synthetic-storm injection point
        the sim lane uses to test the --soak-max-alerts gate)."""
        alert = {"ts": time.time(), "kind": kind}
        alert.update(fields)
        with self._lock:
            self._total += 1
            self._by_kind[kind] = self._by_kind.get(kind, 0) + 1
            self._ring.append(alert)
        if self.metrics is not None:
            try:
                self.metrics.obs_alerts_total.labels(kind=kind).inc()
            except Exception:  # noqa: BLE001
                pass
        if self.recorder is not None:
            # flightrec owns "kind"/"ts"; the alert kind rides alongside
            payload = {k: v for k, v in alert.items()
                       if k not in ("kind", "ts")}
            self.recorder.record("alert", alert_kind=kind, **payload)

    # -- the sampler hook --------------------------------------------------

    def observe_sample(self, doc: dict) -> None:
        """One TelemetrySampler sample.  Never raises."""
        try:
            self._observe(doc)
        except Exception:  # noqa: BLE001 — detection never breaks sampling
            pass

    def _observe(self, doc: dict) -> None:
        # occupancy_collapse: a LOW departure from the occupancy
        # baseline (high occupancy is never an incident).
        occ = doc.get("occupancy")
        if isinstance(occ, (int, float)):
            z = self._ewma("occupancy").update(occ)
            if z is not None and z < -self.z_threshold:
                self.raise_alert("occupancy_collapse",
                                 occupancy=round(float(occ), 4),
                                 z=round(z, 2))
        # stage_time_spike: each watched stage's per-sample total; HIGH
        # departures only.
        stages = doc.get("stage_means_s") or {}
        for stage, value in stages.items():
            if not isinstance(value, (int, float)):
                continue
            z = self._ewma(f"stage:{stage}").update(value)
            if z is not None and z > self.z_threshold:
                self.raise_alert("stage_time_spike", stage=str(stage),
                                 mean_s=round(float(value), 6),
                                 z=round(z, 2))
        # shed_storm: per-sample delta of the cumulative shed counter.
        sheds = (doc.get("counters") or {}).get(
            "frontier_admission_sheds_total")
        if isinstance(sheds, (int, float)):
            if self._last_sheds is not None:
                delta = sheds - self._last_sheds
                z = self._ewma("sheds").update(delta)
                if z is not None and z > self.z_threshold and delta > 0:
                    self.raise_alert("shed_storm", sheds_delta=delta,
                                     z=round(z, 2))
            self._last_sheds = sheds
        # straggler_persistence: flags-since-last-sample bits over a
        # short window — a chip flagged in most recent samples is sick.
        if self.straggler is not None:
            flags = self.straggler.flag_count()
            bit = 1 if flags > self._last_straggler_flags else 0
            self._last_straggler_flags = flags
            self._straggler_bits.append(bit)
            if (sum(self._straggler_bits)
                    >= self._straggler_min_flagged):
                self._straggler_bits.clear()
                self.raise_alert(
                    "straggler_persistence",
                    devices=self.straggler.flagged_devices(),
                    flags_total=flags)

    # -- read side ---------------------------------------------------------

    def alert_count(self, kind: Optional[str] = None) -> int:
        """Lifetime alerts (optionally one kind) — the sim lane's
        --soak-max-alerts gate reads this."""
        with self._lock:
            if kind is None:
                return self._total
            return self._by_kind.get(kind, 0)

    def tail(self, n: Optional[int] = None) -> List[dict]:
        """Newest `n` alerts, oldest first."""
        with self._lock:
            alerts = list(self._ring)
        if n is not None:
            alerts = alerts[-n:] if n > 0 else []
        return alerts

    def statusz(self, tail: int = 16) -> dict:
        """The /statusz "alerts" section."""
        with self._lock:
            by_kind = dict(sorted(self._by_kind.items()))
            total = self._total
        return {
            "total": total,
            "by_kind": by_kind,
            "z_threshold": self.z_threshold,
            "recent": self.tail(tail),
        }
