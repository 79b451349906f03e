"""MeshSupervisor: the self-healing escalation ladder for the crypto mesh.

The port's own copy of consensus_overlord_tpu/parallel/supervisor.py: the
same rungs, thresholds, half-open probe, history, metrics, anomaly alert
and flightrec event, so one signal sequence walks both ladders alike.

The breaker (crypto/breaker.py) gives the fleet exactly one degraded
mode: full mesh or full host oracle.  That throws away every healthy
chip because one lane stalled.  This module walks a *ladder* instead:

    full_mesh    every device in the configured mesh
    sub_mesh     rebuilt _MeshKernels over the surviving lanes,
                 quarantined lanes excluded, operands re-padded to the
                 new lane multiple
    single_chip  the single-card kernel set on the mesh's first device
    host_oracle  the exact CPU pairing backend (the breaker's old
                 all-or-nothing mode, now the ladder's last rung)

Signals IN: the provider's device-failure plumbing (`record_failure`,
called next to `breaker.record_failure`), its success path
(`record_success`), lane attribution carried on `DeviceLossError.device`,
and the fleet's straggler detector — `StragglerDetector.flagged_devices()`
(obs/fleet.py) names the lane to quarantine when the exception itself
can't.

Actions OUT: `provider.apply_mesh_rung(rung, quarantined)` swaps the
provider's kernel set (crypto/cuda_provider.py owns the swap: it must
also drop the mesh-resident pubkey cache, G2 tables, and stage probe).
Providers without that hook (crypto/provider.py SimDeviceCrypto) still
walk the ladder as bookkeeping, so chaos runs exercise the transition
logic, metrics, and statusz surface with zero hardware.

Stepping back up is half-open-shaped: after `probe_successes` consecutive
clean dispatches AND `probe_cooldown_s` since the last step-down, the
supervisor promotes one rung and lets real traffic be the probe — a
failure during probation steps straight back down.

The standing guarantee is unchanged at every rung: verdicts are exact
(every rung's fallback is the host oracle twin); degradation costs
throughput, never correctness or liveness.

Observability: every transition lands in
`mesh_ladder_transitions_total{from,to,reason}` and moves the
`mesh_quarantined_devices` gauge, is flightrec'd as a
`ladder_transition` event, and `statusz()` feeds the /statusz "ladder"
section.

Thread-safety: `record_failure`/`record_success` arrive from the
frontier's dispatch worker and resolver threads concurrently — one lock
guards all ladder state; `_locked` helpers assume the caller holds it.
"""

from __future__ import annotations

import logging
import threading
import time
from collections import deque
from typing import Optional, Sequence

logger = logging.getLogger("consensus_overlord_tpu_torch.supervisor")

__all__ = ["MeshSupervisor", "RUNGS"]

#: Ladder rungs, healthiest first.
RUNGS = ("full_mesh", "sub_mesh", "single_chip", "host_oracle")


class MeshSupervisor:
    """Walks the mesh degradation ladder from breaker/straggler signals.

    `provider` is duck-typed: `apply_mesh_rung(rung, quarantined)` (swap
    kernel sets; optional), `mesh_device_names()` (lane inventory;
    optional — without it the sub_mesh rung is skipped on step-down).
    `straggler` / `anomaly` are the fleet detectors (obs/fleet.py,
    obs/anomaly.py); both optional.
    """

    def __init__(self, provider, metrics=None, recorder=None,
                 straggler=None, anomaly=None,
                 step_threshold: int = 3, probe_successes: int = 8,
                 probe_cooldown_s: float = 2.0, history: int = 32,
                 clock=time.monotonic):
        self._provider = provider
        self.metrics = metrics
        self.recorder = recorder
        self.straggler = straggler
        self.anomaly = anomaly
        #: Consecutive failures at the current rung before stepping down.
        self.step_threshold = max(int(step_threshold), 1)
        #: Consecutive successes before probing one rung up.
        self.probe_successes = max(int(probe_successes), 1)
        #: Minimum dwell after a step-down before any promotion probe.
        self.probe_cooldown_s = float(probe_cooldown_s)
        self._clock = clock
        self._lock = threading.Lock()
        self._rung = "full_mesh"
        self._quarantined: set = set()
        self._failures = 0
        self._successes = 0
        self._last_step_down: Optional[float] = None
        self._last_probe: Optional[float] = None
        self._transitions = 0
        self._history: deque = deque(maxlen=max(int(history), 1))

    # -- signals in ---------------------------------------------------------

    def record_failure(self, path: str, exc: BaseException) -> None:
        """A device dispatch failed (called next to breaker.record_failure).
        After `step_threshold` consecutive failures the ladder steps down,
        quarantining the attributed lane when one is named."""
        device = getattr(exc, "device", None)
        reason = f"{path}: {type(exc).__name__}"
        with self._lock:
            self._successes = 0
            self._failures += 1
            if self._failures < self.step_threshold:
                return
            self._failures = 0
            self._step_down_locked(reason, device)

    def record_success(self) -> None:
        """A device dispatch succeeded.  Enough of them (past the dwell
        window) probe one rung back up — traffic is the probe."""
        with self._lock:
            self._failures = 0
            if self._rung == "full_mesh":
                return
            self._successes += 1
            if self._successes < self.probe_successes:
                return
            if (self._last_step_down is not None
                    and self._clock() - self._last_step_down
                    < self.probe_cooldown_s):
                return
            self._successes = 0
            self._step_up_locked()

    def allow_device(self) -> bool:
        """The ladder's dispatch gate, consulted by the provider's
        `_device_allowed` next to the breaker.  Every rung above
        host_oracle dispatches freely; on host_oracle exactly one probe
        per probe_cooldown_s is let through (half-open-shaped) so probe
        successes exist to climb back up on."""
        with self._lock:
            if self._rung != "host_oracle":
                return True
            now = self._clock()
            if (self._last_probe is None
                    or now - self._last_probe >= self.probe_cooldown_s):
                self._last_probe = now
                return True
            return False

    # -- introspection ------------------------------------------------------

    @property
    def rung(self) -> str:
        with self._lock:
            return self._rung

    def quarantined_devices(self) -> list:
        with self._lock:
            return sorted(self._quarantined)

    def statusz(self) -> dict:
        """JSON-encodable snapshot for the /statusz "ladder" section."""
        with self._lock:
            return {
                "rung": self._rung,
                "quarantined": sorted(self._quarantined),
                "transitions": self._transitions,
                "consecutive_failures": self._failures,
                "consecutive_successes": self._successes,
                "recent": list(self._history),
            }

    # -- ladder walk (caller holds the lock) --------------------------------

    def _step_down_locked(self, reason: str, device: Optional[str]) -> None:
        frm = self._rung
        if frm == "host_oracle":
            return  # already at the bottom
        if frm in ("full_mesh", "sub_mesh"):
            suspects = self._suspect_lanes_locked(device)
            survivors = self._survivors_locked(extra=suspects)
            if suspects and len(survivors) >= 2:
                # A named lane and a viable survivor mesh: quarantine and
                # rebuild rather than abandoning the healthy chips.
                self._quarantined.update(suspects)
                self._apply_locked("sub_mesh", reason)
                return
            # No attribution (or too few survivors): the whole mesh is
            # suspect — fall to the single-chip kernel set.
            self._apply_locked("single_chip", reason)
            return
        self._apply_locked("host_oracle", reason)  # single_chip -> bottom

    def _step_up_locked(self) -> None:
        if self._rung == "host_oracle":
            self._apply_locked("single_chip", "probe")
        elif self._rung == "single_chip":
            if self._quarantined and len(self._survivors_locked()) >= 2:
                self._apply_locked("sub_mesh", "probe")
            else:
                self._quarantined.clear()
                self._apply_locked("full_mesh", "probe")
        elif self._rung == "sub_mesh":
            # Probe the previously-quarantined lanes with real traffic;
            # a relapse re-attributes and re-quarantines within one
            # step_threshold of failures.
            self._quarantined.clear()
            self._apply_locked("full_mesh", "probe")

    def _suspect_lanes_locked(self, device: Optional[str]) -> set:
        """Lanes to quarantine: the exception-named device first, else
        whatever the straggler detector is flagging right now."""
        lanes = set(self._device_names())
        suspects = set()
        if device is not None and device in lanes:
            suspects.add(device)
        elif self.straggler is not None:
            try:
                flagged = self.straggler.flagged_devices()
            except Exception:  # noqa: BLE001 — advisory signal only
                flagged = ()
            suspects.update(d for d in flagged
                            if d in lanes and d not in self._quarantined)
        return suspects

    def _survivors_locked(self, extra: Sequence[str] = ()) -> list:
        dead = self._quarantined | set(extra)
        return [d for d in self._device_names() if d not in dead]

    def _device_names(self) -> list:
        names = getattr(self._provider, "mesh_device_names", None)
        if names is None:
            return []
        try:
            return list(names())
        except Exception:  # noqa: BLE001 — inventory is advisory
            logger.exception("mesh_device_names failed")
            return []

    def _apply_locked(self, to: str, reason: str) -> None:
        frm = self._rung
        if to == frm:
            return
        quarantined = sorted(self._quarantined)
        apply_rung = getattr(self._provider, "apply_mesh_rung", None)
        while apply_rung is not None:
            try:
                apply_rung(to, quarantined)
                break
            except Exception as e:  # noqa: BLE001 — a failed rebuild must
                # degrade further, not wedge the ladder: fall to the
                # single-chip set (always constructible), or the host
                # oracle if even that fails.  A loop, not recursion, so
                # the lock-discipline checker can prove the caller still
                # holds _lock.
                logger.exception("apply_mesh_rung(%s) failed", to)
                fallback = ("single_chip" if to in ("full_mesh", "sub_mesh")
                            else "host_oracle")
                if fallback == to or fallback == frm:
                    return  # nowhere further down to land
                to = fallback
                reason = f"rebuild_failed: {type(e).__name__}"
        self._rung = to
        self._failures = 0
        self._successes = 0
        healthier = RUNGS.index(to) < RUNGS.index(frm)
        if not healthier:
            self._last_step_down = self._clock()
        self._transitions += 1
        self._history.append({"from": frm, "to": to, "reason": reason,
                              "quarantined": quarantined})
        logger.warning("mesh ladder %s -> %s (%s)%s", frm, to, reason,
                       f" quarantined={quarantined}" if quarantined else "")
        if self.metrics is not None:
            self.metrics.mesh_ladder_transitions.labels(
                **{"from": frm, "to": to, "reason": reason}).inc()
            self.metrics.mesh_quarantined_devices.set(
                float(len(self._quarantined)))
        if self.anomaly is not None and not healthier:
            try:
                self.anomaly.raise_alert("ladder_step_down", rung=to,
                                         reason=reason)
            except Exception:  # noqa: BLE001 — advisory signal only
                logger.exception("ladder anomaly alert failed")
        if self.recorder is not None:
            self.recorder.record("ladder_transition", frm=frm, to=to,
                                 reason=reason,
                                 quarantined=len(quarantined))
