"""Device circuit breaker: route crypto around a sick accelerator.

The port's own copy of consensus_overlord_tpu/crypto/breaker.py (it is
stdlib-only), unchanged in behaviour but for one repair: a fault window
counts only the successes of device calls admitted under it (see
`record_success`'s `epoch`).

A consensus validator must keep voting even when its GPU starts failing —
a CUDA runtime error, a wedged readback, or a dying card must degrade
throughput, not liveness.  Every device-path result in CudaBlsCrypto has
an exact host-oracle twin (the CPU pairing backend the batch paths
already fall back to for small batches), so the correct degraded mode is
always available; what's needed is the decision logic:

  closed     normal operation; every device failure increments a
             consecutive-failure count, any success resets it
  open       after `failure_threshold` consecutive failures: all work
             routes to the host oracle for `cooldown_s`
  half-open  after the cooldown, exactly ONE in-flight probe is allowed
             back onto the device; success closes the breaker, failure
             re-opens it for another cooldown

Thread-safety: `allow()` / `record_*` are called from the frontier's
dispatch worker, its resolver threads, and reconfigure paths
concurrently — one lock guards all state.  The half-open probe token is
part of that state, so exactly one thread wins the probe.

Observability: transitions land in crypto_breaker_transitions_total{to}
and the crypto_breaker_open gauge of a bound metric surface (any object
with the JAX package's obs.Metrics attribute names); `status()` feeds the
/statusz "crypto" section so degraded mode is visible post-hoc.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Optional

logger = logging.getLogger(__name__)

__all__ = ["CircuitBreaker", "DeviceLossError", "DispatchTimeout",
           "InjectedDeviceFault"]


class InjectedDeviceFault(RuntimeError):
    """Raised by `CircuitBreaker.raise_if_injected` while a fault window
    is armed — the chaos harness's stand-in for a CUDA runtime error or
    a torn link on the device dispatch/readback path."""


class DispatchTimeout(RuntimeError):
    """A device dispatch/readback overran its watchdog deadline
    (cuda_provider `dispatch_deadline_s`).  When the chaos `dcn_stall`
    held it (`injected` set), it flows through the caller's normal
    device-failure handling — breaker failure + exact host-oracle
    re-verify; a real overrun propagates to the caller.  The abandoned
    readback keeps its daemon worker thread until the device returns
    (or, for the injected stall, until the stall is cleared)."""


class DeviceLossError(RuntimeError):
    """A mesh lane is lost (chaos `device_loss`, or a real torn lane
    surfaced by the runtime): dispatches touching `device` raise instead
    of completing.  Carries the device name so the MeshSupervisor can
    quarantine the exact lane and rebuild a survivor sub-mesh."""

    def __init__(self, device: str, message: str = ""):
        super().__init__(message or f"mesh lane lost ({device})")
        self.device = device

CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half_open"


class CircuitBreaker:
    """Consecutive-failure circuit breaker with half-open probes."""

    def __init__(self, failure_threshold: int = 3, cooldown_s: float = 5.0,
                 metrics=None, recorder=None,
                 clock=time.monotonic):
        self.failure_threshold = max(int(failure_threshold), 1)
        self.cooldown_s = cooldown_s
        self._clock = clock
        self._lock = threading.Lock()
        self._state = CLOSED
        self._consecutive_failures = 0
        self._opened_at: Optional[float] = None
        self._probe_inflight = False
        self._probe_started: Optional[float] = None
        self.metrics = metrics
        self.recorder = recorder
        #: Lifetime counts, served through status().
        self.total_failures = 0
        self.total_fallbacks = 0
        self.times_opened = 0
        #: Last record_failure reason ("" until the first failure) — the
        #: one line that makes a half-open flap diagnosable from
        #: /statusz alone.
        self._last_failure_reason = ""
        #: Fault-injection window (sim/chaos.py `device_fault` events):
        #: while armed, device paths that call raise_if_injected() fail,
        #: driving the real open → fallback → half-open → closed cycle.
        self._inject_until: Optional[float] = None
        self._inject_min_left = 0
        #: Bumped by every inject_faults(): raise_if_injected() hands the
        #: current value to the call it admits, and record_success(epoch)
        #: ignores a call admitted before the latest window was armed.
        self._inject_epoch = 0
        self.total_injected = 0

    # -- decision ----------------------------------------------------------

    def allow(self) -> bool:
        """May this call use the device?  False = route to the host
        oracle.  In half-open, only the first caller gets True (the
        probe); everyone else stays on the host until it reports."""
        with self._lock:
            if self._state == CLOSED:
                return True
            if self._state == OPEN:
                if self._clock() - self._opened_at >= self.cooldown_s:
                    self._transition(HALF_OPEN)
                else:
                    self.total_fallbacks += 1
                    return False
            # HALF_OPEN: hand out exactly one probe token.  A probe whose
            # outcome was never reported (its resolver abandoned — e.g.
            # the awaiting task torn down mid-restart) expires after one
            # cooldown, so the breaker can never wedge in half-open.
            now = self._clock()
            if (self._probe_inflight and self._probe_started is not None
                    and now - self._probe_started >= self.cooldown_s):
                self._probe_inflight = False
            if not self._probe_inflight:
                self._probe_inflight = True
                self._probe_started = now
                return True
            self.total_fallbacks += 1
            return False

    # -- fault injection (chaos) -------------------------------------------

    def inject_faults(self, duration_s: float, min_faults: int = 0) -> None:
        """Arm a fault window: for `duration_s` from now, every device
        path that consults raise_if_injected() fails as if the device
        dispatch/readback had thrown.  The breaker then runs its REAL
        state machine — consecutive failures open it, cooldown probes
        recover it once the window has passed.

        min_faults > 0 keeps the window armed past `duration_s` until at
        least that many faults have actually been injected — a target
        that spends the wall-clock window crashed (or simply idle) would
        otherwise see too few device calls to ever trip the breaker,
        and the chaos schedule's open→half-open→closed obligation would
        silently evaporate.  Chaos passes the breaker's own
        failure_threshold, guaranteeing the open: every call admitted
        while the window is armed fails, and a call admitted before it
        that resolves cleanly inside it cannot reset the count (its
        success, reported with its epoch, is ignored)."""
        with self._lock:
            self._inject_epoch += 1
            self._inject_until = self._clock() + duration_s
            self._inject_min_left = max(int(min_faults), 0)
        logger.warning("device breaker: fault injection armed for %.2fs"
                       " (min_faults=%d)", duration_s, min_faults)
        if self.recorder is not None:
            self.recorder.record("device_fault_injected",
                                 duration_s=duration_s,
                                 min_faults=min_faults)

    def clear_injected_faults(self) -> None:
        with self._lock:
            self._inject_until = None
            self._inject_min_left = 0

    def _inject_armed_locked(self) -> bool:
        """Caller holds the lock.  Armed while the wall-clock window is
        live OR the min-faults quota is unspent; disarms itself once
        both are exhausted."""
        if self._inject_until is None:
            return False
        if self._clock() < self._inject_until or self._inject_min_left > 0:
            return True
        self._inject_until = None
        return False

    @property
    def fault_injected(self) -> bool:
        with self._lock:
            return self._inject_armed_locked()

    @property
    def epoch(self) -> int:
        """The fault-window epoch a call admitted now runs under (what
        raise_if_injected returns outside a window)."""
        with self._lock:
            return self._inject_epoch

    def raise_if_injected(self, path: str = "") -> int:
        """Device paths call this right after winning allow(): raises
        InjectedDeviceFault while a fault window is armed, flowing
        through the caller's normal device-failure handling
        (record_failure + host-oracle fallback).  Otherwise returns the
        fault-window epoch the call was admitted under, for its
        record_success(epoch)."""
        with self._lock:
            if not self._inject_armed_locked():
                return self._inject_epoch
            self.total_injected += 1
            if self._inject_min_left > 0:
                self._inject_min_left -= 1
        raise InjectedDeviceFault(
            f"injected device fault ({path or 'device'})")

    # -- outcomes ----------------------------------------------------------

    def record_success(self, epoch: Optional[int] = None) -> None:
        """A clean device call.  `epoch` is what raise_if_injected()
        returned when the call was admitted: a call admitted before the
        latest fault window was armed ran on a device that was not yet
        failing, so its success neither resets the failure count nor
        closes the breaker (else calls in flight across the window's
        start can spend its min_faults without opening it)."""
        with self._lock:
            if epoch is not None and epoch != self._inject_epoch:
                return
            self._consecutive_failures = 0
            self._probe_inflight = False
            if self._state != CLOSED:
                self._transition(CLOSED)

    def record_failure(self, reason: str = "") -> None:
        with self._lock:
            self.total_failures += 1
            if reason:
                self._last_failure_reason = reason
            self._probe_inflight = False
            if self._state == HALF_OPEN:
                # The probe failed: straight back to open, fresh cooldown.
                self._transition(OPEN, reason)
                return
            self._consecutive_failures += 1
            if (self._state == CLOSED
                    and self._consecutive_failures >= self.failure_threshold):
                self._transition(OPEN, reason)

    # -- introspection -----------------------------------------------------

    @property
    def state(self) -> str:
        with self._lock:
            return self._state

    def status(self) -> dict:
        """JSON-encodable snapshot for /statusz."""
        with self._lock:
            cooldown_remaining = 0.0
            if self._state == OPEN and self._opened_at is not None:
                cooldown_remaining = max(
                    0.0, self.cooldown_s - (self._clock() - self._opened_at))
            return {
                "state": self._state,
                "consecutive_failures": self._consecutive_failures,
                "total_failures": self.total_failures,
                "total_fallbacks": self.total_fallbacks,
                "times_opened": self.times_opened,
                "last_failure_reason": self._last_failure_reason,
                "cooldown_remaining_s": round(cooldown_remaining, 4),
                "fault_injected": self._inject_armed_locked(),
                "total_injected": self.total_injected,
            }

    # -- internals ---------------------------------------------------------

    def _transition(self, to: str, reason: str = "") -> None:
        """Caller holds the lock."""
        if to == self._state:
            return
        logger.warning("device breaker %s -> %s%s", self._state, to,
                       f" ({reason})" if reason else "")
        self._state = to
        if to == OPEN:
            self._opened_at = self._clock()
            self._consecutive_failures = 0
            self.times_opened += 1
        if self.metrics is not None:
            self.metrics.breaker_transitions.labels(to=to).inc()
            self.metrics.breaker_open.set(1.0 if to == OPEN else 0.0)
        if self.recorder is not None:
            self.recorder.record("breaker_transition", to=to, reason=reason)
