"""Flight recorder: a bounded ring buffer of structured engine events.

Prometheus answers "how much / how fast"; when a Byzantine test fails or
a node wedges, the question is "what were the last N things the engine
DID" — state transitions, QC formations, drops at the frontier — in
order.  The reference has nothing like it (its posture is log-and-drop,
src/consensus.rs:220-260); grepping interleaved multi-node logs after a
randomized adversarial schedule is how round-5 debugging actually went,
which is why this exists.

Design constraints:

  * recording sits on the consensus hot path (every round transition,
    every inbound drop) — one dict build + deque.append, no formatting,
    no I/O, never raises;
  * bounded: a deque(maxlen=capacity) so a flooding adversary can't grow
    a node's memory through its own observability;
  * thread-safe for readers: the frontier's dispatch worker and the
    statusz HTTP thread read while the event loop writes (CPython deque
    append/snapshot are atomic; `tail` copies before slicing);
  * dump() renders one event per line for pytest failure output and
    sim-harness post-mortems.

Event shape: {"seq": int, "ts": float, "mono": float, "kind": str,
**fields} — kinds are free-form strings ("enter_round", "qc_formed",
"frontier_drop", ...); fields must be JSON-encodable (statusz serves
the tail verbatim).  `ts` is wall-clock for humans; `mono` is
time.monotonic() so reconstructed timelines (scripts/waterfall.py)
survive clock steps during soaks.

The port's own copy of consensus_overlord_tpu/obs/flightrec.py
(the port imports nothing of the JAX package).
"""

from __future__ import annotations

import io
import itertools
import time
from collections import deque
from typing import List, Optional

__all__ = ["FlightRecorder"]


class FlightRecorder:
    """Bounded in-memory ring of structured events."""

    def __init__(self, capacity: int = 512):
        self._events: deque = deque(maxlen=max(int(capacity), 1))
        self._seq = itertools.count()
        self.capacity = max(int(capacity), 1)
        #: Lifetime events recorded / overwritten out of the ring.  The
        #: soak sampler (obs/telemetry.py) differences `dropped` across
        #: samples: ring churn RATE is the signal — a quiet engine whose
        #: ring suddenly cycles every few seconds is misbehaving even if
        #: every individual event looks routine.  (CPython int += under
        #: the GIL is safe for the single-writer engine loop; readers
        #: only ever see a slightly stale count.)
        self.recorded = 0
        self.dropped = 0

    def record(self, kind: str, **fields) -> None:
        """Append one event.  Hot-path cheap; never raises."""
        try:
            event = {"seq": next(self._seq), "ts": time.time(),
                     "mono": time.monotonic(), "kind": kind}
            event.update(fields)
            if len(self._events) == self.capacity:
                self.dropped += 1  # the append below evicts the oldest
            self._events.append(event)
            self.recorded += 1
        except Exception:  # noqa: BLE001 — observability never breaks SMR
            pass

    def __len__(self) -> int:
        return len(self._events)

    def tail(self, n: Optional[int] = None) -> List[dict]:
        """The most recent `n` events (all when None, none when <= 0),
        oldest first."""
        events = list(self._events)  # snapshot: writers may be appending
        if n is not None:
            events = events[-n:] if n > 0 else []
        return events

    def stats(self) -> dict:
        """Ring occupancy + lifetime churn counters (JSON-encodable)."""
        return {"events": len(self._events), "capacity": self.capacity,
                "recorded": self.recorded, "dropped": self.dropped}

    def clear(self) -> None:
        self._events.clear()

    def dump(self, n: Optional[int] = None) -> str:
        """Human-readable tail, one event per line — for test-failure
        output and sim post-mortems."""
        out = io.StringIO()
        for e in self.tail(n):
            extras = " ".join(f"{k}={e[k]!r}" for k in e
                              if k not in ("seq", "ts", "mono", "kind"))
            out.write(f"[{e['seq']:6d} {e['ts']:.6f}] "
                      f"{e['kind']:<16s} {extras}\n")
        return out.getvalue()
