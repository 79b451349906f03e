"""Round tagging (frontier flush → dispatch → readback → verdict).

The part of consensus_overlord_tpu/obs/fleet.py the provider binds, as
the port's own copy: the round-id helpers.  `next_round_id()` hands the
frontier a process-monotonic round id at each flush; `tag_round` carries
it onto the dispatcher thread (a plain thread-local — the frontier's
executor serializes dispatches, and `loop.run_in_executor` does not
propagate contextvars) so DeviceProfiler.begin stamps it into every
stage-ring record.  The straggler detector and the fleet aggregator are
not ported yet.
"""

from __future__ import annotations

import itertools
import threading
from contextlib import contextmanager
from typing import Optional

__all__ = ["current_round_id", "next_round_id", "tag_round"]

_round_counter = itertools.count(1)
_round_tls = threading.local()


def next_round_id() -> int:
    """A process-monotonic round id.  The frontier draws one per flush;
    everything the flush touches carries it."""
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
