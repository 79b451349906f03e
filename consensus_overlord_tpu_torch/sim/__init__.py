"""In-process multi-validator simulation harness.

The reference has no in-repo integration tests — multi-node behavior needs a
deployed CITA-Cloud chain (SURVEY.md §4).  Because every external dependency
of the core sits behind a narrow port, N engines can run a real consensus in
one process: a fake controller plays the chain, an asyncio router plays the
network microservice (broadcast/send_msg semantics, reference
src/consensus.rs:668-771) with fault injection (drop/delay/partition).
This is also the scaffold for the BASELINE.md measurement configs
(4 → 10k validator fleets).

The port's own copy of consensus_overlord_tpu/sim/ (the port imports
nothing of the JAX package).  sim/grpc_fakes.py holds the service's fake
siblings (the network service and the controller), on either RPC
transport.
"""

from .harness import SimNetwork, SimNode  # noqa: F401
from .router import Router  # noqa: F401
from .controller import SafetyViolation, SimController  # noqa: F401
from .chaos import ChaosEvent, ChaosRunner, ChaosSchedule  # noqa: F401
from .adversary import (  # noqa: F401
    AdversaryShim,
    BEHAVIORS,
    REJECTION_REASONS,
)
