"""The Overlord-equivalent SMR engine and WAL.

The port's own copy of consensus_overlord_tpu/engine/__init__.py
(the port imports nothing of the JAX package).
"""

from .smr import Engine, EngineHandler, Step, NIL_HASH, quorum_weight  # noqa: F401
from .wal import FileWal, MemoryWal, OVERLORD_WAL_NAME  # noqa: F401
