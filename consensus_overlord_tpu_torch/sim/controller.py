"""Fake controller: the in-process stand-in for the CITA-Cloud controller
microservice (the chain side of the Brain callbacks, reference
src/consensus.rs:517-657).

Serves proposals, validates them, accepts commits, and answers the
reconfiguration queries — while asserting chain-level safety: every node must
commit the same block bytes at every height (no forks).

The port's own copy of consensus_overlord_tpu/sim/controller.py
(the port imports nothing of the JAX package).
"""

from __future__ import annotations

import asyncio
from typing import Dict, List, Optional, Sequence

from ..core import rlp
from ..core.sm3 import sm3_hash
from ..core.types import (
    Commit,
    DurationConfig,
    Hash,
    Node,
    Status,
    validators_to_nodes,
)


class SafetyViolation(AssertionError):
    """Two different blocks committed at one height — consensus safety broke."""


class SimController:
    def __init__(self, validators: Sequence[bytes], block_interval_ms: int = 200,
                 timer_config: Optional[DurationConfig] = None):
        self.validators = [bytes(v) for v in validators]
        self.block_interval_ms = block_interval_ms
        self.timer_config = timer_config or DurationConfig()
        #: height -> committed block content (chain-level single source of truth)
        self.chain: Dict[int, bytes] = {}
        #: height -> proof bytes from the first committer
        self.proofs: Dict[int, bytes] = {}
        #: per-node commit log for assertions
        self.commit_log: List[tuple[bytes, int, Hash]] = []
        self._height_event = asyncio.Event()
        #: callbacks fired on each new chain height — the harness uses this to
        #: push RichStatus to every node, mirroring CITA-Cloud's controller
        #: re-reconfiguring consensus after each committed block (the lagging-
        #: node resync path, reference src/main.rs:92-104 + consensus.rs:97-141)
        self.on_new_height: List = []
        #: Safety violations recorded (then raised) by commit_block —
        #: chaos runs assert this is empty even when the raising path was
        #: swallowed by an engine's log-and-drop commit handler.
        self.violations: List[str] = []
        # Injected fault window (sim/chaos.py): while active, every Brain
        # callback stalls ("stall") or raises ("error").
        self._fault_mode: Optional[str] = None
        self._fault_until: float = 0.0

    # -- fault injection (sim/chaos.py) ------------------------------------

    def inject_fault(self, mode: str, duration_s: float) -> None:
        """Wedge ("stall") or break ("error") every controller callback
        for `duration_s` from now."""
        assert mode in ("stall", "error"), mode
        self._fault_mode = mode
        self._fault_until = asyncio.get_running_loop().time() + duration_s

    async def _fault_gate(self) -> None:
        """Applied at the top of every Brain callback: error-mode raises,
        stall-mode blocks until the window closes (a wedged controller —
        the engine's propose timers and commit-retry must carry it)."""
        if self._fault_mode is None:
            return
        loop = asyncio.get_running_loop()
        if self._fault_mode == "error":
            if loop.time() < self._fault_until:
                raise RuntimeError("injected controller fault (chaos)")
            self._fault_mode = None
            return
        while loop.time() < self._fault_until:
            await asyncio.sleep(
                min(self._fault_until - loop.time(), 0.05))
        self._fault_mode = None

    # -- chain side (Brain callbacks) --------------------------------------

    def make_content(self, height: int) -> bytes:
        """Deterministic block payload for `height` (empty-block analog of the
        reference's controller get_proposal)."""
        return rlp.encode([height, b"simulated block", b"\x00" * 32])

    async def get_proposal(self, height: int) -> tuple[bytes, Hash]:
        await self._fault_gate()
        content = self.make_content(height)
        return content, sm3_hash(content)

    async def check_proposal(self, height: int, block_hash: Hash,
                             content: bytes) -> bool:
        await self._fault_gate()
        return (content == self.make_content(height)
                and block_hash == sm3_hash(content))

    async def commit_block(self, node: bytes, height: int,
                           commit: Commit) -> Status:
        await self._fault_gate()
        existing = self.chain.get(height)
        if existing is not None and existing != commit.content:
            msg = f"fork at height {height}: two distinct blocks committed"
            self.violations.append(msg)
            raise SafetyViolation(msg)
        if existing is None:
            self.chain[height] = commit.content
            self.proofs[height] = commit.proof.encode()
            self._height_event.set()
            self._height_event = asyncio.Event()
            for cb in self.on_new_height:
                cb(height)
        self.commit_log.append((bytes(node), height, sm3_hash(commit.content)))
        return self.next_status(height)

    def next_status(self, height: int) -> Status:
        return Status(
            height=height + 1,
            interval=self.block_interval_ms,
            timer_config=self.timer_config,
            authority_list=self.authority_list(),
        )

    def authority_list(self) -> List[Node]:
        return validators_to_nodes(self.validators)

    @property
    def latest_height(self) -> int:
        return max(self.chain) if self.chain else 0

    async def wait_for_height(self, height: int, timeout: float = 30.0) -> None:
        """Block until some node commits `height`."""
        loop = asyncio.get_running_loop()
        deadline = loop.time() + timeout
        while self.latest_height < height:
            remaining = deadline - loop.time()
            if remaining <= 0:
                raise asyncio.TimeoutError(
                    f"chain stuck at height {self.latest_height}, "
                    f"wanted {height}")
            try:
                await asyncio.wait_for(
                    asyncio.shield(self._height_event.wait()), remaining)
            except asyncio.TimeoutError:
                continue
