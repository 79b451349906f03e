"""The four ports of the consensus core.

The reference's architecture hands its engine four adapter objects
(Overlord::new(name, brain, crypto, wal), reference src/consensus.rs:64-69);
everything external to the state machine sits behind one of these narrow
interfaces.  That decomposition is the thing worth keeping (SURVEY.md §4
"Implication for the rebuild"), so it is made explicit here:

  ConsensusAdapter — the "Brain": chain + outbound-network callbacks
                     (Overlord `Consensus<T>` trait, src/consensus.rs:515-780)
  CryptoProvider   — sign/verify/aggregate (src/consensus.rs:385-463);
                     defined in crypto/provider.py
  Wal              — crash-recovery byte blob (src/consensus.rs:314-332)
  (inbound network is the engine mailbox: OverlordHandler::send_msg,
   src/consensus.rs:114, 216, 228, 240, 252)

The port's own copy of consensus_overlord_tpu/ports/__init__.py
(the port imports nothing of the JAX package).
"""

from __future__ import annotations

from typing import List, Optional, Protocol, runtime_checkable

from ..core.types import Address, Commit, Hash, Node, Status
from ..crypto.provider import CryptoProvider  # noqa: F401  (re-export)


@runtime_checkable
class ConsensusAdapter(Protocol):
    """Chain + outbound-network callbacks the engine drives (the reference's
    `Brain`, src/consensus.rs:491-780)."""

    async def get_block(self, height: int) -> tuple[bytes, Hash]:
        """Fetch proposable content for `height` → (content, content_hash).
        Reference: Brain::get_block → controller get_proposal, rejecting
        height mismatch (src/consensus.rs:517-558)."""
        ...

    async def check_block(self, height: int, block_hash: Hash,
                          content: bytes) -> bool:
        """Validate foreign proposal content.  Reference: Brain::check_block →
        controller check_proposal (src/consensus.rs:560-592)."""
        ...

    async def commit(self, height: int, commit: Commit) -> Optional[Status]:
        """Commit a decided block; returns the next-height Status (possibly a
        new authority list).  Reference: Brain::commit → controller
        commit_block (src/consensus.rs:594-657)."""
        ...

    async def get_authority_list(self, height: int) -> List[Node]:
        """Current validators (reference src/consensus.rs:659-666)."""
        ...

    async def broadcast_to_other(self, msg_type: str, payload: bytes) -> None:
        """Broadcast an RLP-encoded consensus message to all peers
        (reference src/consensus.rs:668-719)."""
        ...

    async def transmit_to_relayer(self, relayer: Address, msg_type: str,
                                  payload: bytes) -> None:
        """Point-to-point send to one validator — the vote-relay path
        (reference src/consensus.rs:721-771)."""
        ...

    def report_error(self, context: str) -> None:
        """Log-only error surface (reference src/consensus.rs:773-775)."""
        ...

    def report_view_change(self, height: int, round: int, reason: str) -> None:
        """Log-only view-change surface (reference src/consensus.rs:777-779)."""
        ...


@runtime_checkable
class Wal(Protocol):
    """Single-slot crash-recovery blob (reference src/consensus.rs:295-332:
    save overwrites, load returns contents-or-None)."""

    async def save(self, data: bytes) -> None: ...

    async def load(self) -> Optional[bytes]: ...
