"""GrpcBrain: the ConsensusAdapter backed by the sibling controller and
network microservices — the production counterpart of the in-process
SimAdapter (reference `Brain`, src/consensus.rs:490-780).

The engine drives these callbacks; each one is an RPC round trip to a
localhost sibling:

  get_block            → controller.GetProposal   (src/consensus.rs:517-558)
  check_block          → controller.CheckProposal (src/consensus.rs:560-592)
  commit               → controller.CommitBlock   (src/consensus.rs:594-657)
  broadcast_to_other   → network.Broadcast, origin 0 (src/consensus.rs:668-719)
  transmit_to_relayer  → network.SendMsg, origin = first 8 address bytes
                         (src/consensus.rs:721-771, src/util.rs:93-97)

Failures raise ``BrainError``; the engine's posture is log-and-retry-later
(a failed get_block skips a round, a failed commit re-arms on the next QC),
matching the reference's boxed-error returns.

The port's own copy of consensus_overlord_tpu/service/brain.py; a failed
call of either transport arrives as rpc.RpcError.
"""

from __future__ import annotations

import logging
from typing import List, Optional

from ..core.sm3 import sm3_hash
from ..core.types import (
    Address,
    Commit,
    DurationConfig,
    Hash,
    Node,
    Status,
    validator_to_origin,
    validators_to_nodes,
)
from .pb import pb2
from .rpc import Code, ControllerClient, NetworkClient, RpcError, is_transient

logger = logging.getLogger("consensus_overlord_tpu_torch.brain")


class BrainError(Exception):
    """A chain/network callback failed (reference ConsensusError::Other,
    src/error.rs:20-44).

    `transient` carries the RetryClient's transient-vs-fatal verdict
    through to the engine: True for sibling hiccups the engine's own
    recovery machinery (commit retry timer, next-round re-propose,
    RichStatus resync) will clear; False for contract violations —
    mis-wired ports, a protocol mismatch — where every retry will fail
    identically and the log line should say so."""

    def __init__(self, message: str, transient: bool = True):
        super().__init__(message)
        self.transient = transient


def _wrap_rpc(op: str, e: RpcError) -> BrainError:
    transient = is_transient(e.code)
    return BrainError(
        f"{op}: rpc {e.code}"
        + ("" if transient else " (non-transient: check service wiring)"),
        transient=transient)


class GrpcBrain:
    """ConsensusAdapter over the controller/network RPC clients.

    Holds the validator-node cache the reference keeps behind
    ``Arc<RwLock<Vec<Node>>>`` (src/consensus.rs:493) — here plain state,
    since everything runs on one asyncio loop.
    """

    def __init__(self, crypto, controller: ControllerClient,
                 network: NetworkClient):
        self._crypto = crypto
        self._controller = controller
        self._network = network
        self._nodes: List[Node] = []

    # -- node cache (reference src/consensus.rs:504-512) -------------------

    def set_nodes(self, nodes: List[Node]) -> None:
        self._nodes = list(nodes)

    def get_nodes(self) -> List[Node]:
        return list(self._nodes)

    # -- chain callbacks ----------------------------------------------------

    async def get_block(self, height: int) -> tuple[bytes, Hash]:
        """Controller GetProposal with the height-mismatch rejection
        (src/consensus.rs:531-535: a stale/ahead proposal is an error, the
        engine skips the round instead of proposing the wrong height)."""
        try:
            resp = await self._controller.get_proposal()
        except RpcError as e:
            raise _wrap_rpc("get_proposal", e) from e
        if resp.status.code != Code.SUCCESS:
            raise BrainError(f"get_proposal status {resp.status.code}")
        if resp.proposal.height != height:
            raise BrainError(
                f"get_block height mismatch: want {height}, "
                f"controller has {resp.proposal.height}")
        data = resp.proposal.data
        return data, sm3_hash(data)

    async def check_block(self, height: int, block_hash: Hash,
                          content: bytes) -> bool:
        try:
            code = await self._controller.check_proposal(height, content)
        except RpcError as e:
            raise _wrap_rpc("check_proposal", e) from e
        if code != Code.SUCCESS:
            logger.warning("check_proposal failed: code %d", code)
        return code == Code.SUCCESS

    async def commit(self, height: int, commit: Commit) -> Optional[Status]:
        """CommitBlock; on success refresh the node list + pubkey cache from
        the returned configuration and hand the engine its next-height
        marching orders (src/consensus.rs:612-657)."""
        try:
            resp = await self._controller.commit_block(
                height, commit.content, commit.proof.encode())
        except RpcError as e:
            raise _wrap_rpc("commit_block", e) from e
        if resp.status.code != Code.SUCCESS:
            raise BrainError(f"commit_block status {resp.status.code}")
        config = resp.config
        nodes = validators_to_nodes(config.validators)
        self.set_nodes(nodes)
        update = getattr(self._crypto, "update_pubkeys", None)
        if update is not None:
            update(list(config.validators))
        return Status(
            height=config.height + 1,
            interval=config.block_interval * 1000,
            timer_config=DurationConfig(),
            authority_list=nodes,
        )

    async def get_authority_list(self, height: int) -> List[Node]:
        return self.get_nodes()

    # -- outbound network ---------------------------------------------------

    async def broadcast_to_other(self, msg_type: str, payload: bytes) -> None:
        msg = pb2.NetworkMsg(module="consensus", type=msg_type, origin=0,
                             msg=payload)
        try:
            code = await self._network.broadcast(msg)
        except RpcError as e:
            raise _wrap_rpc("broadcast", e) from e
        if code != Code.SUCCESS:
            raise BrainError(f"broadcast status {code}")

    async def transmit_to_relayer(self, relayer: Address, msg_type: str,
                                  payload: bytes) -> None:
        msg = pb2.NetworkMsg(module="consensus", type=msg_type,
                             origin=validator_to_origin(relayer), msg=payload)
        try:
            code = await self._network.send_msg(msg)
        except RpcError as e:
            raise _wrap_rpc("send_msg", e) from e
        if code != Code.SUCCESS:
            raise BrainError(f"send_msg status {code}")

    # -- reporting (log-only, src/consensus.rs:773-779) ---------------------

    def report_error(self, context: str) -> None:
        logger.warning("report_error: %s", context)

    def report_view_change(self, height: int, round: int, reason: str) -> None:
        logger.info("view change h=%d r=%d: %s", height, round, reason)
