"""The provider protocol, the host BLS12-381 provider (CPU oracle) and
the provider error type.

The pieces of consensus_overlord_tpu/crypto/provider.py this port needs,
kept as its own copy: `CryptoProvider` (what the engine needs from a
crypto backend: the Overlord `Crypto` trait surface, reference
src/consensus.rs:385-463), `CryptoError` (reference error.rs:20-44
`ConsensusError::CryptoErr`) and `CpuBlsCrypto`, the reference-faithful
min-sig provider whose per-signature verify is the exact fallback of the
device paths.
"""

from __future__ import annotations

from typing import List, Protocol, Sequence, runtime_checkable

from ..core.sm3 import sm3_hash
from . import bls12381 as bls


class CryptoError(Exception):
    """Crypto failure (reference error.rs:20-44 `ConsensusError::CryptoErr`)."""


@runtime_checkable
class CryptoProvider(Protocol):
    """What the engine needs from a crypto backend."""

    @property
    def pub_key(self) -> bytes:
        """This node's identity: serialized public key bytes, doubling as its
        validator address (reference src/consensus.rs:352-357)."""
        ...

    def hash(self, data: bytes) -> bytes: ...

    def sign(self, hash32: bytes) -> bytes: ...

    def verify_signature(self, signature: bytes, hash32: bytes,
                         voter: bytes) -> bool: ...

    def aggregate_signatures(self, signatures: Sequence[bytes],
                             voters: Sequence[bytes]) -> bytes: ...

    def verify_aggregated_signature(self, agg_sig: bytes, hash32: bytes,
                                    voters: Sequence[bytes]) -> bool: ...


class CpuBlsCrypto:
    """Reference-faithful BLS12-381 min-sig provider (CPU oracle).

    `common_ref` is the signing domain string — "" in the reference
    (src/consensus.rs:351)."""

    def __init__(self, private_key: int, common_ref: bytes = b""):
        self._sk = private_key % bls.R
        if self._sk == 0:
            raise CryptoError("private key is zero mod r")
        self._common_ref = common_ref
        self._pk = bls.sk_to_pk(self._sk)

    @property
    def pub_key(self) -> bytes:
        return self._pk

    def hash(self, data: bytes) -> bytes:
        return sm3_hash(data)

    def sign(self, hash32: bytes) -> bytes:
        return bls.sign(self._sk, hash32, self._common_ref)

    def verify_signature(self, signature: bytes, hash32: bytes,
                         voter: bytes) -> bool:
        return bls.verify(voter, hash32, signature, self._common_ref)

    def aggregate_signatures(self, signatures: Sequence[bytes],
                             voters: Sequence[bytes]) -> bytes:
        # Length check mirrors reference src/consensus.rs:424-429.
        if len(signatures) != len(voters):
            raise CryptoError(
                f"signatures x voters length mismatch "
                f"{len(signatures)} x {len(voters)}")
        try:
            return bls.aggregate_signatures(signatures)
        except ValueError as e:
            raise CryptoError(str(e)) from e

    def verify_aggregated_signature(self, agg_sig: bytes, hash32: bytes,
                                    voters: Sequence[bytes]) -> bool:
        return bls.aggregate_verify_same_message(
            voters, hash32, agg_sig, self._common_ref)

    def verify_batch(self, signatures: Sequence[bytes],
                     hashes: Sequence[bytes],
                     voters: Sequence[bytes]) -> List[bool]:
        """Per-signature loop (the device provider batches this)."""
        return [self.verify_signature(s, h, v)
                for s, h, v in zip(signatures, hashes, voters)]
