"""Voter bitmaps for aggregated signatures.

An AggregatedSignature names its participants with a bitmap over the
authority list (reference src/consensus.rs:166-167 `extract_voters`).  The
convention here: the authority list is sorted by address bytes; bit i
(MSB-first within each byte) marks the i-th sorted validator as a signer.

The port's own copy of consensus_overlord_tpu/core/bitmap.py
(the port imports nothing of the JAX package).
"""

from __future__ import annotations

from typing import List, Sequence

from .types import Address, Node


def sorted_authorities(authority_list: Sequence[Node]) -> List[Node]:
    return sorted(authority_list, key=lambda n: n.address)


def build_bitmap(authority_list: Sequence[Node], voters: Sequence[Address]) -> bytes:
    """Bitmap with one bit per (sorted) authority, set for each voter."""
    nodes = sorted_authorities(authority_list)
    index = {n.address: i for i, n in enumerate(nodes)}
    bits = bytearray((len(nodes) + 7) // 8)
    for voter in voters:
        i = index.get(bytes(voter))
        if i is None:
            raise ValueError("voter not in authority list")
        bits[i // 8] |= 0x80 >> (i % 8)
    return bytes(bits)


def extract_voters(authority_list: Sequence[Node], bitmap: bytes) -> List[Address]:
    """Reference src/consensus.rs:167: recover the voter addresses named by
    the bitmap, in sorted-authority order."""
    nodes = sorted_authorities(authority_list)
    if len(bitmap) != (len(nodes) + 7) // 8:
        raise ValueError(
            f"bitmap length {len(bitmap)} does not cover {len(nodes)} authorities"
        )
    # Padding bits beyond the authority count must be zero: otherwise a
    # relayer could mint byte-distinct bitmaps naming identical voters,
    # breaking equality/dedup on proof bytes.
    for i in range(len(nodes), len(bitmap) * 8):
        if bitmap[i // 8] & (0x80 >> (i % 8)):
            raise ValueError("non-zero padding bit in voter bitmap")
    voters: List[Address] = []
    for i, node in enumerate(nodes):
        if bitmap[i // 8] & (0x80 >> (i % 8)):
            voters.append(node.address)
    return voters
