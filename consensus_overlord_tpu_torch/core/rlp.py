"""RLP (Recursive Length Prefix) codec.

The reference serializes every consensus wire type (Proof, SignedVote,
AggregatedVote, SignedProposal, SignedChoke, Vote) with the `rlp` crate
(reference src/consensus.rs:36-38 and use sites at 158, 175, 212, 224, 236,
248, 602, 680, 690, 699, 738, 751).  This is a from-scratch implementation of
the same standard encoding (Ethereum yellow-paper RLP): items are either byte
strings or lists of items.

Integers are encoded big-endian with no leading zeros (0 encodes as the empty
byte string), matching the rlp crate's u64 behaviour.

The port's own copy of consensus_overlord_tpu/core/rlp.py
(the port imports nothing of the JAX package).
"""

from __future__ import annotations

from typing import Iterable, List, Union

RlpItem = Union[bytes, List["RlpItem"]]


class RlpError(ValueError):
    """Malformed RLP input."""


def encode_int(value: int) -> bytes:
    if value < 0:
        raise RlpError(f"cannot RLP-encode negative integer {value}")
    if value == 0:
        return b""
    return value.to_bytes((value.bit_length() + 7) // 8, "big")


def decode_int(data: bytes) -> int:
    if not isinstance(data, (bytes, bytearray)):
        raise RlpError(f"RLP integer must be bytes, got {type(data).__name__}")
    if data[:1] == b"\x00":
        raise RlpError("leading zero in RLP integer")
    return int.from_bytes(data, "big")


def _encode_length(length: int, offset: int) -> bytes:
    if length < 56:
        return bytes([offset + length])
    length_bytes = encode_int(length)
    return bytes([offset + 55 + len(length_bytes)]) + length_bytes


def encode(item: RlpItem) -> bytes:
    """Encode bytes / int / list-of-items to RLP."""
    if isinstance(item, int):
        item = encode_int(item)
    if isinstance(item, (bytes, bytearray, memoryview)):
        item = bytes(item)
        if len(item) == 1 and item[0] < 0x80:
            return item
        return _encode_length(len(item), 0x80) + item
    if isinstance(item, (list, tuple)):
        payload = b"".join(encode(sub) for sub in item)
        return _encode_length(len(payload), 0xC0) + payload
    raise RlpError(f"cannot RLP-encode {type(item).__name__}")


# Nesting bound: deeper input is adversarial (a few-KB message could
# otherwise force RecursionError, escaping the callers' RlpError contract).
MAX_DEPTH = 64


def _decode_at(data: bytes, pos: int, depth: int = 0) -> tuple[RlpItem, int]:
    if depth > MAX_DEPTH:
        raise RlpError("RLP nesting too deep")
    if pos >= len(data):
        raise RlpError("truncated RLP")
    prefix = data[pos]
    if prefix < 0x80:  # single byte literal
        return bytes([prefix]), pos + 1
    if prefix < 0xB8:  # short string
        length = prefix - 0x80
        end = pos + 1 + length
        payload = data[pos + 1 : end]
        if len(payload) != length:
            raise RlpError("truncated RLP string")
        if length == 1 and payload[0] < 0x80:
            raise RlpError("non-canonical single byte")
        return payload, end
    if prefix < 0xC0:  # long string
        len_of_len = prefix - 0xB7
        length = decode_int(data[pos + 1 : pos + 1 + len_of_len])
        if length < 56:
            raise RlpError("non-canonical long-string length")
        start = pos + 1 + len_of_len
        end = start + length
        if end > len(data):
            raise RlpError("truncated RLP string")
        return data[start:end], end
    if prefix < 0xF8:  # short list
        length = prefix - 0xC0
        end = pos + 1 + length
        if end > len(data):
            raise RlpError("truncated RLP list")
        return _decode_list(data, pos + 1, end, depth), end
    # long list
    len_of_len = prefix - 0xF7
    length = decode_int(data[pos + 1 : pos + 1 + len_of_len])
    if length < 56:
        raise RlpError("non-canonical long-list length")
    start = pos + 1 + len_of_len
    end = start + length
    if end > len(data):
        raise RlpError("truncated RLP list")
    return _decode_list(data, start, end, depth), end


def _decode_list(data: bytes, start: int, end: int, depth: int) -> List[RlpItem]:
    items: List[RlpItem] = []
    pos = start
    while pos < end:
        item, pos = _decode_at(data, pos, depth + 1)
        items.append(item)
    if pos != end:
        raise RlpError("list payload overrun")
    return items


def decode(data: bytes) -> RlpItem:
    """Decode a single RLP item; rejects trailing bytes."""
    item, end = _decode_at(bytes(data), 0)
    if end != len(data):
        raise RlpError(f"trailing bytes after RLP item ({len(data) - end})")
    return item
