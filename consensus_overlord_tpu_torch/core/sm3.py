"""SM3-256 cryptographic hash (GB/T 32905-2016).

The reference hashes every proposal and vote with SM3 via the `libsm` crate
(reference src/util.rs:81-87 `sm3_hash`, use sites src/consensus.rs:148, 175,
387, 541).  This is a from-scratch pure-Python implementation of the standard,
with OpenSSL's SM3 taken through hashlib where the interpreter provides it.

A copy of consensus_overlord_tpu/core/sm3.py: the PyTorch port imports
nothing of the JAX package, so it keeps its own.

Digest width: 32 bytes (HASH_BYTES_LEN in reference src/util.rs:82).
"""

from __future__ import annotations

import struct

HASH_BYTES_LEN = 32

_MASK = 0xFFFFFFFF
_IV = (
    0x7380166F, 0x4914B2B9, 0x172442D7, 0xDA8A0600,
    0xA96F30BC, 0x163138AA, 0xE38DEE4D, 0xB0FB0E4E,
)

# Round constants T_j rotated by j (precomputed).
def _rotl(x: int, n: int) -> int:
    n &= 31
    return ((x << n) | (x >> (32 - n))) & _MASK


_T = [_rotl(0x79CC4519 if j < 16 else 0x7A879D8A, j) for j in range(64)]


def _p0(x: int) -> int:
    return x ^ _rotl(x, 9) ^ _rotl(x, 17)


def _p1(x: int) -> int:
    return x ^ _rotl(x, 15) ^ _rotl(x, 23)


def _compress(v: tuple, block: bytes) -> tuple:
    w = list(struct.unpack(">16I", block))
    for j in range(16, 68):
        w.append(
            _p1(w[j - 16] ^ w[j - 9] ^ _rotl(w[j - 3], 15))
            ^ _rotl(w[j - 13], 7)
            ^ w[j - 6]
        )
    a, b, c, d, e, f, g, h = v
    for j in range(64):
        a12 = _rotl(a, 12)
        ss1 = _rotl((a12 + e + _T[j]) & _MASK, 7)
        ss2 = ss1 ^ a12
        wj = w[j]
        wpj = wj ^ w[j + 4]
        if j < 16:
            ff = a ^ b ^ c
            gg = e ^ f ^ g
        else:
            ff = (a & b) | (a & c) | (b & c)
            gg = (e & f) | (~e & g)
        tt1 = (ff + d + ss2 + wpj) & _MASK
        tt2 = (gg + h + ss1 + wj) & _MASK
        d = c
        c = _rotl(b, 9)
        b = a
        a = tt1
        h = g
        g = _rotl(f, 19)
        f = e
        e = _p0(tt2)
    return (
        a ^ v[0], b ^ v[1], c ^ v[2], d ^ v[3],
        e ^ v[4], f ^ v[5], g ^ v[6], h ^ v[7],
    )


try:  # OpenSSL-backed SM3 when the interpreter's hashlib provides it.
    import hashlib

    hashlib.new("sm3", b"")
    _HASHLIB_SM3 = True
except Exception:  # pragma: no cover - depends on OpenSSL build
    _HASHLIB_SM3 = False


def sm3_hash(data: bytes) -> bytes:
    """SM3-256 digest of `data` (32 bytes)."""
    if _HASHLIB_SM3:
        return hashlib.new("sm3", data).digest()
    return _sm3_hash_py(data)


def _sm3_hash_py(data: bytes) -> bytes:
    data = bytes(data)
    bit_len = len(data) * 8
    # Padding: 0x80, zeros, 64-bit big-endian bit length.
    data += b"\x80"
    data += b"\x00" * ((56 - len(data)) % 64)
    data += struct.pack(">Q", bit_len)
    v = _IV
    for off in range(0, len(data), 64):
        v = _compress(v, data[off : off + 64])
    return struct.pack(">8I", *v)
