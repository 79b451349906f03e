"""The messages of protos/consensus_overlord.proto as plain Python
classes, with proto3's wire encoding written out by hand.

The port's own copy of consensus_overlord_tpu/service/pb: the same
message names, fields and field numbers as the protoc-generated module,
and byte-identical `SerializeToString()` output, without
`google.protobuf`.  What the service uses of a generated class is here:
keyword construction, attribute access (an unset nested message reads as
its default), `HasField` for nested messages, `==`, `SerializeToString`
and the `FromString` class method.

Encoding (proto3): fields in field-number order; a scalar at its default
(0, b"", "") is not written; a nested message is written whenever it was
set, even empty; every element of a repeated field is written.  Parsing
skips unknown fields (wire types 0, 1, 2 and 5) and raises DecodeError
on truncated or malformed input.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

__all__ = [
    "ConsensusConfiguration", "ConsensusConfigurationResponse",
    "DecodeError", "Empty", "HealthCheckRequest", "HealthCheckResponse",
    "NetworkMsg", "Proposal", "ProposalResponse", "ProposalWithProof",
    "RegisterInfo", "StatusCode",
]

_U32 = (1 << 32) - 1
_U64 = (1 << 64) - 1


class DecodeError(Exception):
    """Malformed wire bytes (google.protobuf.message.DecodeError)."""


def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    result = shift = 0
    while True:
        if pos >= len(buf):
            raise DecodeError("truncated varint")
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result & _U64, pos
        shift += 7
        if shift >= 70:
            raise DecodeError("varint too long")


# Field kinds; the varint kinds map to their largest value.
_UINT32, _UINT64, _ENUM = "uint32", "uint64", "enum"
_BYTES, _STRING = "bytes", "string"
_MESSAGE, _REPEATED_BYTES = "message", "repeated_bytes"
_VARINT_KINDS = {_UINT32: _U32, _UINT64: _U64, _ENUM: _U32}


class _Message:
    """Base of the message classes.  `_FIELDS` lists (number, name, kind,
    message class or None) in field-number order."""

    _FIELDS: Tuple[tuple, ...] = ()
    __slots__ = ("_values",)

    def __init__(self, **kwargs):
        self._values: Dict[str, object] = {}
        names = {f[1] for f in self._FIELDS}
        for key, value in kwargs.items():
            if key not in names:
                raise ValueError(
                    f"{type(self).__name__} has no field {key!r}")
            setattr(self, key, value)

    def __getattr__(self, name):
        values = object.__getattribute__(self, "_values")
        if name in values:
            return values[name]
        for _, fname, kind, sub in type(self)._FIELDS:
            if fname == name:
                if kind == _MESSAGE:
                    return sub()
                if kind == _REPEATED_BYTES:
                    return self._values.setdefault(name, [])
                return "" if kind == _STRING else (
                    b"" if kind == _BYTES else 0)
        raise AttributeError(name)

    def __setattr__(self, name, value):
        if name == "_values":
            object.__setattr__(self, name, value)
            return
        for _, fname, kind, sub in self._FIELDS:
            if fname != name:
                continue
            if kind == _MESSAGE:
                if not isinstance(value, sub):
                    raise TypeError(f"{name} must be a {sub.__name__}")
            elif kind == _REPEATED_BYTES:
                value = [bytes(v) for v in value]
            elif kind == _BYTES:
                value = bytes(value)
            elif kind == _STRING:
                if not isinstance(value, str):
                    raise TypeError(f"{name} must be a str")
            else:
                value = int(value)
                if not 0 <= value <= _VARINT_KINDS[kind]:
                    raise ValueError(f"{name} out of range: {value}")
            self._values[name] = value
            return
        raise AttributeError(
            f"{type(self).__name__} has no field {name!r}")

    def HasField(self, name: str) -> bool:  # noqa: N802 — protobuf API
        for _, fname, kind, _ in self._FIELDS:
            if fname == name:
                if kind != _MESSAGE:
                    raise ValueError(
                        f"{name} is not a message field (proto3 scalars "
                        "have no presence)")
                return name in self._values
        raise ValueError(f"{type(self).__name__} has no field {name!r}")

    def SerializeToString(self) -> bytes:  # noqa: N802 — protobuf API
        out = bytearray()
        for number, name, kind, _ in self._FIELDS:
            if name not in self._values:
                continue
            value = self._values[name]
            if kind == _MESSAGE:
                body = value.SerializeToString()
                out += _varint(number << 3 | 2) + _varint(len(body)) + body
            elif kind == _REPEATED_BYTES:
                for item in value:
                    out += _varint(number << 3 | 2) + _varint(len(item))
                    out += item
            elif kind in (_BYTES, _STRING):
                data = value.encode() if kind == _STRING else value
                if data:
                    out += _varint(number << 3 | 2) + _varint(len(data))
                    out += data
            elif value:
                out += _varint(number << 3) + _varint(value)
        return bytes(out)

    @classmethod
    def FromString(cls, data: bytes):  # noqa: N802 — protobuf API
        msg = cls()
        fields = {f[0]: f for f in cls._FIELDS}
        data = bytes(data)
        pos = 0
        while pos < len(data):
            key, pos = _read_varint(data, pos)
            number, wire = key >> 3, key & 7
            if number == 0:
                raise DecodeError("field number 0")
            if wire == 0:
                value, pos = _read_varint(data, pos)
            elif wire == 2:
                size, pos = _read_varint(data, pos)
                if pos + size > len(data):
                    raise DecodeError("truncated length-delimited field")
                value, pos = data[pos:pos + size], pos + size
            elif wire in (1, 5):
                pos += 8 if wire == 1 else 4
                if pos > len(data):
                    raise DecodeError("truncated fixed-width field")
                continue
            else:
                raise DecodeError(f"unsupported wire type {wire}")
            field = fields.get(number)
            if field is None:
                continue  # unknown field: skipped
            _, name, kind, sub = field
            if (wire == 0) != (kind in _VARINT_KINDS):
                continue  # a known number with another wire type
            if kind in _VARINT_KINDS:
                msg._values[name] = value & _VARINT_KINDS[kind]
            elif kind == _MESSAGE:
                part = sub.FromString(value)
                prev = msg._values.get(name)
                if prev is not None:  # repeated occurrences merge
                    part = sub.FromString(prev.SerializeToString() + value)
                msg._values[name] = part
            elif kind == _REPEATED_BYTES:
                msg._values.setdefault(name, []).append(value)
            elif kind == _STRING:
                try:
                    msg._values[name] = value.decode()
                except UnicodeDecodeError as e:
                    raise DecodeError(f"{name}: invalid UTF-8") from e
            else:
                msg._values[name] = value
        return msg

    def __eq__(self, other) -> bool:
        if type(other) is not type(self):
            return NotImplemented
        return self.SerializeToString() == other.SerializeToString()

    def __repr__(self) -> str:
        parts = [f"{name}={self._values[name]!r}"
                 for _, name, _, _ in self._FIELDS if name in self._values]
        return f"{type(self).__name__}({', '.join(parts)})"


class Empty(_Message):
    __slots__ = ()
    _FIELDS = ()


class StatusCode(_Message):
    __slots__ = ()
    _FIELDS = ((1, "code", _UINT32, None),)


class Proposal(_Message):
    __slots__ = ()
    _FIELDS = ((1, "height", _UINT64, None), (2, "data", _BYTES, None))


class ProposalResponse(_Message):
    __slots__ = ()
    _FIELDS = ((1, "status", _MESSAGE, StatusCode),
               (2, "proposal", _MESSAGE, Proposal))


class ProposalWithProof(_Message):
    __slots__ = ()
    _FIELDS = ((1, "proposal", _MESSAGE, Proposal),
               (2, "proof", _BYTES, None))


class ConsensusConfiguration(_Message):
    __slots__ = ()
    _FIELDS = ((1, "height", _UINT64, None),
               (2, "block_interval", _UINT32, None),
               (3, "validators", _REPEATED_BYTES, None))


class ConsensusConfigurationResponse(_Message):
    __slots__ = ()
    _FIELDS = ((1, "status", _MESSAGE, StatusCode),
               (2, "config", _MESSAGE, ConsensusConfiguration))


class NetworkMsg(_Message):
    __slots__ = ()
    _FIELDS = ((1, "module", _STRING, None), (2, "type", _STRING, None),
               (3, "origin", _UINT64, None), (4, "msg", _BYTES, None))


class RegisterInfo(_Message):
    __slots__ = ()
    _FIELDS = ((1, "module_name", _STRING, None),
               (2, "hostname", _STRING, None), (3, "port", _STRING, None))


class HealthCheckRequest(_Message):
    __slots__ = ()
    _FIELDS = ((1, "service", _STRING, None),)


class _EnumType:
    """The generated EnumTypeWrapper's lookups: Name, Value, items."""

    def __init__(self, name: str, values: List[Tuple[str, int]]):
        self._name = name
        self._values = dict(values)
        for key, number in values:
            setattr(self, key, number)

    def Name(self, number: int) -> str:  # noqa: N802 — protobuf API
        for key, n in self._values.items():
            if n == number:
                return key
        raise ValueError(f"enum {self._name} has no value {number}")

    def Value(self, name: str) -> int:  # noqa: N802 — protobuf API
        try:
            return self._values[name]
        except KeyError:
            raise ValueError(f"enum {self._name} has no name {name!r}")


class HealthCheckResponse(_Message):
    __slots__ = ()
    _FIELDS = ((1, "status", _ENUM, None),)
    ServingStatus = _EnumType("ServingStatus", [
        ("UNKNOWN", 0), ("SERVING", 1), ("NOT_SERVING", 2)])
    UNKNOWN = 0
    SERVING = 1
    NOT_SERVING = 2
