"""The shared wire layer: the compact object encoding, content
negotiation and the watch-frame protocol, used by both ends of the HTTP
data plane (``rest.RestClient`` and ``relay.WatchRelay``).

The JAX package's ``kube/wire.py``, copied whole: the compact bytes are
the JAX codec's byte for byte, so the port's client talks to the JAX
package's API server and relay, and the JAX client to the port's relay,
with no shim.

* **Compact encoding**: a binary serialization of the JSON data model
  (None/bool/int/float/str/list/dict) with varint lengths and a
  per-message *key table*: the first occurrence of a dict key travels as
  UTF-8, every repeat as a one-or-two-byte back-reference. Kubernetes
  payloads repeat keys in every item of a list, which is the redundancy
  protobuf's field tags remove; the key table removes it without a
  schema.
* **Negotiation**: ``negotiate_encoding`` picks the response encoding
  from the request's ``Accept`` header; ``decode_body`` dispatches on a
  response or request ``Content-Type``. Unknown or absent headers
  degrade to JSON, so a JSON-only peer on either side keeps working.
* **Watch frames**: one watch event a frame. JSON streams are
  newline-delimited; compact streams are length-prefixed (a 4-byte
  big-endian length, then the compact payload).
"""

from __future__ import annotations

import json
import struct
from typing import Any, Iterator, Optional

#: The negotiated compact media type (``;v=1`` so a future layout bump
#: can coexist); matched by prefix on both ends.
COMPACT_CONTENT_TYPE = "application/vnd.tpu-operator.compact;v=1"
_COMPACT_PREFIX = "application/vnd.tpu-operator.compact"
JSON_CONTENT_TYPE = "application/json"

#: What a compact-speaking client sends: prefer compact, accept JSON —
#: an old server that has never heard of the compact type answers JSON
#: and nothing breaks (the negotiation-fallback contract).
CLIENT_ACCEPT_COMPACT = f"{COMPACT_CONTENT_TYPE}, application/json"

# -- type tags -------------------------------------------------------------
_T_NONE = 0x00
_T_TRUE = 0x01
_T_FALSE = 0x02
_T_INT = 0x03
_T_FLOAT = 0x04
_T_STR = 0x05
_T_LIST = 0x06
_T_DICT = 0x07
_K_DEF = 0x00  # key literal: assigns the next key-table index
_K_REF = 0x01  # key back-reference by index

_pack_float = struct.Struct(">d").pack
_unpack_float = struct.Struct(">d").unpack_from
_FRAME_HEADER = struct.Struct(">I")


class WireDecodeError(ValueError):
    """Malformed compact payload (truncated, bad tag, bad key ref)."""


def _append_varint(buf: bytearray, value: int) -> None:
    while value > 0x7F:
        buf.append((value & 0x7F) | 0x80)
        value >>= 7
    buf.append(value)


def _encode_value(buf: bytearray, value: Any, keys: dict[str, int]) -> None:
    if value is None:
        buf.append(_T_NONE)
    elif value is True:
        buf.append(_T_TRUE)
    elif value is False:
        buf.append(_T_FALSE)
    elif isinstance(value, int):
        buf.append(_T_INT)
        # zigzag so negatives stay short
        _append_varint(buf, value << 1 if value >= 0
                       else ((-value) << 1) - 1)
    elif isinstance(value, float):
        buf.append(_T_FLOAT)
        buf += _pack_float(value)
    elif isinstance(value, str):
        buf.append(_T_STR)
        raw = value.encode("utf-8")
        _append_varint(buf, len(raw))
        buf += raw
    elif isinstance(value, (list, tuple)):
        buf.append(_T_LIST)
        _append_varint(buf, len(value))
        for item in value:
            _encode_value(buf, item, keys)
    elif isinstance(value, dict):
        buf.append(_T_DICT)
        _append_varint(buf, len(value))
        for key, item in value.items():
            if not isinstance(key, str):
                raise TypeError(
                    f"compact encoding requires str keys, got {type(key)}"
                )
            index = keys.get(key)
            if index is None:
                keys[key] = len(keys)
                buf.append(_K_DEF)
                raw = key.encode("utf-8")
                _append_varint(buf, len(raw))
                buf += raw
            else:
                buf.append(_K_REF)
                _append_varint(buf, index)
            _encode_value(buf, item, keys)
    else:
        raise TypeError(
            f"compact encoding cannot serialize {type(value).__name__}"
        )


def encode_compact(obj: Any) -> bytes:
    """Serialize a JSON-model value to the compact wire form."""
    buf = bytearray()
    _encode_value(buf, obj, {})
    return bytes(buf)


class _Reader:
    __slots__ = ("data", "pos", "keys")

    def __init__(self, data: bytes) -> None:
        self.data = data
        self.pos = 0
        self.keys: list[str] = []

    def byte(self) -> int:
        try:
            b = self.data[self.pos]
        except IndexError:
            raise WireDecodeError("truncated compact payload") from None
        self.pos += 1
        return b

    def varint(self) -> int:
        shift = 0
        out = 0
        while True:
            b = self.byte()
            out |= (b & 0x7F) << shift
            if not b & 0x80:
                return out
            shift += 7
            if shift > 127:  # bounds a hostile stream; ints are unbounded
                raise WireDecodeError("varint overflow")

    def take(self, n: int) -> bytes:
        end = self.pos + n
        if end > len(self.data):
            raise WireDecodeError("truncated compact payload")
        out = self.data[self.pos:end]
        self.pos = end
        return out


def _decode_value(r: _Reader) -> Any:
    tag = r.byte()
    if tag == _T_NONE:
        return None
    if tag == _T_TRUE:
        return True
    if tag == _T_FALSE:
        return False
    if tag == _T_INT:
        z = r.varint()
        return (z >> 1) if not z & 1 else -((z + 1) >> 1)
    if tag == _T_FLOAT:
        (out,) = _unpack_float(r.take(8))
        return out
    if tag == _T_STR:
        return r.take(r.varint()).decode("utf-8")
    if tag == _T_LIST:
        return [_decode_value(r) for _ in range(r.varint())]
    if tag == _T_DICT:
        out = {}
        for _ in range(r.varint()):
            kind = r.byte()
            if kind == _K_DEF:
                key = r.take(r.varint()).decode("utf-8")
                r.keys.append(key)
            elif kind == _K_REF:
                index = r.varint()
                try:
                    key = r.keys[index]
                except IndexError:
                    raise WireDecodeError(
                        f"key back-reference {index} out of range"
                    ) from None
            else:
                raise WireDecodeError(f"bad key tag 0x{kind:02x}")
            out[key] = _decode_value(r)
        return out
    raise WireDecodeError(f"bad type tag 0x{tag:02x}")


def decode_compact(data: bytes) -> Any:
    """Parse a compact payload back into the JSON data model."""
    r = _Reader(data)
    out = _decode_value(r)
    if r.pos != len(data):
        raise WireDecodeError(
            f"{len(data) - r.pos} trailing bytes after compact payload"
        )
    return out


# -- content negotiation ---------------------------------------------------
def is_compact_content_type(content_type: Optional[str]) -> bool:
    return bool(content_type) and content_type.strip().lower().startswith(
        _COMPACT_PREFIX
    )


def negotiate_encoding(accept_header: Optional[str]) -> str:
    """Server-side pick from the request's ``Accept``: ``"compact"``
    only when the caller listed the compact media type, ``"json"``
    otherwise (including no header at all) — JSON stays the protocol
    default, exactly the real apiserver's protobuf posture."""
    for clause in (accept_header or "").split(","):
        if clause.split(";", 1)[0].strip().lower() == _COMPACT_PREFIX:
            return "compact"
        # Parameterized spelling: the ;v=1 travels as a media-type
        # parameter, so the prefix match above already caught it.
    return "json"


def content_type_for(encoding: str) -> str:
    return COMPACT_CONTENT_TYPE if encoding == "compact" else JSON_CONTENT_TYPE


def encode_body(obj: Any, encoding: str) -> bytes:
    if encoding == "compact":
        return encode_compact(obj)
    return json.dumps(obj).encode()


def decode_body(data: bytes, content_type: Optional[str]) -> Any:
    """Decode a request/response body by its ``Content-Type`` — the
    client never guesses what the server sent, and vice versa."""
    if is_compact_content_type(content_type):
        return decode_compact(data)
    return json.loads(data)


# -- watch frame protocol --------------------------------------------------
def encode_watch_frame(event: dict, encoding: str) -> bytes:
    """One watch event as one wire frame. JSON: a newline-delimited
    line (the previous stream shape — old consumers keep reading it).
    Compact: 4-byte big-endian length prefix + compact payload."""
    if encoding == "compact":
        payload = encode_compact(event)
        return _FRAME_HEADER.pack(len(payload)) + payload
    return json.dumps(event).encode() + b"\n"


class FrameDecoder:
    """Incremental watch-frame decoder for one stream direction.

    Feed raw bytes as they arrive (chunk boundaries are transport
    noise — frames may span chunks and chunks may hold many frames);
    iterate decoded events. The encoding is fixed per stream by the
    response ``Content-Type``."""

    def __init__(self, content_type: Optional[str]) -> None:
        self.compact = is_compact_content_type(content_type)
        self._buf = bytearray()

    def feed(self, data: bytes) -> Iterator[dict]:
        self._buf += data
        if self.compact:
            while len(self._buf) >= 4:
                (length,) = _FRAME_HEADER.unpack_from(self._buf)
                if len(self._buf) < 4 + length:
                    return
                payload = bytes(self._buf[4:4 + length])
                del self._buf[:4 + length]
                yield decode_compact(payload)
        else:
            while True:
                newline = self._buf.find(b"\n")
                if newline < 0:
                    return
                line = bytes(self._buf[:newline])
                del self._buf[:newline + 1]
                if line.strip():
                    yield json.loads(line)

    @property
    def pending_bytes(self) -> int:
        """Bytes buffered without a complete frame — nonzero at stream
        end means a truncated tail (the stream died mid-frame)."""
        return len(self._buf)
