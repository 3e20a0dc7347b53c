"""Frame codec for the TCP service plane.

A copy of the JAX package's ``runtime/transports/codec.py`` with a msgpack
codec of its own: the card's machine has no ``msgpack`` package, and every
streamed token crosses this codec.  Reference semantics:
lib/runtime/src/pipeline/network/codec/two_part.rs — length-prefixed
framing where a request is two frames (REQ_HEADER carrying the control
message, REQ_DATA carrying the serialized request).  Responses stream as
RESP_* frames on the same connection; CANCEL/KILL flow client→server
mid-stream (the reference's ZMQ control messages).  Every frame carries a
u32 STREAM id, so one connection multiplexes many concurrent requests;
stream 0 is connection control (heartbeats):

    [1 byte type][4 bytes stream id][4 bytes payload length][payload]

Payloads are msgpack, byte for byte what ``msgpack.packb(obj,
use_bin_type=True)`` writes for the types the planes send — None, bool,
int in [-2**63, 2**64), float (as float64), str, bytes (bin), list and
tuple (arrays), dict (maps) — and are read as ``msgpack.unpackb(raw,
raw=False)`` reads them (arrays as lists, map keys str or bytes only).  A
value msgpack cannot take (an unsupported type, a str with lone
surrogates) falls back to ``b"\\x00json"`` + JSON, as in the JAX codec; an
int out of range raises ``OverflowError``.  So either package reads the
other's frames.
"""

from __future__ import annotations

import asyncio
import enum
import json
import struct
from dataclasses import dataclass
from typing import Any, List, Tuple

MAX_FRAME = 256 * 1024 * 1024  # 256 MiB guard against corrupt length prefixes
_HDR = struct.Struct(">BII")


class FrameType(enum.IntEnum):
    REQ_HEADER = 1  # control message: {id, endpoint, request_type}
    REQ_DATA = 2  # request payload
    RESP_PROLOGUE = 3  # {ok: bool, error: str|None} — reference's ResponseStreamPrologue
    RESP_ITEM = 4  # one streamed response item
    RESP_COMPLETE = 5  # end of stream
    RESP_ERROR = 6  # mid-stream error (terminates stream)
    CANCEL = 7  # client → server: stop_generating()
    KILL = 8  # client → server: kill()
    HEARTBEAT = 9


@dataclass(frozen=True)
class Frame:
    type: FrameType
    payload: bytes
    stream: int = 0  # multiplexing stream id (0 = connection control)

    def unpack(self) -> Any:
        return decode(self.payload)


# -- msgpack -------------------------------------------------------------------

_B = struct.Struct(">B")
_H = struct.Struct(">BH")
_I = struct.Struct(">BI")
_Q = struct.Struct(">BQ")
_b = struct.Struct(">Bb")
_h = struct.Struct(">Bh")
_i = struct.Struct(">Bi")
_q = struct.Struct(">Bq")
_D = struct.Struct(">Bd")


def _pack_int(v: int, out: List[bytes]) -> None:
    # msgpack-python's choice of format: the smallest that holds the value,
    # unsigned formats for non-negative values.
    if v < -32:
        if v < -(1 << 15):
            if v < -(1 << 31):
                if v < -(1 << 63):
                    raise OverflowError("Integer value out of range")
                out.append(_q.pack(0xD3, v))
            else:
                out.append(_i.pack(0xD2, v))
        elif v < -(1 << 7):
            out.append(_h.pack(0xD1, v))
        else:
            out.append(_b.pack(0xD0, v))
    elif v < 0:
        out.append(_B.pack(v & 0xFF))  # negative fixint
    elif v < 0x80:
        out.append(_B.pack(v))  # positive fixint
    elif v < 0x100:
        out.append(bytes((0xCC, v)))
    elif v < 0x10000:
        out.append(_H.pack(0xCD, v))
    elif v < 0x100000000:
        out.append(_I.pack(0xCE, v))
    elif v < 0x10000000000000000:
        out.append(_Q.pack(0xCF, v))
    else:
        raise OverflowError("Integer value out of range")


def _pack_len(n: int, fix: int, fix_max: int, c8: int, c16: int, c32: int,
              out: List[bytes]) -> None:
    if n < fix_max:
        out.append(_B.pack(fix | n))
    elif c8 and n < 0x100:
        out.append(bytes((c8, n)))
    elif n < 0x10000:
        out.append(_H.pack(c16, n))
    elif n < 0x100000000:
        out.append(_I.pack(c32, n))
    else:
        raise ValueError(f"object too large to pack ({n})")


def _pack(obj: Any, out: List[bytes], depth: int = 0) -> None:
    if depth > 512:
        raise ValueError("recursion limit exceeded")
    if obj is None:
        out.append(b"\xc0")
    elif obj is True:
        out.append(b"\xc3")
    elif obj is False:
        out.append(b"\xc2")
    elif isinstance(obj, int):
        _pack_int(int(obj), out)
    elif isinstance(obj, float):
        out.append(_D.pack(0xCB, obj))
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        raw = bytes(obj)
        n = len(raw)
        if n < 0x100:
            out.append(bytes((0xC4, n)))
        elif n < 0x10000:
            out.append(_H.pack(0xC5, n))
        elif n < 0x100000000:
            out.append(_I.pack(0xC6, n))
        else:
            raise ValueError("bytes object is too large")
        out.append(raw)
    elif isinstance(obj, str):
        raw = obj.encode("utf-8")  # lone surrogates raise (a ValueError)
        _pack_len(len(raw), 0xA0, 32, 0xD9, 0xDA, 0xDB, out)
        out.append(raw)
    elif isinstance(obj, dict):
        _pack_len(len(obj), 0x80, 16, 0, 0xDE, 0xDF, out)
        for k, v in obj.items():
            _pack(k, out, depth + 1)
            _pack(v, out, depth + 1)
    elif isinstance(obj, (list, tuple)):
        _pack_len(len(obj), 0x90, 16, 0, 0xDC, 0xDD, out)
        for v in obj:
            _pack(v, out, depth + 1)
    else:
        raise TypeError(f"can not serialize {type(obj).__name__!r} object")


def packb(obj: Any) -> bytes:
    """``msgpack.packb(obj, use_bin_type=True)`` for the planes' types."""
    out: List[bytes] = []
    _pack(obj, out)
    return b"".join(out)


_FIXED = {
    0xCC: struct.Struct(">B"), 0xCD: struct.Struct(">H"),
    0xCE: struct.Struct(">I"), 0xCF: struct.Struct(">Q"),
    0xD0: struct.Struct(">b"), 0xD1: struct.Struct(">h"),
    0xD2: struct.Struct(">i"), 0xD3: struct.Struct(">q"),
    0xCA: struct.Struct(">f"), 0xCB: struct.Struct(">d"),
}
_LEN = {1: struct.Struct(">B"), 2: struct.Struct(">H"), 4: struct.Struct(">I")}


def _need(buf: bytes, pos: int, n: int) -> None:
    if pos + n > len(buf):
        raise ValueError("Unpack failed: incomplete input")


def _read_len(buf: bytes, pos: int, width: int) -> Tuple[int, int]:
    _need(buf, pos, width)
    return _LEN[width].unpack_from(buf, pos)[0], pos + width


def _unpack(buf: bytes, pos: int, depth: int = 0) -> Tuple[Any, int]:
    if depth > 512:
        raise ValueError("recursion limit exceeded")
    _need(buf, pos, 1)
    c = buf[pos]
    pos += 1
    if c < 0x80:
        return c, pos
    if c >= 0xE0:
        return c - 0x100, pos
    if 0xA0 <= c <= 0xBF:
        return _str(buf, pos, c & 0x1F)
    if 0x90 <= c <= 0x9F:
        return _array(buf, pos, c & 0x0F, depth)
    if 0x80 <= c <= 0x8F:
        return _map(buf, pos, c & 0x0F, depth)
    if c == 0xC0:
        return None, pos
    if c == 0xC2:
        return False, pos
    if c == 0xC3:
        return True, pos
    fixed = _FIXED.get(c)
    if fixed is not None:
        _need(buf, pos, fixed.size)
        return fixed.unpack_from(buf, pos)[0], pos + fixed.size
    if c in (0xD9, 0xDA, 0xDB):
        n, pos = _read_len(buf, pos, {0xD9: 1, 0xDA: 2, 0xDB: 4}[c])
        return _str(buf, pos, n)
    if c in (0xC4, 0xC5, 0xC6):
        n, pos = _read_len(buf, pos, {0xC4: 1, 0xC5: 2, 0xC6: 4}[c])
        _need(buf, pos, n)
        return bytes(buf[pos:pos + n]), pos + n
    if c in (0xDC, 0xDD):
        n, pos = _read_len(buf, pos, 2 if c == 0xDC else 4)
        return _array(buf, pos, n, depth)
    if c in (0xDE, 0xDF):
        n, pos = _read_len(buf, pos, 2 if c == 0xDE else 4)
        return _map(buf, pos, n, depth)
    # ext types (0xc7-0xc9, 0xd4-0xd8) are never written by either codec
    raise ValueError(f"unsupported msgpack type byte 0x{c:02x}")


def _str(buf: bytes, pos: int, n: int) -> Tuple[str, int]:
    _need(buf, pos, n)
    return bytes(buf[pos:pos + n]).decode("utf-8"), pos + n


def _array(buf: bytes, pos: int, n: int, depth: int) -> Tuple[list, int]:
    out = []
    for _ in range(n):
        v, pos = _unpack(buf, pos, depth + 1)
        out.append(v)
    return out, pos


def _map(buf: bytes, pos: int, n: int, depth: int) -> Tuple[dict, int]:
    out = {}
    for _ in range(n):
        k, pos = _unpack(buf, pos, depth + 1)
        if type(k) not in (str, bytes):
            # msgpack's strict_map_key (the unpackb default)
            raise ValueError(
                f"{type(k).__name__} is not allowed for map key when strict_map_key=True"
            )
        v, pos = _unpack(buf, pos, depth + 1)
        out[k] = v
    return out, pos


def unpackb(buf: bytes) -> Any:
    """``msgpack.unpackb(buf, raw=False)``."""
    obj, pos = _unpack(buf, 0)
    if pos != len(buf):
        raise ValueError("Unpack failed: extra data")
    return obj


# -- frames --------------------------------------------------------------------


def encode(obj: Any) -> bytes:
    try:
        return packb(obj)
    except (TypeError, ValueError):
        return b"\x00json" + json.dumps(obj).encode()


def decode(buf: bytes) -> Any:
    if buf[:5] == b"\x00json":
        return json.loads(buf[5:])
    return unpackb(buf)


async def write_frame(
    writer: asyncio.StreamWriter,
    ftype: FrameType,
    obj: Any = None,
    *,
    stream: int = 0,
    raw: bytes | None = None,
) -> None:
    payload = raw if raw is not None else encode(obj)
    writer.write(_HDR.pack(int(ftype), stream, len(payload)) + payload)
    await writer.drain()


async def read_frame(reader: asyncio.StreamReader) -> Frame:
    hdr = await reader.readexactly(_HDR.size)
    ftype, stream, length = _HDR.unpack(hdr)
    if length > MAX_FRAME:
        raise ValueError(f"frame length {length} exceeds MAX_FRAME")
    payload = await reader.readexactly(length) if length else b""
    return Frame(FrameType(ftype), payload, stream)
