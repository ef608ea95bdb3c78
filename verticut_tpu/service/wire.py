"""msgpack encoding for the RPC front-end and its client.

The wire format is standard msgpack (the msgpack specification,
``spec.md`` of the msgpack project), so any msgpack-RPC peer interoperates.
Only the types the RPC methods carry are implemented: nil, bool, int,
float, str, bin, array and map. Integers take the smallest encoding, as
the reference's msgpack library writes them; floats are written as
float64; ``str`` and ``bytes`` map to str and bin.
"""

from __future__ import annotations

import numbers
import struct

_INT_FORMATS = ((1 << 8, 0xCC, ">B"), (1 << 16, 0xCD, ">H"),
                (1 << 32, 0xCE, ">I"), (1 << 64, 0xCF, ">Q"))
_NEG_FORMATS = ((1 << 7, 0xD0, ">b"), (1 << 15, 0xD1, ">h"),
                (1 << 31, 0xD2, ">i"), (1 << 63, 0xD3, ">q"))
#: fixed-width scalars: type byte -> struct format
_SCALARS = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
            0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q",
            0xCA: ">f", 0xCB: ">d"}
#: length-prefixed types: type byte -> (length format, kind)
_SIZED = {0xC4: (">B", "bin"), 0xC5: (">H", "bin"), 0xC6: (">I", "bin"),
          0xD9: (">B", "str"), 0xDA: (">H", "str"), 0xDB: (">I", "str"),
          0xDC: (">H", "array"), 0xDD: (">I", "array"),
          0xDE: (">H", "map"), 0xDF: (">I", "map")}


def packb(obj) -> bytes:
    """Encode ``obj`` as one msgpack object."""
    out = bytearray()
    _pack(obj, out)
    return bytes(out)


def _header(out: bytearray, n: int, fix: int, fix_max: int,
            formats) -> None:
    """Length header: the fix form below ``fix_max``, else the first of
    ``formats`` ((limit, type byte, struct format), ...) that fits."""
    if n < fix_max:
        out.append(fix | n)
        return
    for limit, code, fmt in formats:
        if n < limit:
            out.append(code)
            out += struct.pack(fmt, n)
            return
    raise ValueError(f"msgpack object of length {n} is too long")


def _pack(obj, out: bytearray) -> None:
    if obj is None:
        out.append(0xC0)
    elif obj is True or obj is False:
        out.append(0xC3 if obj else 0xC2)
    elif isinstance(obj, numbers.Integral):
        _pack_int(int(obj), out)
    elif isinstance(obj, float):
        out.append(0xCB)
        out += struct.pack(">d", obj)
    elif isinstance(obj, str):
        b = obj.encode("utf-8")
        _header(out, len(b), 0xA0, 32, ((1 << 8, 0xD9, ">B"),
                                        (1 << 16, 0xDA, ">H"),
                                        (1 << 32, 0xDB, ">I")))
        out += b
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        b = bytes(obj)
        _header(out, len(b), 0, 0, ((1 << 8, 0xC4, ">B"),
                                    (1 << 16, 0xC5, ">H"),
                                    (1 << 32, 0xC6, ">I")))
        out += b
    elif isinstance(obj, (list, tuple)):
        _header(out, len(obj), 0x90, 16, ((1 << 16, 0xDC, ">H"),
                                          (1 << 32, 0xDD, ">I")))
        for x in obj:
            _pack(x, out)
    elif isinstance(obj, dict):
        _header(out, len(obj), 0x80, 16, ((1 << 16, 0xDE, ">H"),
                                          (1 << 32, 0xDF, ">I")))
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    else:
        raise TypeError(f"cannot encode {type(obj).__name__} as msgpack")


def _pack_int(v: int, out: bytearray) -> None:
    if 0 <= v < 128:
        out.append(v)
        return
    if -32 <= v < 0:
        out.append(v & 0xFF)
        return
    for limit, code, fmt in (_INT_FORMATS if v >= 0 else _NEG_FORMATS):
        if (v < limit) if v >= 0 else (v >= -limit):
            out.append(code)
            out += struct.pack(fmt, v)
            return
    raise OverflowError(f"integer {v} does not fit in 64 bits")


class _Incomplete(Exception):
    """The buffer ends inside an item."""


def _take(buf, pos: int, n: int):
    if pos + n > len(buf):
        raise _Incomplete
    return buf[pos:pos + n], pos + n


def _head(buf, pos: int):
    """Decode the item at ``pos``: ``(value, None, next_pos)`` for a
    scalar, str or bin; ``(empty container, n, next_pos)`` for the header
    of an array or map of ``n`` entries. Raises _Incomplete, consuming
    nothing, when the item runs past the buffer."""
    if pos >= len(buf):
        raise _Incomplete
    b = buf[pos]
    pos += 1
    if b <= 0x7F:
        return b, None, pos
    if b >= 0xE0:
        return b - 0x100, None, pos
    if b <= 0x8F:
        return {}, b & 0x0F, pos
    if b <= 0x9F:
        return [], b & 0x0F, pos
    if b <= 0xBF:
        raw, pos = _take(buf, pos, b & 0x1F)
        return bytes(raw).decode("utf-8"), None, pos
    if b == 0xC0:
        return None, None, pos
    if b in (0xC2, 0xC3):
        return b == 0xC3, None, pos
    if b in _SCALARS:
        fmt = _SCALARS[b]
        raw, pos = _take(buf, pos, struct.calcsize(fmt))
        return struct.unpack(fmt, raw)[0], None, pos
    if b in _SIZED:
        fmt, kind = _SIZED[b]
        raw, pos = _take(buf, pos, struct.calcsize(fmt))
        n = struct.unpack(fmt, raw)[0]
        if kind == "array":
            return [], n, pos
        if kind == "map":
            return {}, n, pos
        raw, pos = _take(buf, pos, n)
        return (bytes(raw) if kind == "bin"
                else bytes(raw).decode("utf-8")), None, pos
    raise ValueError(f"unsupported msgpack type byte 0x{b:02x}")


_NO_KEY = object()


class Unpacker:
    """Streaming decoder: ``feed`` bytes as they arrive, iterate to take
    every complete object; a partial object waits for more bytes.

    Decoding resumes where it stopped: containers still being filled wait
    on a stack, so every byte is parsed once however the stream is split."""

    def __init__(self):
        self._buf = bytearray()
        self._pos = 0
        self._stack = []        # [container, entries left, pending map key]

    def feed(self, data: bytes) -> None:
        self._buf += data

    def __iter__(self):
        return self

    def __next__(self):
        stack = self._stack
        while True:
            try:
                obj, n, self._pos = _head(self._buf, self._pos)
            except _Incomplete:
                del self._buf[:self._pos]
                self._pos = 0
                raise StopIteration from None
            if n:
                stack.append([obj, n, _NO_KEY])
                continue
            # a finished value fills its container, which may finish too
            while stack:
                frame = stack[-1]
                if isinstance(frame[0], list):
                    frame[0].append(obj)
                elif frame[2] is _NO_KEY:
                    frame[2] = obj
                    break
                else:
                    frame[0][frame[2]] = obj
                    frame[2] = _NO_KEY
                frame[1] -= 1
                if frame[1]:
                    break
                obj = stack.pop()[0]
            else:
                return obj


def unpackb(data: bytes):
    """Decode exactly one msgpack object."""
    u = Unpacker()
    u.feed(data)
    try:
        obj = next(u)
    except StopIteration:
        raise ValueError("truncated msgpack data") from None
    if u._pos != len(u._buf):
        raise ValueError(f"{len(u._buf) - u._pos} bytes after the msgpack "
                         "object")
    return obj
