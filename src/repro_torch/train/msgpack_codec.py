"""The subset of MessagePack that checkpoint manifests use, with no
dependency: maps, arrays (lists and tuples), str, bytes, int, float, bool
and None.

:func:`packb` gives the bytes ``msgpack.packb`` gives with its defaults
(``use_bin_type=True``, doubles, the smallest integer format, non-negative
integers in the unsigned formats, dict keys in insertion order);
:func:`unpackb` reads them back as ``msgpack.unpackb`` does (arrays as
lists, str as str).  The reference writes its checkpoint manifests with
``msgpack``; the machine with the card has no such package.
"""
from __future__ import annotations

import struct
from typing import Any, Tuple


def _len_header(n: int, fix_base: int, fix_max: int, codes) -> bytes:
    if n <= fix_max:
        return bytes([fix_base | n])
    for code, fmt, limit in codes:
        if n < limit:
            return bytes([code]) + struct.pack(fmt, n)
    raise ValueError(f"msgpack: length {n} too large")


def _int(n: int) -> bytes:
    if 0 <= n < 128:
        return bytes([n])
    if -32 <= n < 0:
        return bytes([n & 0xFF])
    if n >= 0:
        for code, fmt, limit in ((0xcc, ">B", 1 << 8), (0xcd, ">H", 1 << 16),
                                 (0xce, ">I", 1 << 32), (0xcf, ">Q", 1 << 64)):
            if n < limit:
                return bytes([code]) + struct.pack(fmt, n)
    else:
        for code, fmt, limit in ((0xd0, ">b", 1 << 7), (0xd1, ">h", 1 << 15),
                                 (0xd2, ">i", 1 << 31), (0xd3, ">q", 1 << 63)):
            if n >= -limit:
                return bytes([code]) + struct.pack(fmt, n)
    raise OverflowError(f"msgpack: integer {n} out of range")


def _pack(obj: Any, out: list) -> None:
    if obj is None:
        out.append(b"\xc0")
    elif obj is True:
        out.append(b"\xc3")
    elif obj is False:
        out.append(b"\xc2")
    elif type(obj) is int:
        out.append(_int(obj))
    elif type(obj) is float:
        out.append(b"\xcb" + struct.pack(">d", obj))
    elif type(obj) is str:
        raw = obj.encode("utf-8")
        out.append(_len_header(len(raw), 0xa0, 31, (
            (0xd9, ">B", 1 << 8), (0xda, ">H", 1 << 16),
            (0xdb, ">I", 1 << 32))) + raw)
    elif type(obj) in (bytes, bytearray):
        n = len(obj)
        for code, fmt, limit in ((0xc4, ">B", 1 << 8), (0xc5, ">H", 1 << 16),
                                 (0xc6, ">I", 1 << 32)):
            if n < limit:
                out.append(bytes([code]) + struct.pack(fmt, n) + bytes(obj))
                break
    elif type(obj) in (list, tuple):
        out.append(_len_header(len(obj), 0x90, 15, (
            (0xdc, ">H", 1 << 16), (0xdd, ">I", 1 << 32))))
        for x in obj:
            _pack(x, out)
    elif type(obj) is dict:
        out.append(_len_header(len(obj), 0x80, 15, (
            (0xde, ">H", 1 << 16), (0xdf, ">I", 1 << 32))))
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    else:
        raise TypeError(f"can not serialize {type(obj).__name__!r} object")


def packb(obj: Any) -> bytes:
    out: list = []
    _pack(obj, out)
    return b"".join(out)


_FIXED = {0xcc: ">B", 0xcd: ">H", 0xce: ">I", 0xcf: ">Q", 0xd0: ">b",
          0xd1: ">h", 0xd2: ">i", 0xd3: ">q", 0xca: ">f", 0xcb: ">d"}
_STR = {0xd9: ">B", 0xda: ">H", 0xdb: ">I"}
_BIN = {0xc4: ">B", 0xc5: ">H", 0xc6: ">I"}
_ARR = {0xdc: ">H", 0xdd: ">I"}
_MAP = {0xde: ">H", 0xdf: ">I"}


def _read(fmt: str, data: bytes, i: int) -> Tuple[Any, int]:
    size = struct.calcsize(fmt)
    return struct.unpack_from(fmt, data, i)[0], i + size


def _unpack(data: bytes, i: int) -> Tuple[Any, int]:
    b = data[i]
    i += 1
    if b <= 0x7f:
        return b, i
    if b >= 0xe0:
        return b - 0x100, i
    if 0xa0 <= b <= 0xbf:
        n = b & 0x1f
        return data[i:i + n].decode("utf-8"), i + n
    if 0x90 <= b <= 0x9f or b in _ARR:
        n, i = (b & 0x0f, i) if b <= 0x9f else _read(_ARR[b], data, i)
        out = []
        for _ in range(n):
            x, i = _unpack(data, i)
            out.append(x)
        return out, i
    if 0x80 <= b <= 0x8f or b in _MAP:
        n, i = (b & 0x0f, i) if b <= 0x8f else _read(_MAP[b], data, i)
        out = {}
        for _ in range(n):
            k, i = _unpack(data, i)
            out[k], i = _unpack(data, i)
        return out, i
    if b == 0xc0:
        return None, i
    if b in (0xc2, 0xc3):
        return b == 0xc3, i
    if b in _FIXED:
        return _read(_FIXED[b], data, i)
    if b in _STR:
        n, i = _read(_STR[b], data, i)
        return data[i:i + n].decode("utf-8"), i + n
    if b in _BIN:
        n, i = _read(_BIN[b], data, i)
        return bytes(data[i:i + n]), i + n
    raise ValueError(f"msgpack: unsupported type byte 0x{b:02x}")


def unpackb(data: bytes) -> Any:
    obj, i = _unpack(bytes(data), 0)
    if i != len(data):
        raise ValueError("msgpack: extra data after the object")
    return obj
