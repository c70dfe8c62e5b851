"""The msgpack subset that 3FS persists, in pure Python.

``fs3/meta.py`` persists the namespace and ``fs3/kv.py`` packs objects
in msgpack, as the JAX package's copies do with the ``msgpack`` package.
The port keeps its own codec for the values they store: ``None``,
``bool``, ``int`` (64-bit), ``float``, ``str``, ``bytes`` (and
``bytearray`` / ``memoryview``), ``list`` / ``tuple`` and ``dict``.
``packb(obj)`` is byte-identical to ``msgpack.packb(obj)`` with its
defaults (``use_bin_type=True``: ``str`` as the str family, ``bytes``
as bin; floats as float 64; every integer in its shortest form), and
``unpackb(data)`` reads what ``msgpack.unpackb(data,
strict_map_key=False)`` reads (lists for arrays, ``str`` keys or any
other hashable key), so a 3FS root written by either package opens in
the other.  Any other type, an extension type on read or bytes after
the object raise.
"""
from __future__ import annotations

import struct

_B = struct.Struct(">B").pack
_BH = struct.Struct(">BH").pack
_BI = struct.Struct(">BI").pack
_BB = struct.Struct(">BB").pack
_BQ = struct.Struct(">BQ").pack
_Bb = struct.Struct(">Bb").pack
_Bh = struct.Struct(">Bh").pack
_Bi = struct.Struct(">Bi").pack
_Bq = struct.Struct(">Bq").pack
_Bd = struct.Struct(">Bd").pack


def _pack_int(x: int, out: list) -> None:
    if 0 <= x < 0x80:
        out.append(_B(x))
    elif -0x20 <= x < 0:
        out.append(_B(x & 0xFF))
    elif 0 <= x <= 0xFF:
        out.append(_BB(0xCC, x))
    elif -0x80 <= x < 0:
        out.append(_Bb(0xD0, x))
    elif 0 <= x <= 0xFFFF:
        out.append(_BH(0xCD, x))
    elif -0x8000 <= x < 0:
        out.append(_Bh(0xD1, x))
    elif 0 <= x <= 0xFFFFFFFF:
        out.append(_BI(0xCE, x))
    elif -0x80000000 <= x < 0:
        out.append(_Bi(0xD2, x))
    elif 0 <= x <= 0xFFFFFFFFFFFFFFFF:
        out.append(_BQ(0xCF, x))
    elif -0x8000000000000000 <= x < 0:
        out.append(_Bq(0xD3, x))
    else:
        raise OverflowError("Integer value out of range")


def _header(n: int, fix: int, fix_max: int, b8, b16: int, b32: int,
            out: list) -> None:
    """Length header: ``fix | n`` below ``fix_max``, else the 8-bit
    (``b8``, when the family has one), 16-bit or 32-bit form."""
    if n < fix_max:
        out.append(_B(fix | n))
    elif b8 is not None and n <= 0xFF:
        out.append(_BB(b8, n))
    elif n <= 0xFFFF:
        out.append(_BH(b16, n))
    elif n <= 0xFFFFFFFF:
        out.append(_BI(b32, n))
    else:
        raise ValueError(f"length {n} is too large for msgpack")


def _pack(obj, out: list) -> None:
    if obj is None:
        out.append(b"\xc0")
    elif obj is True:
        out.append(b"\xc3")
    elif obj is False:
        out.append(b"\xc2")
    elif isinstance(obj, int):
        _pack_int(int(obj), out)
    elif isinstance(obj, float):
        out.append(_Bd(0xCB, obj))
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        data = bytes(obj)
        n = len(data)
        if n <= 0xFF:
            out.append(_BB(0xC4, n))
        elif n <= 0xFFFF:
            out.append(_BH(0xC5, n))
        elif n <= 0xFFFFFFFF:
            out.append(_BI(0xC6, n))
        else:
            raise ValueError(f"bin of {n} bytes is too large for msgpack")
        out.append(data)
    elif isinstance(obj, str):
        data = obj.encode("utf-8")
        _header(len(data), 0xA0, 32, 0xD9, 0xDA, 0xDB, out)
        out.append(data)
    elif isinstance(obj, (list, tuple)):
        _header(len(obj), 0x90, 16, None, 0xDC, 0xDD, out)
        for x in obj:
            _pack(x, out)
    elif isinstance(obj, dict):
        _header(len(obj), 0x80, 16, None, 0xDE, 0xDF, out)
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    else:
        raise TypeError(f"can not serialize {type(obj).__name__!r} object")


def packb(obj) -> bytes:
    """``obj`` as msgpack bytes, as ``msgpack.packb(obj)`` gives them."""
    out: list = []
    _pack(obj, out)
    return b"".join(out)


# fixed-width items: code -> (struct format, size)
_FIXED = {0xCA: (">f", 4), 0xCB: (">d", 8),
          0xCC: (">B", 1), 0xCD: (">H", 2), 0xCE: (">I", 4), 0xCF: (">Q", 8),
          0xD0: (">b", 1), 0xD1: (">h", 2), 0xD2: (">i", 4), 0xD3: (">q", 8)}
# length-prefixed items: code -> (kind, struct format of the length)
_SIZED = {0xC4: ("bin", ">B"), 0xC5: ("bin", ">H"), 0xC6: ("bin", ">I"),
          0xD9: ("str", ">B"), 0xDA: ("str", ">H"), 0xDB: ("str", ">I"),
          0xDC: ("array", ">H"), 0xDD: ("array", ">I"),
          0xDE: ("map", ">H"), 0xDF: ("map", ">I")}


def _unpack(data: bytes, i: int):
    """(value, next offset) of the item at ``data[i]``."""
    if i >= len(data):
        raise ValueError("msgpack data ends inside an item")
    c = data[i]
    i += 1
    if c <= 0x7F:
        return c, i
    if c >= 0xE0:
        return c - 0x100, i
    if 0x80 <= c <= 0x8F:
        kind, n = "map", c & 0x0F
    elif 0x90 <= c <= 0x9F:
        kind, n = "array", c & 0x0F
    elif 0xA0 <= c <= 0xBF:
        kind, n = "str", c & 0x1F
    elif c == 0xC0:
        return None, i
    elif c == 0xC2:
        return False, i
    elif c == 0xC3:
        return True, i
    elif c in _FIXED:
        fmt, size = _FIXED[c]
        if i + size > len(data):
            raise ValueError("msgpack data ends inside an item")
        return struct.unpack_from(fmt, data, i)[0], i + size
    elif c in _SIZED:
        kind, fmt = _SIZED[c]
        size = struct.calcsize(fmt)
        if i + size > len(data):
            raise ValueError("msgpack data ends inside an item")
        n = struct.unpack_from(fmt, data, i)[0]
        i += size
    else:
        raise ValueError(f"msgpack type 0x{c:02x} is not in the subset "
                         "3FS stores")
    if kind in ("str", "bin"):
        if i + n > len(data):
            raise ValueError("msgpack data ends inside an item")
        raw = bytes(data[i:i + n])
        return (raw.decode("utf-8") if kind == "str" else raw), i + n
    if kind == "array":
        out = []
        for _ in range(n):
            x, i = _unpack(data, i)
            out.append(x)
        return out, i
    d = {}
    for _ in range(n):
        k, i = _unpack(data, i)
        v, i = _unpack(data, i)
        d[k] = v
    return d, i


def unpackb(data: bytes):
    """The object of msgpack ``data``, as ``msgpack.unpackb(data,
    strict_map_key=False)`` reads it."""
    obj, end = _unpack(data, 0)
    if end != len(data):
        raise ValueError(f"{len(data) - end} bytes after the msgpack object")
    return obj
