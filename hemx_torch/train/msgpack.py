"""A msgpack codec for the subset that ``flax.serialization`` writes.

hemx checkpoints are ``flax.serialization.to_bytes`` of a dict pytree: a
msgpack map of string keys whose leaves are arrays. Flax packs an array as
ext type 1 holding ``packb((shape, dtype name, C-order bytes))`` and a numpy
scalar as ext type 3 in the same form. hemx's manager turns every leaf into
an array first, so its files hold only ext type 1 (``step``, Adam's
``count`` and ``epoch`` are 0-d arrays); both types are read. Map keys are
written sorted, as flax's pass through ``tree_map`` leaves them, so the
same tree gives the same bytes as flax. This module reads and writes that,
so the port needs neither ``msgpack`` nor ``flax``.

Flax splits an array of more than 2**30 bytes into a
``__msgpack_chunked_array__`` dict; that form never occurs at the sizes this
port trains, and both directions refuse it with an error that names it.
"""

from __future__ import annotations

import struct

import numpy as np

EXT_NDARRAY = 1
EXT_NPSCALAR = 3
MAX_CHUNK_SIZE = 2 ** 30  # flax.serialization.MAX_CHUNK_SIZE
_CHUNKED = "__msgpack_chunked_array__"


# -- encoding -----------------------------------------------------------------

def packb(obj) -> bytes:
    """Pack nested dicts (string keys) and lists of arrays, numpy scalars,
    ints, strings and bytes, as flax does."""
    out = bytearray()
    _pack(obj, out)
    return bytes(out)


def _pack_ext(code: int, data: bytes, out: bytearray) -> None:
    n = len(data)
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if n in fixed:
        out.append(fixed[n])
    elif n < 2 ** 8:
        out += struct.pack(">BB", 0xC7, n)
    elif n < 2 ** 16:
        out += struct.pack(">BH", 0xC8, n)
    else:
        out += struct.pack(">BI", 0xC9, n)
    out += struct.pack(">b", code)
    out += data


def _array_bytes(a: np.ndarray) -> bytes:
    if a.nbytes > MAX_CHUNK_SIZE:
        raise ValueError(
            f"array of {a.nbytes} bytes: flax would write it in its chunked "
            f"form ('{_CHUNKED}'), which this codec does not support")
    if a.dtype.hasobject or a.dtype.names is not None:
        raise ValueError(f"dtype {a.dtype} cannot be serialized")
    return packb([list(a.shape), a.dtype.name,
                  np.ascontiguousarray(a).tobytes()])


def _pack(obj, out: bytearray) -> None:
    if isinstance(obj, np.ndarray):
        _pack_ext(EXT_NDARRAY, _array_bytes(obj), out)
    elif isinstance(obj, np.generic):
        _pack_ext(EXT_NPSCALAR, _array_bytes(np.asarray(obj)), out)
    elif isinstance(obj, int) and not isinstance(obj, bool):
        _pack_int(obj, out)
    elif isinstance(obj, str):
        b = obj.encode("utf-8")
        n = len(b)
        if n < 32:
            out.append(0xA0 | n)
        elif n < 2 ** 8:
            out += struct.pack(">BB", 0xD9, n)
        elif n < 2 ** 16:
            out += struct.pack(">BH", 0xDA, n)
        else:
            out += struct.pack(">BI", 0xDB, n)
        out += b
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        n = len(obj)
        if n < 2 ** 8:
            out += struct.pack(">BB", 0xC4, n)
        elif n < 2 ** 16:
            out += struct.pack(">BH", 0xC5, n)
        else:
            out += struct.pack(">BI", 0xC6, n)
        out += obj
    elif isinstance(obj, dict):
        n = len(obj)
        if n < 16:
            out.append(0x80 | n)
        elif n < 2 ** 16:
            out += struct.pack(">BH", 0xDE, n)
        else:
            out += struct.pack(">BI", 0xDF, n)
        for k in sorted(obj):  # flax's tree_map pass leaves keys sorted
            _pack(k, out)
            _pack(obj[k], out)
    elif isinstance(obj, (list, tuple)):
        n = len(obj)
        if n < 16:
            out.append(0x90 | n)
        elif n < 2 ** 16:
            out += struct.pack(">BH", 0xDC, n)
        else:
            out += struct.pack(">BI", 0xDD, n)
        for v in obj:
            _pack(v, out)
    else:
        raise TypeError(f"cannot serialize {type(obj).__name__}")


def _pack_int(n: int, out: bytearray) -> None:
    if 0 <= n < 128:
        out.append(n)
    elif -32 <= n < 0:
        out += struct.pack(">b", n)
    elif n >= 0:
        for fmt, code, lim in (("B", 0xCC, 2 ** 8), ("H", 0xCD, 2 ** 16),
                               ("I", 0xCE, 2 ** 32), ("Q", 0xCF, 2 ** 64)):
            if n < lim:
                out += struct.pack(">B" + fmt, code, n)
                return
        raise OverflowError(n)
    else:
        for fmt, code, lim in (("b", 0xD0, 2 ** 7), ("h", 0xD1, 2 ** 15),
                               ("i", 0xD2, 2 ** 31), ("q", 0xD3, 2 ** 63)):
            if n >= -lim:
                out += struct.pack(">B" + fmt, code, n)
                return
        raise OverflowError(n)


# -- decoding -----------------------------------------------------------------

class _Reader:
    def __init__(self, data: bytes):
        self.buf = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise ValueError("truncated msgpack data")
        v = self.buf[self.pos:self.pos + n]
        self.pos += n
        return v

    def unpack(self, fmt: str):
        size = struct.calcsize(fmt)
        return struct.unpack(fmt, self.take(size))[0]


_FIXED_EXT = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
_SIZED = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I",     # bin
          0xD9: ">B", 0xDA: ">H", 0xDB: ">I",     # str
          0xDC: ">H", 0xDD: ">I",                 # array
          0xDE: ">H", 0xDF: ">I",                 # map
          0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}     # ext
_NUMBERS = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I",
            0xCF: ">Q", 0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}


def _read(r: _Reader):
    b = r.take(1)[0]
    if b <= 0x7F:
        return b
    if b >= 0xE0:
        return b - 0x100
    if 0x80 <= b <= 0x8F:
        return _read_map(r, b & 0x0F)
    if 0x90 <= b <= 0x9F:
        return [_read(r) for _ in range(b & 0x0F)]
    if 0xA0 <= b <= 0xBF:
        return str(r.take(b & 0x1F), "utf-8")
    if b == 0xC0:
        return None
    if b in (0xC2, 0xC3):
        return b == 0xC3
    if b in _NUMBERS:
        return r.unpack(_NUMBERS[b])
    if b in _FIXED_EXT:
        code = r.unpack(">b")
        return _ext(code, bytes(r.take(_FIXED_EXT[b])))
    if b in _SIZED:
        n = r.unpack(_SIZED[b])
        if b <= 0xC6:
            return bytes(r.take(n))
        if b <= 0xC9:
            code = r.unpack(">b")
            return _ext(code, bytes(r.take(n)))
        if b <= 0xDB:
            return str(r.take(n), "utf-8")
        if b <= 0xDD:
            return [_read(r) for _ in range(n)]
        return _read_map(r, n)
    raise ValueError(f"unsupported msgpack type byte 0x{b:02x}")


def _read_map(r: _Reader, n: int) -> dict:
    out = {}
    for _ in range(n):
        k = _read(r)
        out[k] = _read(r)
    if _CHUNKED in out:
        raise ValueError(f"flax's chunked array form ('{_CHUNKED}') is not "
                         f"supported by this codec")
    return out


def _array(data: bytes) -> np.ndarray:
    shape, dtype, buf = unpackb(data)
    if dtype == "bfloat16":
        raise ValueError("bfloat16 arrays are not supported (numpy has no "
                         "bfloat16; the port's checkpoints hold none)")
    return np.frombuffer(buf, dtype=np.dtype(dtype)).reshape(shape)


def _ext(code: int, data: bytes):
    if code == EXT_NDARRAY:
        return _array(data)
    if code == EXT_NPSCALAR:
        return _array(data)[()]
    raise ValueError(f"unsupported msgpack ext type {code}")


def unpackb(data: bytes):
    r = _Reader(data)
    obj = _read(r)
    if r.pos != len(r.buf):
        raise ValueError(f"{len(r.buf) - r.pos} bytes of trailing data")
    return obj
