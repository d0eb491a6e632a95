"""PNG encoder (zlib + struct) for image summaries (copy of the encoder of
``hemx.summaries.png``). Input: uint8 (H, W), (H, W, 1), (H, W, 3) or
(H, W, 4)."""

from __future__ import annotations

import struct
import zlib

import numpy as np

_COLOR_TYPE = {1: 0, 3: 2, 4: 6}  # channels -> PNG color type


def _chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def encode_png(img: np.ndarray) -> bytes:
    arr = np.asarray(img)
    if arr.dtype != np.uint8:
        raise ValueError("encode_png expects uint8")
    if arr.ndim == 2:
        arr = arr[:, :, None]
    h, w, c = arr.shape
    if c not in _COLOR_TYPE:
        raise ValueError(f"unsupported channel count {c}")
    ihdr = struct.pack(">IIBBBBB", w, h, 8, _COLOR_TYPE[c], 0, 0, 0)
    # filter byte 0 per scanline
    raw = b"".join(b"\x00" + arr[y].tobytes() for y in range(h))
    return (b"\x89PNG\r\n\x1a\n"
            + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(raw, 6))
            + _chunk(b"IEND", b""))
