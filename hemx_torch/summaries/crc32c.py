"""CRC-32C (Castagnoli) with TFRecord masking, in pure Python (counterpart
of ``hemx.summaries.crc32c``, whose native path lives in ``hemx.native``).

``zlib.crc32`` is CRC-32 with another polynomial, so it cannot stand in.
The table-driven loop costs about a fifth of a microsecond per byte; the
events writer runs it over each record at summary time, outside the train
call.
"""

from __future__ import annotations

_POLY = 0x82F63B78
_TABLE = []
for _i in range(256):
    _c = _i
    for _ in range(8):
        _c = (_c >> 1) ^ _POLY if _c & 1 else _c >> 1
    _TABLE.append(_c)


def crc32c(data: bytes, crc: int = 0) -> int:
    table = _TABLE
    crc ^= 0xFFFFFFFF
    for b in data:
        crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def masked_crc32c(data: bytes) -> int:
    """TFRecord-masked crc: rotate right 15 and add magic."""
    crc = crc32c(data)
    return ((crc >> 15) | (crc << 17)) + 0xA282EAD8 & 0xFFFFFFFF
