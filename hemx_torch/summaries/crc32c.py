"""CRC-32C (Castagnoli) with TFRecord masking (counterpart of
``hemx.summaries.crc32c``).

A CRC from zero goes through the C++ slicing-by-8 loop of
``hemx_torch.native``, built at first use; a running ``crc`` goes through
the plain table loop, :func:`_py_crc32c`, which is also the plain version
that the tests and ``chip_smoke.py`` hold the C++ one against. The plain
loop takes one interpreted iteration per byte, some hundreds of times the
C++ loop's time; ``chip_smoke.py`` phases 6 and 20 print both in seconds
per MiB on the GPU machine's host, and PERF.md keeps the figures.
``zlib.crc32`` is CRC-32 with another polynomial, so it cannot stand in.
"""

from __future__ import annotations

from hemx_torch import native

_POLY = 0x82F63B78
_TABLE = []
for _i in range(256):
    _c = _i
    for _ in range(8):
        _c = (_c >> 1) ^ _POLY if _c & 1 else _c >> 1
    _TABLE.append(_c)


def _py_crc32c(data: bytes, crc: int = 0) -> int:
    table = _TABLE
    crc ^= 0xFFFFFFFF
    for b in data:
        crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def crc32c(data: bytes, crc: int = 0) -> int:
    if crc == 0:
        return native.load().crc32c(data)
    return _py_crc32c(data, crc)


def masked_crc32c(data: bytes) -> int:
    """TFRecord-masked crc: rotate right 15 and add magic."""
    crc = crc32c(data)
    return ((crc >> 15) | (crc << 17)) + 0xA282EAD8 & 0xFFFFFFFF
