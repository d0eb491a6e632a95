"""TFRecord file IO without TensorFlow (counterpart of
``hemx.data.tfrecord``). Records are framed as

    uint64 length | uint32 masked_crc(length) | bytes data | uint32 masked_crc(data)

CRCs are written correctly; on read they are skipped by default (TF's
default) unless ``verify=True``. :func:`read_all_records` and
:func:`count_records` run the C++ reader of ``hemx_torch.native`` (built
at first use; a failed build raises), as hemx's do; :class:`TFRecordWriter`
and :func:`tfrecord_iterator` stay in Python, the writer with the C++
CRC-32C through ``masked_crc32c``. The plain walks stay beside them as
:func:`tfrecord_iterator` and :func:`_py_count_records`, the versions the
tests hold the C++ ones against. Unverified reads go to C++ as in hemx,
though the Python walk matched them on a CPU (PERF.md).
"""

from __future__ import annotations

import os
import struct
from typing import Iterator

from hemx_torch import native
from hemx_torch.summaries.crc32c import masked_crc32c


class TFRecordWriter:
    def __init__(self, path: str):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._f = open(path, "wb")

    def write(self, record: bytes) -> None:
        header = struct.pack("<Q", len(record))
        self._f.write(header)
        self._f.write(struct.pack("<I", masked_crc32c(header)))
        self._f.write(record)
        self._f.write(struct.pack("<I", masked_crc32c(record)))

    def close(self) -> None:
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _truncated(path: str, length: int) -> IOError:
    # mid-record EOF = a partially written file, not a clean end; silence
    # here would train on a silently shortened dataset
    return IOError(f"truncated tfrecord file {path}: record of {length} "
                   f"bytes cut off at EOF")


def tfrecord_iterator(path: str, verify: bool = False) -> Iterator[bytes]:
    with open(path, "rb") as f:
        while True:
            header = f.read(8)
            if len(header) < 8:
                return
            (length,) = struct.unpack("<Q", header)
            hcrc = f.read(4)
            record = f.read(length)
            dcrc = f.read(4)
            if len(hcrc) < 4 or len(record) < length or len(dcrc) < 4:
                raise _truncated(path, length)
            if verify:
                if struct.unpack("<I", hcrc)[0] != masked_crc32c(header):
                    raise IOError(f"corrupt header crc in {path}")
                if struct.unpack("<I", dcrc)[0] != masked_crc32c(record):
                    raise IOError(f"corrupt record crc in {path}")
            yield record


def read_all_records(path: str, verify: bool = False) -> list[bytes]:
    return native.load().read_all_records(path, verify)


def _py_count_records(path: str) -> int:
    """The records of ``path`` by walking its framing in Python."""
    n = 0
    size = os.path.getsize(path)
    with open(path, "rb") as f:
        while True:
            header = f.read(8)
            if len(header) < 8:
                break
            (length,) = struct.unpack("<Q", header)
            end = f.tell() + length + 8
            if end > size:
                raise _truncated(path, length)
            f.seek(end)
            n += 1
    return n


def count_records(path: str) -> int:
    """Record count by walking the framing in C++; the result is cached
    next to the file as ``<path>.count`` and reused while it is newer than
    the file."""
    cache = path + ".count"
    try:
        if os.path.getmtime(cache) >= os.path.getmtime(path):
            with open(cache) as f:
                return int(f.read().strip())
    except (OSError, ValueError):
        pass
    n = native.load().count_records(path)
    try:
        with open(cache, "w") as f:
            f.write(str(n))
    except OSError:
        pass
    return n
