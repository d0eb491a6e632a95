"""tfevents writer, TensorBoard-compatible, with no TensorFlow (counterpart
of ``hemx.summaries.events``). TFRecord framing (length + masked CRC-32C)
of Event protos; the first record is the file_version event
("brain.Event:2").
"""

from __future__ import annotations

import os
import socket
import struct
import time

import numpy as np

from hemx_torch.parallel import dp
from hemx_torch.summaries import proto
from hemx_torch.summaries.crc32c import masked_crc32c
from hemx_torch.summaries.montage import montage, to_uint8
from hemx_torch.summaries.png import encode_png

# TF's default histogram bucket edges: exponential 1e-12 * 1.1^k, mirrored.
_POS_EDGES: list[float] = []
_v = 1e-12
while _v < 1e20:
    _POS_EDGES.append(_v)
    _v *= 1.1
_EDGES = [-x for x in reversed(_POS_EDGES)] + [0.0] + _POS_EDGES


def _frame(record: bytes) -> bytes:
    header = struct.pack("<Q", len(record))
    return (header + struct.pack("<I", masked_crc32c(header))
            + record + struct.pack("<I", masked_crc32c(record)))


class EventsWriter:
    """Writes one events.out.tfevents.* file in ``logdir``."""

    def __init__(self, logdir: str, filename_suffix: str = ""):
        os.makedirs(logdir, exist_ok=True)
        fname = "events.out.tfevents.{:d}.{}{}".format(
            int(time.time()), socket.gethostname(), filename_suffix)
        self.path = os.path.join(logdir, fname)
        self._f = open(self.path, "ab")
        self._write_event(proto.event(time.time(), file_version="brain.Event:2"))

    def _write_event(self, event_bytes: bytes) -> None:
        self._f.write(_frame(event_bytes))

    def write_summary(self, values: list[bytes], step: int) -> None:
        self._write_event(proto.event(time.time(), step,
                                      summary_bytes=proto.summary(values)))
        self.flush()

    def scalar(self, tag: str, value: float, step: int) -> None:
        self.write_summary([proto.summary_value_scalar(tag, value)], step)

    def scalars(self, values: dict, step: int) -> None:
        vs = [proto.summary_value_scalar(t, v) for t, v in values.items()]
        if vs:
            self.write_summary(vs, step)

    def histogram(self, tag: str, values, step: int) -> None:
        self.write_summary([histogram_value(tag, values)], step)

    def image(self, tag: str, img: np.ndarray, step: int) -> None:
        """img: float [0,1] (H, W, C) or uint8."""
        self.write_summary([image_value(tag, img)], step)

    def montage(self, tag: str, images: np.ndarray, step: int,
                grid=None) -> None:
        """Stitch (N,H,W,C) examples into a grid image summary."""
        self.image(tag, montage(np.asarray(images), grid), step)

    def moments(self, tag: str, batch: np.ndarray, step: int) -> None:
        """Batch mean and variance scalars, and for (N, H, W, C) batches the
        channel-mean variance map colorized (reference:
        hem/ops/summaries.py:87-95 summarize_moments)."""
        from hemx_torch.ops.images import colorize

        arr = np.asarray(batch, np.float32)
        mean = arr.mean(axis=0)
        var = arr.var(axis=0)
        self.scalar(f"{tag}/mean", float(mean.mean()), step)
        self.scalar(f"{tag}/variance", float(var.mean()), step)
        if var.ndim == 3:
            v = var.mean(axis=-1, keepdims=True)
            self.image(f"{tag}/variance_image", colorize(v), step)

    def flush(self) -> None:
        self._f.flush()

    def close(self) -> None:
        self._f.close()


def histogram_value(tag: str, values) -> bytes:
    arr = np.asarray(values, np.float64).ravel()
    arr = arr[np.isfinite(arr)]
    if arr.size == 0:
        # every value non-finite: an empty histogram (num=0), never a
        # made-up healthy one
        return proto.summary_value_histo(
            tag, hmin=0.0, hmax=0.0, num=0.0, hsum=0.0, sum_squares=0.0,
            bucket_limits=[], buckets=[])
    counts, _ = np.histogram(arr, bins=[-np.inf] + _EDGES + [np.inf])
    nz = np.nonzero(counts)[0]
    if nz.size:
        lo, hi = nz[0], nz[-1]
    else:
        lo, hi = 0, 0
    limits, buckets = [], []
    edges_ext = _EDGES + [1.7976931348623157e308]
    for i in range(lo, hi + 1):
        limits.append(edges_ext[min(i, len(edges_ext) - 1)])
        buckets.append(float(counts[i]))
    return proto.summary_value_histo(
        tag,
        hmin=float(arr.min()), hmax=float(arr.max()), num=float(arr.size),
        hsum=float(arr.sum()), sum_squares=float((arr ** 2).sum()),
        bucket_limits=limits, buckets=buckets)


def image_value(tag: str, img: np.ndarray) -> bytes:
    arr = np.asarray(img)
    if arr.dtype != np.uint8:
        arr = to_uint8(arr)
    if arr.ndim == 2:
        arr = arr[:, :, None]
    png = encode_png(arr)
    return proto.summary_value_image(tag, png, arr.shape[0], arr.shape[1],
                                     colorspace=arr.shape[2])


class _NullWriter:
    """An EventsWriter that writes nothing (ranks other than 0)."""

    def __getattr__(self, name):
        return lambda *args, **kwargs: None


class SummaryWriterSet:
    """train/validate/test writer triple (reference: hem/util/misc.py:115-125).
    In a process group only rank 0 writes; the others hold writers that
    write nothing."""

    PHASES = ("train", "validate", "test")

    def __init__(self, workspace_dir: str):
        make = (EventsWriter if dp.is_primary()
                else lambda _: _NullWriter())
        self.writers = {p: make(os.path.join(workspace_dir, p))
                        for p in self.PHASES}

    def __getitem__(self, phase: str) -> EventsWriter:
        return self.writers[phase]

    def close(self) -> None:
        for w in self.writers.values():
            w.close()
