"""Sources, splits, the device-resident cache and the streaming feeder
(counterpart of ``hemx.data.pipeline``).

The host half is a numpy copy of ``hemx``'s: ``ArraySource``,
``TFRecordSource`` (records parsed, filtered and stacked once, raw bytes
freed), ``Split`` with the ``SeedSequence([seed, epoch])`` shuffle and the
per-batch ``SeedSequence([seed, epoch, b])`` rng of a host
``batch_transform``, and the ``--grayscale`` / ``--resize`` conversions,
pinned equal to the originals by ``tests/test_torch_data.py`` and
``tests/test_torch_datasets.py``. ``hemx``'s device transform is a JAX
callable; here it is the declarative :class:`U8Normalize`, which both
feeders run as launches of the fused gather+normalize kernel.

Two feeders, as in ``hemx``, yield the same batches bit for bit:

* :class:`DeviceDataPipeline` places the whole compact dataset on the
  device once and gathers each batch group there (no per-step H2D);
* :class:`Pipeline` streams host batches (datasets over
  ``--device_cache_mb``, splits with a host ``batch_transform``, or
  ``--no-device_data_cache``): a worker thread assembles ``group``
  batches into one contiguous host array, and the consumer ships it as one
  pinned H2D copy and normalizes it with the same kernel.

Batches are dicts of device tensors: a ``U8Normalize`` key as (B, C, H, W)
float32 in channels_last memory, any other 4-D key permuted to (B, C, H, W)
the same way, other keys as they are.

In a process group both feeders walk hemx's order of global batches
(``global_batch`` rows each) and a rank of data index d takes rows
``[d*B : (d+1)*B]`` of each, B = global_batch / ``dp.data_axis_size()``, as hemx
shards a batch over its ``data`` axis: the cache gathers only those rows
(every rank holds the whole dataset), the streaming feeder ships
``dp.host_slice`` of each host batch. With ``bands`` (a model that runs on
bands, under ``--spatial_parallel``) each rank also keeps only its height
band of every leaf hemx bands (``dp.band_rows``): the cache reads only the
band's bytes (``gather_u8_normalize``'s ``rows``, or an ``index_select``
of the band's view), the streaming feeder cuts the band on the host, so
only its bytes cross to the device.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
import time
from typing import Callable, Iterator, Optional

import numpy as np
import torch

from hemx_torch.data.tfrecord import read_all_records
from hemx_torch.ops.input_kernels import gather_u8_normalize
from hemx_torch.parallel import dp
from hemx_torch.utils import tracing


class ArraySource:
    """In-memory source: dict of equal-length numpy arrays."""

    def __init__(self, arrays: dict[str, np.ndarray]):
        self.arrays = arrays
        lengths = {len(v) for v in arrays.values()}
        if len(lengths) != 1:
            raise ValueError("all arrays must share leading dim")
        self._n = lengths.pop()

    def __len__(self) -> int:
        return self._n

    def batch(self, idx: np.ndarray) -> dict[str, np.ndarray]:
        return {k: v[idx] for k, v in self.arrays.items()}


class TFRecordSource:
    """TFRecord-backed source: every record is parsed (``parse``: record
    bytes -> dict of numpy arrays, one sample), filtered by
    ``sample_filter`` and stacked once, on first use (under a lock: a
    streaming worker may be the first to ask); ``materialize_s`` holds the
    seconds that took (read, decode, stack)."""

    def __init__(self, paths: list[str], parse: Callable[[bytes], dict],
                 sample_filter: Optional[Callable[[dict], bool]] = None):
        self.paths = paths
        self.parse = parse
        self._filter = sample_filter
        self._records: Optional[list[bytes]] = None
        self._materialized: Optional[ArraySource] = None
        self._lock = threading.Lock()
        self.materialize_s: Optional[float] = None

    def _load_records(self) -> list[bytes]:
        if self._records is None:
            recs: list[bytes] = []
            for p in self.paths:
                recs.extend(read_all_records(p))
            self._records = recs
        return self._records

    def _materialize(self) -> ArraySource:
        with self._lock:
            if self._materialized is None:
                self._build()
        return self._materialized

    def _build(self) -> None:
        t0 = time.perf_counter()
        samples = [self.parse(r) for r in self._load_records()]
        if self._filter is not None:
            samples = [s for s in samples if self._filter(s)]
        if not samples:
            raise ValueError(f"no records in {self.paths}")
        arrays = {k: np.stack([s[k] for s in samples]) for k in samples[0]}
        self._materialized = ArraySource(arrays)
        self._records = None  # free raw bytes
        self.materialize_s = time.perf_counter() - t0

    def __len__(self) -> int:
        return len(self._materialize())

    def batch(self, idx: np.ndarray) -> dict[str, np.ndarray]:
        return self._materialize().batch(idx)


@dataclasses.dataclass(frozen=True)
class U8Normalize:
    """Device transform: uint8 arrays under ``keys`` -> float32 in
    ``[lo, hi]`` (``hemx.data.pipeline.u8_image_device_transform``)."""
    keys: tuple = ("image",)
    lo: float = 0.0
    hi: float = 1.0


class Split:
    """One dataset split. Batch count per epoch = floor(count / batch).

    ``batch_transform`` runs on each host batch (``(batch, rng)`` when
    ``transform_needs_rng``: per-draw augmentation such as NYUv2's random
    crops); ``device_transform`` after placement.
    """

    def __init__(self, source, *, batch_transform: Optional[Callable] = None,
                 name: str = "train", transform_needs_rng: bool = False,
                 device_transform: Optional[U8Normalize] = None):
        self.source = source
        self.batch_transform = batch_transform
        self.name = name
        self.transform_needs_rng = transform_needs_rng
        self.device_transform = device_transform
        self._device_pipelines = {}  # DeviceDataPipeline.maybe's memo

    def release_device_pipelines(self) -> None:
        """Forget the device pipelines memoized on this split, so their
        device copies are freed once nothing else holds them."""
        self._device_pipelines = {}

    @property
    def count(self) -> int:
        return len(self.source)

    def batches_per_epoch(self, global_batch: int) -> int:
        return self.count // global_batch

    def iter_epoch_indices(self, global_batch: int, *, shuffle: bool = True,
                           seed: int = 0,
                           epoch: int = 0) -> Iterator[np.ndarray]:
        """The epoch's batch index slices, in ``hemx``'s seeded order."""
        n = self.count
        nb = n // global_batch
        if shuffle:
            rng = np.random.default_rng(np.random.SeedSequence([seed, epoch]))
            order = rng.permutation(n)
        else:
            order = np.arange(n)
        for b in range(nb):
            yield order[b * global_batch:(b + 1) * global_batch]

    def iter_epoch(self, global_batch: int, *, shuffle: bool = True,
                   seed: int = 0, epoch: int = 0) -> Iterator[dict]:
        """The epoch's host batches, after the host ``batch_transform``."""
        for b, idx in enumerate(self.iter_epoch_indices(
                global_batch, shuffle=shuffle, seed=seed, epoch=epoch)):
            batch = self.source.batch(idx)
            if self.batch_transform is not None:
                if self.transform_needs_rng:
                    brng = np.random.default_rng(
                        np.random.SeedSequence([seed, epoch, b]))
                    batch = self.batch_transform(batch, brng)
                else:
                    batch = self.batch_transform(batch)
            yield batch


def _source_arrays(split: Split) -> dict:
    src = split.source
    if isinstance(src, ArraySource):
        return src.arrays
    if isinstance(src, TFRecordSource):
        return src._materialize().arrays
    raise TypeError(f"no in-memory arrays for {type(src).__name__}")


def to_grayscale(split: Split, key: str = "image") -> Split:
    """``--grayscale``: RGB images -> single-channel luma (BT.601 weights
    0.2989/0.5870/0.1140; uint8 stays uint8, rounded), converted once on
    the materialized arrays; non-RGB leaves pass through. Memoized per
    original source, so aliased splits (cifar's validate and test) share
    one converted copy."""
    memo = getattr(split.source, "_grayscale_source", None)
    if memo is not None and key in memo:
        split.source = memo[key]
        return split
    try:
        arrays = _source_arrays(split)
    except TypeError:
        raise ValueError(
            f"--grayscale: split '{split.name}' has no in-memory image "
            f"arrays to convert") from None
    img = arrays.get(key)
    if img is None or img.ndim != 4 or img.shape[-1] != 3:
        return split
    w = np.array([0.2989, 0.5870, 0.1140], np.float32)
    luma = img.astype(np.float32) @ w
    if img.dtype == np.uint8:
        luma = np.round(luma).astype(np.uint8)
    else:
        luma = luma.astype(img.dtype)
    converted = ArraySource({**arrays, key: luma[..., None]})
    if memo is None:
        memo = split.source._grayscale_source = {}
    memo[key] = converted
    split.source = converted
    return split


def _tf1_bilinear(img: np.ndarray, h: int, w: int) -> np.ndarray:
    """TF1 ``tf.image.resize_images`` bilinear (align_corners=False): src
    coordinate = dst index * (in/out), no half-pixel offset, edge clamp."""
    n, ih, iw, c = img.shape
    ys = np.arange(h, dtype=np.float64) * (ih / h)
    xs = np.arange(w, dtype=np.float64) * (iw / w)
    y0 = np.floor(ys).astype(np.int64)
    x0 = np.floor(xs).astype(np.int64)
    y1 = np.minimum(y0 + 1, ih - 1)
    x1 = np.minimum(x0 + 1, iw - 1)
    wy = (ys - y0).astype(np.float32)[None, :, None, None]
    wx = (xs - x0).astype(np.float32)[None, None, :, None]
    f = img.astype(np.float32)
    r0 = f[:, y0]
    r1 = f[:, y1]
    top = r0[:, :, x0] * (1 - wx) + r0[:, :, x1] * wx
    bot = r1[:, :, x0] * (1 - wx) + r1[:, :, x1] * wx
    return top * (1 - wy) + bot * wy


def resize_images(split: Split, size, key: str = "image") -> Split:
    """``--resize H W`` for any dataset: TF1 bilinear on the materialized
    arrays, once (uint8 stays uint8, rounded), memoized per original source
    like :func:`to_grayscale`; a split already at the size is left as it
    is."""
    h, w = int(size[0]), int(size[1])
    memo = getattr(split.source, "_resize_source", None)
    if memo is not None and (key, h, w) in memo:
        split.source = memo[(key, h, w)]
        return split
    try:
        arrays = _source_arrays(split)
    except TypeError:
        raise ValueError(
            f"--resize: split '{split.name}' has no in-memory image "
            f"arrays to convert") from None
    img = arrays.get(key)
    if img is None or img.ndim != 4:
        return split
    if img.shape[1:3] == (h, w):  # already at target (e.g. the nyuv2
        return split              # plugin consumed --resize in its parse)
    out = _tf1_bilinear(img, h, w)
    if img.dtype == np.uint8:
        out = np.round(np.clip(out, 0, 255)).astype(np.uint8)
    else:
        out = out.astype(img.dtype)
    converted = ArraySource({**arrays, key: out})
    if memo is None:
        memo = split.source._resize_source = {}
    memo[(key, h, w)] = converted
    split.source = converted
    return split


def place_rows(group: dict, transform: Optional[U8Normalize]) -> dict:
    """Device arrays (rows first, NHWC for images) -> model inputs: each
    ``transform`` key through ``gather_u8_normalize`` with the identity
    index (one launch per key), other 4-D keys permuted to (R, C, H, W),
    the rest as they are."""
    out = {}
    for k, v in group.items():
        if transform is not None and k in transform.keys:
            ident = torch.arange(v.shape[0], dtype=torch.int32,
                                 device=v.device)
            out[k] = gather_u8_normalize(v, ident, transform.lo, transform.hi)
        else:
            out[k] = v.permute(0, 3, 1, 2) if v.dim() == 4 else v
    return out


def place_batch(batch: dict, split: Split, device, keys=None) -> dict:
    """One host batch of ``split`` (keys filtered by ``keys``) placed on
    ``device`` as :func:`place_rows` gives it: the summary batch and the
    streamed evaluation batches."""
    device = torch.device(device)
    host = {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in batch.items() if not keys or k in keys}
    return place_rows(host, split.device_transform)


class DeviceDataPipeline:
    """The whole compact dataset lives on the device; batches are built
    there.

    The arrays are copied to ``device`` once, memoized on the split's
    SOURCE (mnist and cifar alias one source for validate and test, which
    must go to the card once). Each batch group (``group`` consecutive
    batches, one train call's worth) is one flat index gather: uint8 keys
    named by the split's :class:`U8Normalize` go through
    ``gather_u8_normalize`` (one kernel launch per key and group; a CUDA
    kernel on the GPU, its plain version on the CPU), other keys through
    ``index_select``. The group result is split into batches with
    ``torch.split`` (views). The epoch tail that does not fill a group
    takes the per-batch path. Batches and order equal ``hemx``'s
    DeviceDataPipeline (this rank's rows of them in a process group).
    """

    def __init__(self, split: Split, global_batch: int, *, device,
                 keys=None, shuffle: bool = True, seed: int = 0,
                 group: int = 1, bands: bool = False):
        self.split = split
        self.global_batch = global_batch
        self.shuffle = shuffle
        self.seed = seed
        self.group = max(int(group), 1)
        self.device = torch.device(device)
        self.batch = global_batch // dp.data_axis_size()
        self.bands = bands
        use = {k: v for k, v in _source_arrays(split).items()
               if not keys or k in keys}
        memo = getattr(split.source, "_device_arrays", None)
        if memo is None:
            memo = split.source._device_arrays = {}
        cache_key = (tuple(sorted(use)), str(self.device))
        if cache_key not in memo:
            memo[cache_key] = {
                k: torch.from_numpy(np.ascontiguousarray(v)).to(self.device)
                for k, v in use.items()}
        self.ds = memo[cache_key]
        self.transform = split.device_transform

    @classmethod
    def maybe(cls, split: Split, global_batch: int, *, device, keys=None,
              shuffle: bool = True, seed: int = 0, budget_mb: int = 1024,
              group: int = 1, bands: bool = False):
        """The pipeline if the split qualifies (in-memory arrays, no host
        ``batch_transform``, within ``budget_mb``), else None (the caller
        streams). Memoized on the split, so per-epoch validation reuses
        one instance."""
        if split.batch_transform is not None:
            return None
        memo_key = (global_batch, tuple(sorted(keys or ())), shuffle, seed,
                    str(torch.device(device)), max(int(group), 1), bands)
        memo = split._device_pipelines
        if memo_key in memo:
            return memo[memo_key]
        try:
            arrays = _source_arrays(split)
        except TypeError:
            return None
        use = [v for k, v in arrays.items() if not keys or k in keys]
        if not use or sum(v.nbytes for v in use) > budget_mb * 1024 * 1024:
            return None
        memo[memo_key] = cls(split, global_batch, device=device, keys=keys,
                             shuffle=shuffle, seed=seed, group=group,
                             bands=bands)
        return memo[memo_key]

    def _gather(self, key: str, idx: torch.Tensor) -> torch.Tensor:
        v = self.ds[key]
        t = self.transform
        rows = dp.band_rows(v.shape[1], self.bands) if v.dim() >= 3 else None
        if t is not None and key in t.keys:  # raises unless v is uint8
            return gather_u8_normalize(v, idx, t.lo, t.hi, rows)
        if rows is not None:
            v = v[:, rows[0]:rows[1]]
        out = v.index_select(0, idx)
        return out.permute(0, 3, 1, 2) if out.dim() == 4 else out

    @tracing.spanned("input.assemble")
    def _assemble(self, idx: np.ndarray, parts: int) -> list[dict]:
        i = torch.from_numpy(np.asarray(idx, np.int32)).to(self.device)
        gathered = {k: self._gather(k, i) for k in self.ds}
        split = {k: torch.split(v, self.batch)
                 for k, v in gathered.items()}
        return [{k: split[k][p] for k in split} for p in range(parts)]

    def epoch(self, epoch: int) -> Iterator[dict]:
        """Device batches for one epoch, in ``Split.iter_epoch_indices``
        order."""
        pending: list[np.ndarray] = []
        with tracing.span("input.order"):
            order = list(self.split.iter_epoch_indices(
                self.global_batch, shuffle=self.shuffle, seed=self.seed,
                epoch=epoch))
        for idx in order:
            pending.append(dp.host_slice(idx))
            if len(pending) == self.group:
                flat = np.concatenate(pending)
                pending = []
                yield from self._assemble(flat, self.group)
        for idx in pending:
            yield from self._assemble(idx, 1)


class _Staging:
    """One pinned host buffer per key, reused group after group, and the
    events around the H2D copies that last read it."""

    def __init__(self):
        self.buffers: dict[str, torch.Tensor] = {}
        self.start = torch.cuda.Event(enable_timing=True)
        self.end = torch.cuda.Event(enable_timing=True)
        self.nbytes = 0
        self.in_flight = False

    def view(self, key: str, arr: np.ndarray) -> torch.Tensor:
        """A pinned tensor of ``arr``'s dtype and shape over this slot's
        buffer for ``key`` (grown when too small)."""
        buf = self.buffers.get(key)
        if buf is None or buf.numel() < arr.nbytes:
            buf = self.buffers[key] = torch.empty(
                arr.nbytes, dtype=torch.uint8, pin_memory=True)
        dtype = torch.from_numpy(arr[:0]).dtype
        return buf[:arr.nbytes].view(dtype).view(arr.shape)


class Pipeline:
    """Streaming feeder: host batches over the host->device link
    (``hemx.data.pipeline.Pipeline`` with ``make_group_place_stages``).

    A worker thread assembles the epoch's host batches with
    ``Split.iter_epoch`` (the host ``batch_transform`` and its per-batch
    rng included), keeps the ``keys`` the model reads, and stacks ``group``
    consecutive batches into one contiguous array per key (the epoch tail
    may be shorter); a queue of ``depth`` groups holds it ahead of the
    consumer. The worker touches no CUDA state: on the consumer's thread
    each group is copied into a pinned buffer and sent as one
    ``non_blocking`` H2D copy per key on the current stream, then placed by
    :func:`place_rows` (one kernel launch per ``U8Normalize`` key and
    group) and split into batches with ``torch.split``. Two staging slots
    alternate, and a slot is refilled only after the event recorded behind
    its last copy has completed, so a copy in flight never reads a buffer
    being overwritten. On the CPU nothing is pinned and the kernel's plain
    version runs. An exception in the worker is raised on the consumer
    side.

    The batches equal :class:`DeviceDataPipeline`'s for the same split,
    seed and epoch, bit for bit, grouped or not, tail included.
    ``h2d_bytes`` and ``h2d_s`` add up the copies' bytes and CUDA-event
    seconds (on the card; read them after :meth:`drain`), ``stage_s`` the
    host seconds of filling the pinned buffers.
    """

    def __init__(self, split: Split, global_batch: int, *, device,
                 keys=None, shuffle: bool = True, seed: int = 0,
                 depth: int = 2, group: int = 1, bands: bool = False):
        self.split = split
        self.global_batch = global_batch
        self.keys = keys
        self.shuffle = shuffle
        self.seed = seed
        self.depth = depth
        self.group = max(int(group), 1)
        self.device = torch.device(device)
        self.batch = global_batch // dp.data_axis_size()
        self.bands = bands
        self.h2d_bytes = 0
        self.h2d_s = 0.0
        self.stage_s = 0.0
        self._slots = ([_Staging(), _Staging()]
                       if self.device.type == "cuda" else [])
        self._next_slot = 0

    def _host_groups(self, epoch: int) -> Iterator[dict]:
        pending: list[dict] = []
        for batch in self.split.iter_epoch(
                self.global_batch, shuffle=self.shuffle, seed=self.seed,
                epoch=epoch):
            pending.append(dp.host_slice(
                {k: v for k, v in batch.items()
                 if not self.keys or k in self.keys}, bands=self.bands))
            if len(pending) == self.group:
                yield _stack(pending)
                pending = []
        if pending:
            yield _stack(pending)

    def _settle(self, slot: _Staging) -> None:
        """Wait for the slot's last copies to land and count them."""
        if slot.in_flight:
            slot.end.synchronize()
            self.h2d_s += slot.start.elapsed_time(slot.end) / 1e3
            self.h2d_bytes += slot.nbytes
            slot.in_flight = False

    def drain(self) -> None:
        """Wait for every copy in flight (the H2D totals are then
        complete)."""
        for slot in self._slots:
            self._settle(slot)

    def _to_device(self, host: dict) -> dict:
        if self.device.type != "cuda":
            return {k: torch.from_numpy(v) for k, v in host.items()}
        slot = self._slots[self._next_slot]
        self._next_slot = (self._next_slot + 1) % len(self._slots)
        self._settle(slot)  # never refill a buffer a copy may still read
        t0 = time.perf_counter()
        pinned = {}
        for k, v in host.items():
            pinned[k] = slot.view(k, v)
            pinned[k].copy_(torch.from_numpy(v))
        self.stage_s += time.perf_counter() - t0
        slot.start.record()
        out = {k: p.to(self.device, non_blocking=True)
               for k, p in pinned.items()}
        slot.end.record()
        slot.nbytes = sum(v.nbytes for v in host.values())
        slot.in_flight = True
        return out

    def _place(self, host: dict) -> list[dict]:
        rows = len(next(iter(host.values())))
        placed = place_rows(self._to_device(host), self.split.device_transform)
        parts = {k: torch.split(v, self.batch) for k, v in placed.items()}
        return [{k: parts[k][p] for k in parts}
                for p in range(rows // self.batch)]

    def epoch(self, epoch: int) -> Iterator[dict]:
        """Device batches for one epoch, in ``Split.iter_epoch`` order."""
        q: queue.Queue = queue.Queue(maxsize=self.depth)
        stop = threading.Event()
        done = object()
        err: list[Exception] = []

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.05)
                    return True
                except queue.Full:
                    pass
            return False

        def worker():
            try:
                for host in self._host_groups(epoch):
                    if not put(host):
                        return
            except Exception as e:  # raised on the consumer side
                err.append(e)
            finally:
                put(done)

        t = threading.Thread(target=worker, daemon=True,
                             name=f"hemx_torch-pipeline-{self.split.name}")
        t.start()
        try:
            while True:
                with tracing.span("input.wait"):
                    item = q.get()
                if item is done:
                    break
                yield from self._place(item)
        finally:
            # also when the consumer stops early: release the worker
            stop.set()
            t.join()
        if err:
            raise err[0]


def _stack(batches: list[dict]) -> dict:
    """``len(batches)`` host batches as one contiguous array per key."""
    return {k: np.concatenate([b[k] for b in batches]) for k in batches[0]}
