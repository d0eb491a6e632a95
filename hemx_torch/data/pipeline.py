"""Sources, splits and the device-resident pipeline (counterpart of
``hemx.data.pipeline``).

``ArraySource`` and ``Split.iter_epoch_indices`` are numpy copies of
``hemx``'s (the same ``SeedSequence([seed, epoch])`` shuffle), pinned equal
to the originals by ``tests/test_torch_data.py``. ``hemx``'s device
transform is a JAX callable; here it is the declarative
:class:`U8Normalize`, which :class:`DeviceDataPipeline` compiles into one
launch of the fused gather+normalize kernel per batch group.

The streaming ``Pipeline`` (host batches over the host->device link) is not
ported: a split that does not fit ``--device_cache_mb`` is refused.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Optional

import numpy as np
import torch

from hemx_torch.ops.input_kernels import gather_u8_normalize


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


@dataclasses.dataclass(frozen=True)
class U8Normalize:
    """Device transform: uint8 arrays under ``keys`` -> float32 in
    ``[lo, hi]`` (``hemx.data.pipeline.u8_image_device_transform``)."""
    keys: tuple = ("image",)
    lo: float = 0.0
    hi: float = 1.0


class Split:
    """One dataset split. Batch count per epoch = floor(count / batch)."""

    def __init__(self, source, *,
                 device_transform: Optional[U8Normalize] = None):
        self.source = source
        self.device_transform = device_transform

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


class DeviceDataPipeline:
    """The whole compact dataset lives on the device; batches are built
    there.

    The arrays are copied to ``device`` once. Each batch group (``group``
    consecutive batches, one train call's worth) is one flat index gather:
    uint8 keys named by the split's :class:`U8Normalize` go through
    ``gather_u8_normalize`` (one kernel launch per key and group; a CUDA
    kernel on the GPU, its plain version on the CPU), other keys through
    ``index_select``. The group result is split into batches with
    ``torch.split`` (views). The epoch tail that does not fill a group
    takes the per-batch path. Images come out as (B, C, H, W),
    channels_last. Batches and order equal ``hemx``'s DeviceDataPipeline.
    """

    def __init__(self, split: Split, global_batch: int, *, device,
                 keys=None, shuffle: bool = True, seed: int = 0,
                 group: int = 1):
        self.split = split
        self.global_batch = global_batch
        self.shuffle = shuffle
        self.seed = seed
        self.group = max(int(group), 1)
        self.device = torch.device(device)
        arrays = split.source.arrays
        self.ds = {k: torch.from_numpy(np.ascontiguousarray(v)).to(self.device)
                   for k, v in arrays.items() if not keys or k in keys}
        self.transform = split.device_transform

    @classmethod
    def maybe(cls, split: Split, global_batch: int, *, device, keys=None,
              shuffle: bool = True, seed: int = 0, budget_mb: int = 1024,
              group: int = 1):
        """The pipeline if the split's arrays fit ``budget_mb``, else None."""
        use = [v for k, v in split.source.arrays.items()
               if not keys or k in keys]
        if not use or sum(v.nbytes for v in use) > budget_mb * 1024 * 1024:
            return None
        return cls(split, global_batch, device=device, keys=keys,
                   shuffle=shuffle, seed=seed, group=group)

    def _gather(self, key: str, idx: torch.Tensor) -> torch.Tensor:
        v = self.ds[key]
        t = self.transform
        if t is not None and key in t.keys:  # raises unless v is uint8
            return gather_u8_normalize(v, idx, t.lo, t.hi)
        out = v.index_select(0, idx)
        return out.permute(0, 3, 1, 2) if out.dim() == 4 else out

    def batch(self, idx: np.ndarray) -> dict:
        """One device batch of the dataset rows ``idx``."""
        return self._assemble(idx, 1)[0]

    def _assemble(self, idx: np.ndarray, parts: int) -> list[dict]:
        i = torch.from_numpy(np.asarray(idx, np.int32)).to(self.device)
        gathered = {k: self._gather(k, i) for k in self.ds}
        split = {k: torch.split(v, self.global_batch)
                 for k, v in gathered.items()}
        return [{k: split[k][p] for k in split} for p in range(parts)]

    def epoch(self, epoch: int) -> Iterator[dict]:
        """Device batches for one epoch, in ``Split.iter_epoch_indices``
        order."""
        pending: list[np.ndarray] = []
        for idx in self.split.iter_epoch_indices(
                self.global_batch, shuffle=self.shuffle, seed=self.seed,
                epoch=epoch):
            pending.append(idx)
            if len(pending) == self.group:
                flat = np.concatenate(pending)
                pending = []
                yield from self._assemble(flat, self.group)
        for idx in pending:
            yield from self._assemble(idx, 1)
