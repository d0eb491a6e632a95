"""Checkpoint manager, epoch-keyed, resume by directory (counterpart of
``hemx.train.checkpoint``).

* ``checkpoint-<epoch>.msgpack``, one per epoch plus the baseline at
  epoch 0, written to a ``.tmp`` file and renamed into place;
* ``max_to_keep`` most recent kept (0 keeps all);
* ``latest()`` is the highest epoch in the directory.

A checkpoint is the flax state dict of hemx's wrapper
``{"train_state": {params, mstate, opt, step, rng}, "epoch"}``, written by
``hemx_torch.train.msgpack`` in flax's msgpack format, so the two packages
read each other's files. Building that tree from a live train state, and
loading one into it, is ``hemx_torch.convert``'s job.
"""

from __future__ import annotations

import os
import re
from typing import Optional

from hemx_torch.parallel import dp
from hemx_torch.train import msgpack

_CKPT_RE = re.compile(r"^checkpoint-(\d+)\.msgpack$")


class CheckpointManager:
    def __init__(self, directory: str, max_to_keep: int = 0):
        self.directory = directory
        self.max_to_keep = max_to_keep
        os.makedirs(directory, exist_ok=True)

    def checkpoints(self) -> list[tuple[int, str]]:
        """Sorted [(epoch, path)]."""
        found = []
        for fname in os.listdir(self.directory):
            m = _CKPT_RE.match(fname)
            if m:
                found.append((int(m.group(1)),
                              os.path.join(self.directory, fname)))
        return sorted(found)

    def latest(self) -> Optional[str]:
        ckpts = self.checkpoints()
        return ckpts[-1][1] if ckpts else None

    def save(self, tree: dict, epoch: int) -> Optional[str]:
        """Write ``tree`` (nested dicts of numpy arrays and scalars) as
        ``checkpoint-<epoch>.msgpack``; returns the path. In a process
        group only rank 0 writes (the others return None): every rank holds
        the same state."""
        if not dp.is_primary():
            return None
        path = os.path.join(self.directory, f"checkpoint-{epoch}.msgpack")
        data = msgpack.packb(tree)
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(data)
        os.replace(tmp, path)
        self._gc()
        return path

    def restore(self, path: Optional[str] = None) -> dict:
        """The state dict in ``path`` (default: the latest checkpoint)."""
        path = path or self.latest()
        if path is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        with open(path, "rb") as f:
            return msgpack.unpackb(f.read())

    def _gc(self) -> None:
        if self.max_to_keep <= 0:
            return
        for _, path in self.checkpoints()[:-self.max_to_keep]:
            try:
                os.remove(path)
            except FileNotFoundError:
                pass
