"""Dataset plugin base and registry (counterpart of ``hemx.data.plugin``).

A plugin declares its CLI ``arguments()``, knows how to
``check``/``download``/``convert_to_tfrecord`` its data, and returns
``{split: Split}`` from ``get_datasets(args)``. The registry scans the
port's own ``hemx_torch.data`` modules for ``DataPlugin`` subclasses, as
``hemx`` scans ``hemx.data``. ``get_dataset_tensors`` is the assembly
entry: it converts the raw files when the records are missing, then
applies ``--resize`` and ``--grayscale``, in the reference's order.
JPEG images (celeb, coco) and coco's polygon masks need Pillow, imported
when such a file is first decoded or drawn.
"""

from __future__ import annotations

import fcntl
import importlib
import os
import pkgutil
import sys
from typing import Optional

from hemx_torch.summaries import proto
from hemx_torch.utils import terminal as term

_REGISTRY: dict[str, type] = {}
_SCANNED = False
_NOT_PLUGINS = ("plugin", "pipeline", "tfrecord", "imageio")

# protobuf feature helpers (hemx.data.plugin)
def bytes_feature(value: bytes) -> bytes:
    return proto.feature_bytes([value])


def int64_feature(*values: int) -> bytes:
    return proto.feature_int64(values)


def float_feature(*values: float) -> bytes:
    return proto.feature_float(values)


class DataPlugin:
    """Base class for dataset plugins. Subclasses set ``name``."""

    name: str = ""

    @staticmethod
    def arguments() -> dict:
        """{'--flag': argparse-kwargs} contributed to the CLI."""
        return {}

    @staticmethod
    def check_prepared_datasets(storage_dir: str) -> bool:
        raise NotImplementedError

    @staticmethod
    def check_raw_datasets(storage_dir: str) -> bool:
        raise NotImplementedError

    @staticmethod
    def download(download_dir: str) -> bool:
        raise NotImplementedError

    @staticmethod
    def convert_to_tfrecord(download_dir: str, storage_dir: str) -> None:
        raise NotImplementedError

    @classmethod
    def get_datasets(cls, args) -> dict:
        """Return {split_name: hemx_torch.data.pipeline.Split}."""
        raise NotImplementedError


def _scan() -> None:
    global _SCANNED
    if _SCANNED:
        return
    import hemx_torch.data as pkg
    for modinfo in pkgutil.iter_modules(pkg.__path__):
        if modinfo.name.startswith("_") or modinfo.name in _NOT_PLUGINS:
            continue
        try:
            mod = importlib.import_module(f"hemx_torch.data.{modinfo.name}")
        except Exception as e:  # plugin import failures must not kill the CLI
            term.message(f"WARNING: failed to import data plugin "
                         f"hemx_torch.data.{modinfo.name}: {e}", sys.stderr)
            continue
        for obj in vars(mod).values():
            if (isinstance(obj, type) and obj is not DataPlugin
                    and DataPlugin in obj.__mro__[1:] and obj.name):
                _REGISTRY[obj.name] = obj
    _SCANNED = True


def register(cls: type) -> type:
    """Decorator to register out-of-tree plugins."""
    _REGISTRY[cls.name] = cls
    return cls


def get_dataset(name: str) -> Optional[type]:
    _scan()
    return _REGISTRY.get(name)


def available_datasets() -> list[str]:
    _scan()
    return sorted(_REGISTRY)


def unknown_dataset_message(name: str) -> str:
    return f"unknown dataset '{name}'; available: {available_datasets()}"


def prepare_dataset(args) -> type:
    """The dataset's plugin, after converting the raw files in
    ``--raw_dataset_dir`` into records when ``--dataset_dir`` has none
    (downloading them first where the plugin can).

    Processes that prepare one ``--dataset_dir`` at once (the ranks of a
    group) take turns on an exclusive lock of that directory: one
    converts, and the others wait for it outside any collective, so a
    conversion longer than the group's timeout fails no rank. A plugin
    with no records on disk (synthetic) needs no lock."""
    cls = get_dataset(args.dataset)
    if cls is None:
        raise ValueError(unknown_dataset_message(args.dataset))
    storage = os.path.join(args.dataset_dir, cls.name)
    # records half written by another process may pass the check: only an
    # absent storage directory is read without the lock
    if not os.path.isdir(storage) and cls.check_prepared_datasets(storage):
        return cls
    os.makedirs(args.dataset_dir, exist_ok=True)
    fd = os.open(args.dataset_dir, os.O_RDONLY)
    try:
        fcntl.flock(fd, fcntl.LOCK_EX)
        if not cls.check_prepared_datasets(storage):
            if not cls.check_raw_datasets(args.raw_dataset_dir):
                term.message(f"Downloading raw dataset for '{cls.name}'...")
                cls.download(args.raw_dataset_dir)
            term.message(f"Converting '{cls.name}' to TFRecord...")
            cls.convert_to_tfrecord(args.raw_dataset_dir, storage)
    finally:
        os.close(fd)  # releases the lock
    return cls


def get_dataset_tensors(args) -> dict:
    """Prepare the dataset (:func:`prepare_dataset`) and return its
    splits, resized then converted to grey as the flags ask."""
    splits = prepare_dataset(args).get_datasets(args)
    # reference input-layer order: resize, then grayscale (train.py:226-231)
    if getattr(args, "resize", None):
        from hemx_torch.data.pipeline import resize_images
        splits = {k: resize_images(v, args.resize) for k, v in splits.items()}
    if getattr(args, "grayscale", False):
        from hemx_torch.data.pipeline import to_grayscale
        splits = {k: to_grayscale(v) for k, v in splits.items()}
    return splits
