"""Synthetic in-memory dataset (counterpart of ``hemx.data.synthetic``).

A numpy copy of ``hemx``'s ``_make_images`` and of its uint8 rounding,
pinned equal to the original by ``tests/test_torch_data.py``. The train,
validate and test splits are seeded ``seed``, ``seed + 1`` and ``seed + 2``
as in ``hemx``, with hemx's keys: ``image``, ``depth``, ``x_loc``,
``y_loc`` and ``mean``. Registered as the ``synthetic`` dataset plugin; nothing is
converted or downloaded.
"""

from __future__ import annotations

import numpy as np

from hemx_torch.data.pipeline import ArraySource, Split, U8Normalize
from hemx_torch.data.plugin import DataPlugin


def _make_images(n: int, h: int, w: int, c: int, seed: int,
                 blobs: int = 5, chunk: int = 2048) -> np.ndarray:
    """Structured scenes: a linear-gradient background plus ``blobs`` soft
    elliptical blobs with random position/size/orientation/color."""
    rng = np.random.default_rng(seed)
    yy = np.linspace(0.0, 1.0, h, dtype=np.float32)[:, None]
    xx = np.linspace(0.0, 1.0, w, dtype=np.float32)[None, :]
    out = np.empty((n, h, w, c), np.float32)
    for s in range(0, n, chunk):
        m = min(chunk, n - s)
        g0 = rng.uniform(0.25, 0.75, (m, 1, 1, c)).astype(np.float32)
        gx = rng.uniform(-0.4, 0.4, (m, 1, 1, c)).astype(np.float32)
        gy = rng.uniform(-0.4, 0.4, (m, 1, 1, c)).astype(np.float32)
        img = g0 + gx * xx[None, :, :, None] + gy * yy[None, :, :, None]
        for _ in range(blobs):
            cx = rng.uniform(0.1, 0.9, (m, 1, 1)).astype(np.float32)
            cy = rng.uniform(0.1, 0.9, (m, 1, 1)).astype(np.float32)
            rx = rng.uniform(0.06, 0.25, (m, 1, 1)).astype(np.float32)
            ry = rng.uniform(0.06, 0.25, (m, 1, 1)).astype(np.float32)
            th = rng.uniform(0.0, np.pi, (m, 1, 1)).astype(np.float32)
            col = rng.uniform(-0.8, 0.8, (m, c)).astype(np.float32)
            dx = xx[None] - cx
            dy = yy[None] - cy
            u = (np.cos(th) * dx + np.sin(th) * dy) / rx
            v = (-np.sin(th) * dx + np.cos(th) * dy) / ry
            blob = np.exp(-(u * u + v * v))
            img += blob[..., None] * col[:, None, None, :]
        out[s:s + m] = np.clip(img, 0.0, 1.0)
    return out


def to_u8(images: np.ndarray) -> np.ndarray:
    """``--synthetic_u8`` storage: round [0,1] floats to uint8."""
    return np.round(images * 255.0).astype(np.uint8)


class SyntheticDataset(DataPlugin):
    name = "synthetic"

    @staticmethod
    def arguments() -> dict:
        return {
            "--synthetic_count": dict(type=int, default=1024,
                                      help="Samples in the train split."),
            "--synthetic_shape": dict(type=int, nargs=3, default=[64, 64, 3],
                                      help="H W C of generated images."),
            "--synthetic_eval_count": dict(
                type=int, default=0,
                help="Samples in validate/test splits (0 = same as "
                     "--synthetic_count)."),
            "--synthetic_u8": dict(
                action="store_true", default=False,
                help="Store image and depth as uint8 and normalize on the "
                     "device (the real-dataset path); float32 otherwise."),
        }

    @staticmethod
    def check_prepared_datasets(storage_dir: str) -> bool:
        return True  # generated on the fly

    @staticmethod
    def check_raw_datasets(storage_dir: str) -> bool:
        return True

    @staticmethod
    def download(download_dir: str) -> bool:
        return True

    @staticmethod
    def convert_to_tfrecord(download_dir: str, storage_dir: str) -> None:
        pass

    @classmethod
    def get_datasets(cls, args) -> dict:
        """{"train", "validate", "test": Split}, each equal to ``hemx``'s
        split of the same name: ``image``, ``depth`` (the image's channel
        mean ×0.9 + 0.05), ``x_loc`` / ``y_loc`` (each pixel's column / row
        on [0, 1]) and ``mean`` (the per-image mean depth, from the float
        depth), the last three float32 broadcast views. ``--synthetic_u8``
        rounds ``image`` and ``depth`` to uint8, which :class:`U8Normalize`
        turns back on the device."""
        h, w, c = args.synthetic_shape
        n_eval = getattr(args, "synthetic_eval_count", 0) or args.synthetic_count
        ys = np.linspace(0.0, 1.0, h, dtype=np.float32)
        xs = np.linspace(0.0, 1.0, w, dtype=np.float32)
        splits = {}
        for i, name in enumerate(("train", "validate", "test")):
            n = args.synthetic_count if name == "train" else n_eval
            images = _make_images(n, h, w, c, seed=args.seed + i)
            depth = images.mean(axis=3, keepdims=True) * 0.9 + 0.05
            arrays = {
                "x_loc": np.broadcast_to(xs[None, None, :, None], (n, h, w, 1)),
                "y_loc": np.broadcast_to(ys[None, :, None, None], (n, h, w, 1)),
                "mean": np.broadcast_to(
                    depth.mean(axis=(1, 2, 3), keepdims=True), depth.shape)}
            dt = None
            if args.synthetic_u8:
                images, depth = to_u8(images), to_u8(depth)
                dt = U8Normalize(keys=("image", "depth"))
            splits[name] = Split(
                ArraySource({"image": images, "depth": depth, **arrays}),
                name=name, device_transform=dt)
        return splits
