"""Full-image depth from a 65x65-patch model (counterpart of the root
``paper_fullimage.py``; reference: paper_fullimage.py).

    python -m hemx_torch.paper_fullimage --dir workspace/cgan \\
        [--split test] [--n_scenes 8] [--strides 10 8 6 4 2 1] [--chunk 512] \\
        [--scene_shape 240 320 3]

Restores the run's latest checkpoint and, for each scene of ``--split``
and each stride, slides 65x65 windows over the scene (:func:`build_batch`),
predicts them in chunks of ``--chunk`` (the last chunk padded by repeating
the last window; the true depth windows feed the model's per-patch mean,
a flat 0.5 when the scene has none; the extra keys come from the first row
of the run's first train batch), and rebuilds the 29x29 outputs into the
scene by averaging where windows overlap, NaN where none reaches
(:func:`reconstruct`). Scenes are normalized on the host (uint8 / 255), as
hemx does. ``--scene_shape`` renders the synthetic dataset's scenes at
another size than the training patches (only the split read is rendered at
its full count).

Writes into ``<dir>/fullimage/``: ``scene<s>_stride<k>.png`` per scene and
stride, ``scene<s>_comparison.png`` (rgb, truth, then each stride's
rebuild) and ``rmse.json`` (per stride: each scene's RMSE against the true
depth over the covered pixels, and their mean). ``--device`` defaults to
``cuda``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
import types

import numpy as np
import torch

from hemx_torch.cli import CliError
from hemx_torch.data.plugin import get_dataset_tensors
from hemx_torch.models.conditional import numpy_nhwc
from hemx_torch.runs import check_device, restore_run
from hemx_torch.summaries.montage import to_uint8
from hemx_torch.summaries.png import encode_png
from hemx_torch.utils import terminal as term

PATCH = 65
OUT = 29
OUT_OFFSET = 17  # the 29x29 output covers input pixels [17, 46)


def build_batch(image: np.ndarray, stride: int):
    """(patches, coords) of the ``PATCH`` x ``PATCH`` windows of an HWC
    image at ``stride``, row by row."""
    h, w, _ = image.shape
    patches, coords = [], []
    for top in range(0, h - PATCH + 1, stride):
        for left in range(0, w - PATCH + 1, stride):
            patches.append(image[top:top + PATCH, left:left + PATCH])
            coords.append((top, left))
    return np.stack(patches), coords


def _device_batch(batch: dict, device) -> dict:
    """Host NHWC arrays -> NCHW (channels_last) tensors on ``device``."""
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            .permute(0, 3, 1, 2) for k, v in batch.items()}


def forward_inference(model, ts, patches: np.ndarray, device, batch: dict,
                      chunk: int = 512,
                      depth_patches: np.ndarray | None = None) -> np.ndarray:
    """G's NHWC outputs of ``patches``, predicted ``chunk`` at a time.
    ``batch`` is a host batch of the run: its first row's keys other than
    image and depth go with every patch."""
    n = patches.shape[0]
    pad = (-n) % chunk
    if pad:
        patches = np.concatenate([patches, np.repeat(patches[-1:], pad, axis=0)])
    if depth_patches is None:
        depth_full = np.zeros(
            (patches.shape[0],) + tuple(batch["depth"].shape[1:]),
            np.float32) + 0.5
    else:
        depth_full = depth_patches.astype(np.float32)
        if pad:
            depth_full = np.concatenate(
                [depth_full, np.repeat(depth_full[-1:], pad, axis=0)])
    extras = {k: np.repeat(np.asarray(v[:1]), chunk, axis=0)
              for k, v in batch.items() if k not in ("image", "depth")
              and (model.batch_keys is None or k in model.batch_keys)}
    outs = []
    for i in range(0, patches.shape[0], chunk):
        part = {"image": patches[i:i + chunk],
                "depth": depth_full[i:i + chunk], **extras}
        g, _ = model.predict(ts, _device_batch(part, device))
        outs.append(numpy_nhwc(g))
    return np.concatenate(outs)[:n]


def reconstruct(shape, preds: np.ndarray, coords, depth_range) -> np.ndarray:
    """Overlap-averaged 29x29 outputs (NaN where no window reaches),
    mapped from the model's output range to [0, 1] depth."""
    h, w = shape
    lo, hi = depth_range
    total = np.zeros((h, w), np.float64)
    count = np.zeros((h, w), np.float64)
    for pred, (top, left) in zip(preds[..., 0], coords):
        t, l = top + OUT_OFFSET, left + OUT_OFFSET
        total[t:t + OUT, l:l + OUT] += pred
        count[t:t + OUT, l:l + OUT] += 1
    out = np.full((h, w), np.nan)
    mask = count > 0
    out[mask] = total[mask] / count[mask]
    return (out - lo) / (hi - lo)


def _write_png(path: str, img: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(encode_png(to_uint8(img)))


def run(argv=None) -> dict:
    """{"rmse": {stride: {"scenes", "mean"}}, "patches", "seconds"}: the
    per-stride RMSE (also in ``rmse.json``), the windows predicted and the
    seconds spent predicting them."""
    parser = argparse.ArgumentParser(
        description="hemx_torch full-image inference")
    parser.add_argument("--dir", required=True)
    parser.add_argument("--split", default="test")
    parser.add_argument("--n_scenes", type=int, default=8)
    parser.add_argument("--strides", type=int, nargs="*",
                        default=[10, 8, 6, 4, 2, 1])
    parser.add_argument("--chunk", type=int, default=512)
    parser.add_argument("--scene_shape", type=int, nargs=3, default=None,
                        help="Render the synthetic dataset's scenes at H W C "
                             "instead of the training patch size.")
    parser.add_argument("--device", default="cuda")
    a = parser.parse_args(argv)
    device = check_device(a.device)
    args, splits, model, ts, host_batch, _ = restore_run(a.dir, device)
    scene_splits = splits
    if a.scene_shape:
        scene_args = types.SimpleNamespace(**vars(args))
        scene_args.synthetic_shape = list(a.scene_shape)
        if a.split != "train":
            # only --split is read: its scenes are the same at any train
            # count, so the train split is rendered at one image
            scene_args.synthetic_eval_count = (
                getattr(args, "synthetic_eval_count", 0)
                or args.synthetic_count)
            scene_args.synthetic_count = 1
        scene_splits = get_dataset_tensors(scene_args)
    depth_range = (model.depth_range() if hasattr(model, "depth_range")
                   else (0.0, 1.0))
    term.message(f"model depth range: {depth_range}")

    split = scene_splits[a.split]
    scenes = next(split.iter_epoch(min(a.n_scenes, split.count),
                                   shuffle=False))
    scenes = {k: (np.asarray(v).astype(np.float32) / 255.0
                  if np.asarray(v).dtype == np.uint8 else np.asarray(v))
              for k, v in scenes.items()}
    out_dir = os.path.join(a.dir, "fullimage")
    os.makedirs(out_dir, exist_ok=True)
    n_scenes = scenes["image"].shape[0]
    if min(scenes["image"].shape[1:3]) < PATCH:
        term.message(f"scene smaller than {PATCH}px; skipping")
        return {"rmse": {}, "patches": 0, "seconds": 0.0}
    recons: dict = {s: {} for s in range(n_scenes)}
    report, n_patches, seconds = {}, 0, 0.0
    for stride in a.strides:
        rmses = []
        for s in range(n_scenes):
            image = scenes["image"][s]
            scene_depth = scenes["depth"][s]
            depth = scene_depth[..., 0]
            patches, coords = build_batch(image, stride)
            depth_patches = np.stack([scene_depth[t:t + PATCH, l:l + PATCH]
                                      for t, l in coords])
            t0 = time.perf_counter()
            preds = forward_inference(model, ts, patches, device, host_batch,
                                      a.chunk, depth_patches=depth_patches)
            seconds += time.perf_counter() - t0
            n_patches += len(coords)
            recon = reconstruct(image.shape[:2], preds, coords, depth_range)
            valid = ~np.isnan(recon)
            rmses.append(float(np.sqrt(np.mean(
                (recon[valid] - depth[valid]) ** 2))))
            recons[s][stride] = recon
            _write_png(os.path.join(out_dir, f"scene{s}_stride{stride}.png"),
                       np.clip(np.where(valid, recon, 0.0), 0, 1))
        report[str(stride)] = {"scenes": rmses, "mean": float(np.mean(rmses))}
        term.message(f"stride {stride}: mean rmse "
                     f"{report[str(stride)]['mean']:.4f} over {len(rmses)} "
                     f"scenes")
    for s in range(n_scenes):
        cols = [scenes["image"][s].mean(axis=-1), scenes["depth"][s][..., 0]]
        cols += [np.where(np.isnan(recons[s][st]), 0.0, recons[s][st])
                 for st in a.strides]
        _write_png(os.path.join(out_dir, f"scene{s}_comparison.png"),
                   np.concatenate([np.clip(c, 0, 1) for c in cols], axis=1))
    with open(os.path.join(out_dir, "rmse.json"), "w") as f:
        json.dump(report, f, indent=2, sort_keys=True)
    term.message(f"comparison montages: {out_dir}/scene*_comparison.png "
                 f"(columns: rgb, gt, strides {a.strides})")
    return {"rmse": report, "patches": n_patches, "seconds": seconds}


def main(argv=None) -> int:
    try:
        run(argv)
    except CliError as e:
        print(f"ERROR: {e}", file=sys.stderr)
        return e.code
    return 0


if __name__ == "__main__":
    sys.exit(main())
