"""Eigen-metric evaluation of a trained depth model over whole splits
(counterpart of the root ``paper_metrics.py``; reference: paper_metrics.py).

    python -m hemx_torch.paper_metrics --dir workspace/cgan \\
        [--checkpoint 50] [--splits train validate test] [--max_batches N]

Rebuilds the model from the run's ``options.json`` (one written by hemx or
by the port), restores checkpoint ``--checkpoint`` (default 50, the
reference's) or, when the run has none of that epoch, the latest, and
averages the Eigen suite over each split's batches, in order, at hemx's
global batch (``batch_size * (n_devices or 1)`` from the run's options,
:mod:`hemx_torch.runs`), for:

* ``y_hat``: the model's prediction;
* ``y_0``: zeros under ``--model_version baseline``, else the per-image
  mean depth;
* ``y_mean``: the dataset's mean depth image, when the run has
  ``mean_image.npy`` (``python -m hemx_torch.paper_train`` writes it).

Depths are mapped to [0, 1] by the model's ``depth_range()`` (meters / 10
for the paper models) and clipped below at 1e-3. Writes
``<dir>/metrics/eigen_metrics.json`` and, with a mean image,
``<dir>/metrics/mean_depth.png``. ``--device`` defaults to ``cuda``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

from hemx_torch.cli import CliError
from hemx_torch.data.pipeline import place_batch
from hemx_torch.metrics.eigen import EigenAccumulator, eigen_metrics
from hemx_torch.models.conditional import numpy_nhwc
from hemx_torch.runs import check_device, global_batch, restore_run
from hemx_torch.summaries.montage import to_uint8
from hemx_torch.summaries.png import encode_png
from hemx_torch.utils import terminal as term


def evaluate_split(model, ts, split, args, device, mean_image=None,
                   max_batches: int | None = None) -> dict:
    """{variant: {metric: mean over the split's batches}}, the split
    batched at hemx's global batch (:func:`hemx_torch.runs.global_batch`),
    the remainder dropped."""
    accs = {"y_hat": EigenAccumulator(), "y_0": EigenAccumulator()}
    if mean_image is not None:
        accs["y_mean"] = EigenAccumulator()
    lo, hi = (model.depth_range() if hasattr(model, "depth_range")
              else (0.0, 1.0))
    version = getattr(args, "model_version", None)
    n = 0
    for batch in split.iter_epoch(global_batch(args, device),
                                   shuffle=False):
        g, prep = model.predict(ts, place_batch(batch, split, device,
                                                model.batch_keys))
        y = (numpy_nhwc(prep["y"]) - lo) / (hi - lo)
        y_hat = (numpy_nhwc(g) - lo) / (hi - lo)
        y_bar = y.mean(axis=(1, 2, 3), keepdims=True)
        y0 = (np.zeros_like(y) if version == "baseline"
              else np.broadcast_to(y_bar, y.shape))
        variants = {"y_hat": y_hat, "y_0": y0}
        if mean_image is not None:
            variants["y_mean"] = np.broadcast_to(
                mean_image[None, :, :, None], y.shape)
        for name, pred in variants.items():
            m = eigen_metrics(np.clip(y, 1e-3, None),
                              np.clip(np.ascontiguousarray(pred), 1e-3, None))
            accs[name].update({k: float(v) for k, v in m.items()})
        n += 1
        if max_batches and n >= max_batches:
            break
    return {name: acc.result() for name, acc in accs.items()}


def run(argv=None) -> dict:
    """The report ({split: {variant: {metric: value}}}), also written."""
    parser = argparse.ArgumentParser(
        description="hemx_torch Eigen metric evaluation")
    parser.add_argument("--dir", required=True)
    parser.add_argument("--checkpoint", type=int, default=50,
                        help="Epoch checkpoint to evaluate (the reference "
                             "used checkpoint-50); falls back to the latest.")
    parser.add_argument("--splits", nargs="*",
                        default=["train", "validate", "test"])
    parser.add_argument("--max_batches", type=int, default=0)
    parser.add_argument("--device", default="cuda")
    a = parser.parse_args(argv)
    device = check_device(a.device)
    args, splits, model, ts, _, path = restore_run(a.dir, device, a.checkpoint)
    term.message(f"Evaluating {path}")
    mean_path = os.path.join(a.dir, "mean_image.npy")
    mean_image = np.load(mean_path) if os.path.exists(mean_path) else None

    out_dir = os.path.join(a.dir, "metrics")
    os.makedirs(out_dir, exist_ok=True)
    report = {}
    for name in a.splits:
        if name not in splits:
            continue
        term.message(f"split: {name}")
        report[name] = evaluate_split(model, ts, splits[name], args, device,
                                      mean_image, a.max_batches or None)
        for variant, metrics in report[name].items():
            term.message(f"  {variant}: " + ", ".join(
                f"{k}={v:.4f}" for k, v in sorted(metrics.items())))
    if mean_image is not None:
        with open(os.path.join(out_dir, "mean_depth.png"), "wb") as f:
            f.write(encode_png(to_uint8(mean_image)))
    with open(os.path.join(out_dir, "eigen_metrics.json"), "w") as f:
        json.dump(report, f, indent=2, sort_keys=True)
    term.message(f"wrote {out_dir}/eigen_metrics.json")
    return report


def main(argv=None) -> int:
    try:
        run(argv)
    except CliError as e:
        print(f"ERROR: {e}", file=sys.stderr)
        return e.code
    return 0


if __name__ == "__main__":
    sys.exit(main())
