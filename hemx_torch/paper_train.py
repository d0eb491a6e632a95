"""Training entry with the dataset's mean depth image (counterpart of the
root ``paper_train.py``; reference: paper_train.py).

    python -m hemx_torch.paper_train --model paper_cgan --dataset synthetic \\
        --synthetic_shape 65 65 3 --synthetic_u8 --batch_size 256 \\
        --dir workspace/cgan [--model_version mean_adjusted ...]

Before training it computes the mean and variance depth images over the
train and validate splits, in order (paper_train.py:43-60), writes
``mean_image.png``, ``var_image.png`` and ``mean_image.npy`` into
``--dir`` (byte-equal to ``paper_train.py``'s), and hands the mean image to
the model (``model.mean_image``, the y_mean baseline of its Eigen
summaries). Then it trains as ``python -m hemx_torch.cli`` does, with its
flags (``--n_devices`` included: rank 0 writes the files), exit codes (2
for an unknown model, 255 for a non-finite gradient) and last line.
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np

from hemx_torch import cli
from hemx_torch.config import init_working_dir
from hemx_torch.parallel import dp
from hemx_torch.summaries.montage import to_uint8
from hemx_torch.summaries.png import encode_png
from hemx_torch.utils import terminal as term


def dataset_depth_moments(splits, args, crop: bool = True):
    """(mean, variance) depth images (H, W) over the train and validate
    host batches, unshuffled, or (None, None) for a dataset without depth.
    A uint8 depth is widened and scaled to [0, 1] (its square would wrap),
    a float one summed in float64; depths 46 px or taller are cropped to
    the paper models' (17, 17, 29, 29) box first."""
    total = total_sq = None
    count = 0
    for name in ("train", "validate"):
        if name not in splits:
            continue
        for batch in splits[name].iter_epoch(args.batch_size, shuffle=False):
            if "depth" not in batch:
                return None, None
            d = batch["depth"]
            if d.dtype == np.uint8:
                d = d.astype(np.float32) / 255.0
            else:
                d = d.astype(np.float64)
            if crop and d.shape[1] >= 46:
                d = d[:, 17:46, 17:46, :]
            s, sq = d.sum(axis=0), (d ** 2).sum(axis=0)
            total = s if total is None else total + s
            total_sq = sq if total_sq is None else total_sq + sq
            count += d.shape[0]
    if count == 0:
        return None, None
    mean = total / count
    var = total_sq / count - mean ** 2
    return mean[..., 0], np.maximum(var[..., 0], 0.0)


def write_moments(directory: str, mean_img: np.ndarray,
                  var_img: np.ndarray) -> None:
    """``mean_image.png``, ``var_image.png`` (the variance min-max
    scaled) and ``mean_image.npy``, as ``paper_train.py`` writes them."""
    with open(os.path.join(directory, "mean_image.png"), "wb") as f:
        f.write(encode_png(to_uint8(mean_img)))
    with open(os.path.join(directory, "var_image.png"), "wb") as f:
        span = var_img.max() - var_img.min()
        f.write(encode_png(to_uint8((var_img - var_img.min())
                                    / max(span, 1e-12))))
    np.save(os.path.join(directory, "mean_image.npy"), mean_img)


def run(argv=None) -> dict:
    """Build as the CLI does, write the moments, train. The result holds
    the CLI's keys plus "moments_s" (host seconds of the moments)."""
    args, device, model, splits = cli.build(argv, axes=False)
    if dp.is_primary():
        init_working_dir(args)
    term.message("Computing dataset depth statistics...")
    t0 = time.perf_counter()
    mean_img, var_img = dataset_depth_moments(splits, args)
    if mean_img is not None:
        if dp.is_primary():
            write_moments(args.dir, mean_img, var_img)
        if hasattr(model, "mean_image"):
            model.mean_image = mean_img.astype(np.float32)
    moments_s = time.perf_counter() - t0
    result = cli.train(args, device, model, splits)
    result["moments_s"] = moments_s
    return result


def main(argv=None) -> int:
    return cli.main(argv, run=run, axes=False)


if __name__ == "__main__":
    sys.exit(main())
