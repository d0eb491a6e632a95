"""hemx_torch training CLI (counterpart of ``train.py``).

    python -m hemx_torch.cli --model iwgan --dataset synthetic --synthetic_u8 \\
        --dtype bfloat16 --dir workspace/iwgan
    python -m hemx_torch.cli ... --dir workspace/iwgan --epochs +1   # resume

``--model`` is one of ``cnn`` (the default, as in ``train.py``), ``vae``,
``gan``, ``wgan``, ``iwgan`` and the thesis depth models (``paper_cgan``,
``paper_sampler``, ``paper_noise``, ``paper_baseline_sampler``,
``paper_standalone``, ``paper_baseline_standalone``, ``sampler_gan``;
``python -m hemx_torch.paper_train`` adds their dataset depth moments),
the second generation (``improved_sampler``, ``mean_depth_estimator``,
``experimental_sampler``), ``pix2pix``, ``artist``, ``info_gan`` and the
no-op ``test``: hemx's whole zoo. Flags may come from hemx's config files
(``@examples/pix2pix.config``); ``--dataset`` one of ``floorplan`` (the
default), ``mnist``, ``cifar``, ``nyuv2`` and ``synthetic``. A dataset
whose records are not in ``--dataset_dir`` is converted from its raw files
in ``--raw_dataset_dir`` first:

    python -m hemx_torch.cli --model cnn --dataset mnist \
        --raw_dataset_dir <raw> --dataset_dir <records> [--no-device_data_cache]

Flags are ``hemx``'s (see ``hemx_torch.config``) plus ``--device``
(default ``cuda``); the workspace (checkpoints, events, options) has
``train.py``'s layout and formats. The last line of standard output is a
JSON summary: device, final step and epoch, call count, median call time
and images/s. A non-finite gradient under ``--check_numerics`` exits 255,
as ``train.py`` does.
"""

from __future__ import annotations

import json
import sys

import torch


class CliError(Exception):
    def __init__(self, message: str, code: int = 1):
        super().__init__(message)
        self.code = code


def build(argv=None, splits=None):
    """Parse the flags and build what a run trains: ``(args, device, model,
    splits)``. Checks the device, then the model (exit code 2 when it is
    unknown), then the dataset, before any data is loaded. ``splits``: the
    dataset's splits for these flags when the caller holds them already
    (runs in one process over the same data), made here otherwise."""
    from hemx_torch.config import parse_args
    from hemx_torch.data.plugin import (get_dataset, get_dataset_tensors,
                                        unknown_dataset_message)
    from hemx_torch.models.plugin import available_models, get_model
    from hemx_torch.ops.layers import set_precision

    args = parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise CliError(f"--device {args.device}: no CUDA device is available "
                       f"(use --device cpu to run on the CPU)")
    model_cls = get_model(args.model)
    if model_cls is None:
        raise CliError(f"unknown model '{args.model}'. Available in "
                       f"hemx_torch: {available_models()}", code=2)
    if get_dataset(args.dataset) is None:
        raise CliError(unknown_dataset_message(args.dataset))
    set_precision(args.precision)
    model = model_cls(args, device)
    return args, device, model, (get_dataset_tensors(args) if splits is None
                                 else splits)


def train(args, device, model, splits) -> dict:
    """Train through ``hemx_torch.train.loop``; returns the loop's result
    plus "args" and "summary" (also printed as the last line)."""
    from hemx_torch.train import loop

    result = loop.train(model, splits, args, device)
    result["args"] = args
    result["summary"] = loop.summarize(result, args.batch_size, device)
    print(json.dumps(result["summary"]), flush=True)
    return result


def run(argv=None, splits=None) -> dict:
    """Parse, build and train (:func:`build`, then :func:`train`)."""
    return train(*build(argv, splits))


def main(argv=None, run=run) -> int:
    """Exit code of ``run(argv)``: 0, 255 on a non-finite gradient, 2 for
    an unknown model, 1 for other refusals."""
    try:
        run(argv)
    except FloatingPointError as e:
        print(f"ERROR: {e}", file=sys.stderr)
        return 255
    except (CliError, NotImplementedError) as e:
        print(f"ERROR: {e}", file=sys.stderr)
        return getattr(e, "code", 1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
