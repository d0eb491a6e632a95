"""Command-line flags of the IWGAN slice (counterpart of ``hemx.config``).

Every flag the port reads has ``hemx.config``'s name and default (pinned by
``tests/test_torch_cli.py``); ``--device`` is new. Parsing is ``hemx``'s
three phases — general flags, then the dataset's, then the model's — and
flags the port does not read are reported and ignored, as ``hemx`` does
with unknown flags.
"""

from __future__ import annotations

import argparse
import os
import sys


def build_base_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="hemx_torch training harness (PyTorch/CUDA port of hemx).",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
        conflict_handler="resolve")
    misc = parser.add_argument_group("Miscellaneous")
    misc.add_argument("--seed", type=int, default=None,
                      help="RNG seed; randomized each run when unset.")
    misc.add_argument("--model", type=str.lower, default="cnn",
                      help="Model plugin to train.")
    misc.add_argument("--device", default="cuda",
                      help="torch device to train on ('cuda', 'cuda:1', "
                           "'cpu'); a CUDA device that is absent is an error.")

    train = parser.add_argument_group("Training")
    train.add_argument("--epochs", default="3",
                       help="Epochs this run (+n is n: the port has no "
                            "checkpoints to resume from yet).")
    train.add_argument("--batch_size", type=int, default=256)
    train.add_argument("--epoch_size", type=int, default=-1,
                       help="Train calls per epoch (-1 = full dataset).")
    train.add_argument("--dtype", type=str.lower, default="float32",
                       choices=["float32", "bfloat16"],
                       help="Compute dtype; only float32 is ported.")
    train.add_argument("--precision", type=str.lower, default="default",
                       choices=["default", "high", "highest"],
                       help="'default'/'high' allow TF32 in cuBLAS and "
                            "cuDNN; 'highest' keeps full float32.")

    opt = parser.add_argument_group("Optimizer")
    opt.add_argument("--optimizer", type=str.lower, default="rmsprop")
    opt.add_argument("--lr", type=float, default=0.001)
    opt.add_argument("--beta1", type=float, default=0.9)
    opt.add_argument("--beta2", type=float, default=0.999)

    data = parser.add_argument_group("Data")
    data.add_argument("--dataset", type=str.lower, default="floorplan")
    data.add_argument("--shuffle", action=argparse.BooleanOptionalAction,
                      default=True)
    data.add_argument("--device_data_cache",
                      action=argparse.BooleanOptionalAction, default=True,
                      help="Keep the dataset on the device (the only input "
                           "path ported).")
    data.add_argument("--device_cache_mb", type=int, default=1024)
    return parser


def parse_args(argv=None):
    from hemx_torch.data.synthetic import get_dataset
    from hemx_torch.models.plugin import get_model

    argv = list(sys.argv[1:] if argv is None else argv)
    parser = build_base_parser()
    args, leftover = parser.parse_known_args(argv)
    for cls in (get_dataset(args.dataset), get_model(args.model)):
        if cls is not None:
            for k, v in cls.arguments().items():
                parser.add_argument(k, **v)
            args, leftover = parser.parse_known_args(leftover, namespace=args)
    if leftover:
        print(f"WARNING: unknown and unused arguments provided: {leftover}",
              file=sys.stderr)
    if args.seed is None:
        args.seed = int.from_bytes(os.urandom(4), "little")
    return args
