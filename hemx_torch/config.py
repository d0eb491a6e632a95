"""Command-line flags of the port (counterpart of ``hemx.config``).

Every flag the port reads has ``hemx.config``'s name and default (pinned by
``tests/test_torch_cli.py``); ``--device`` is new. A model's own flags
(``--g_arch``, ``--m_arch``, ``--estimator_epochs``, ...) come from its
plugin's ``arguments()``, as in ``hemx``. ``@FILE`` (or ``--config FILE``)
reads flags from one of hemx's config files (``key value`` lines, ``#``
comments, e.g. ``examples/improved_sampler/a1.config``), expanded in place
so later flags override it. ``--n_devices`` (alias ``--n_gpus``) is
hemx's: devices of the run, ``--batch_size`` per data shard;
``--model_parallel`` and ``--spatial_parallel`` are hemx's ``model`` and
``spatial`` mesh axes (``hemx_torch.parallel.mesh``, ``tp``, ``sp``). ``--buffer_size``,
``--cache_dir`` and ``--n_threads`` are accepted and unread, as in
``hemx``. Parsing is ``hemx``'s
three phases — general flags, then the dataset's, then the model's — and
flags the port does not read are reported and ignored, as ``hemx`` does
with unknown flags. ``init_working_dir`` writes the resolved options to
``<dir>/options.config`` (re-ingestable with ``@file`` by ``train.py``) and
``<dir>/options.json``, as ``hemx.config.init_working_dir`` does.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import uuid


class ConfigFileParser(argparse.ArgumentParser):
    """A parser whose ``@``-files hold ``key value`` lines and ``#``
    comments (``hemx.config.CustomArgumentParser``)."""

    def convert_arg_line_to_args(self, arg_line):
        line = arg_line.split("#", 1)[0].strip()
        if not line:
            return []
        parts = line.split()
        if not parts[0].startswith("-"):
            parts[0] = "--" + parts[0]
        return parts


def build_base_parser() -> argparse.ArgumentParser:
    parser = ConfigFileParser(
        description="hemx_torch training harness (PyTorch/CUDA port of hemx).",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
        fromfile_prefix_chars="@", conflict_handler="resolve")
    misc = parser.add_argument_group("Miscellaneous")
    misc.add_argument("--seed", type=int, default=None,
                      help="RNG seed; randomized each run when unset.")
    misc.add_argument("--device", default="cuda",
                      help="torch device to train on ('cuda', 'cuda:1', "
                           "'cpu'); a CUDA device that is absent is an error.")
    misc.add_argument("--n_devices", "--n_gpus", dest="n_devices", type=int,
                      default=0,
                      help="Devices in the data-parallel mesh (0 = all local "
                           "devices): one process per device, each holding "
                           "--batch_size rows of the global batch.")
    misc.add_argument("--model_parallel", type=int, default=1,
                      help="Tensor-parallel degree (hemx's 'model' mesh "
                           "axis): every kernel sliced over this many ranks.")
    misc.add_argument("--spatial_parallel", type=int, default=1,
                      help="Spatial-parallel degree (hemx's 'spatial' mesh "
                           "axis): image height banded over this many ranks.")
    misc.add_argument("--profile", action="store_true", default=False,
                      help="Record a torch.profiler trace of up to ten train "
                           "calls of the first epoch into <dir>/profile.")
    misc.add_argument("--check_numerics", action="store_true", default=False,
                      help="Check gradients for NaN/Inf every call and exit "
                           "nonzero naming the parameter.")
    misc.add_argument("--summarize_activations", action="store_true",
                      default=False,
                      help="Write per-layer activation mean/zero-fraction/"
                           "histogram at every summary write.")
    misc.add_argument("--summarize_gradients", action="store_true",
                      default=False,
                      help="Write per-variable gradient mean + histogram at "
                           "every summary write.")
    misc.add_argument("--summarize_weights", action="store_true", default=False,
                      help="Write per-parameter histograms + means at each "
                           "epoch end.")
    misc.add_argument("--model", type=str.lower, default="cnn",
                      help="Model plugin to train.")
    misc.add_argument("--examples", type=int, default=64,
                      help="Number of example images in montage summaries.")

    train = parser.add_argument_group("Training")
    train.add_argument("--epochs", default="3",
                       help="Epochs this run: integer for max, or +n for n "
                            "more from checkpoint.")
    train.add_argument("--batch_size", type=int, default=256,
                       help="Batch size per device (global batch = "
                            "batch_size * n_devices).")
    train.add_argument("--epoch_size", type=int, default=-1,
                       help="Train calls per epoch (-1 = full dataset).")
    train.add_argument("--dir", type=str, default=None,
                       help="Workspace dir (checkpoints, events, "
                            "options.config); workspace/<uuid4> when unset. "
                            "A populated dir resumes training.")
    train.add_argument("--max_to_keep", type=int, default=0,
                       help="Recent checkpoints to keep; 0 keeps all.")
    train.add_argument("--test_epochs", nargs="*", type=int, default=[],
                       help="Epochs at which to run the test split.")
    train.add_argument("--summary_freq", type=int, default=0,
                       help="Summaries per epoch (0 = reference cadence: "
                            "10x/epoch first 3 epochs then 3x/epoch).")
    train.add_argument("--dtype", type=str.lower, default="float32",
                       choices=["float32", "bfloat16"],
                       help="Compute dtype of every conv, deconv and dense "
                            "(params stay float32).")
    train.add_argument("--precision", type=str.lower, default="default",
                       choices=["default", "high", "highest"],
                       help="'default'/'high' allow TF32 in cuBLAS and "
                            "cuDNN; 'highest' keeps full float32.")

    opt = parser.add_argument_group("Optimizer")
    opt.add_argument("--optimizer", type=str.lower, default="rmsprop")
    opt.add_argument("--lr", type=float, default=0.001)
    opt.add_argument("--momentum", type=float, default=0.01)
    opt.add_argument("--decay", type=float, default=0.9)
    opt.add_argument("--centered", action="store_true", default=False)
    opt.add_argument("--beta1", type=float, default=0.9)
    opt.add_argument("--beta2", type=float, default=0.999)

    data = parser.add_argument_group("Data")
    data.add_argument("--dataset", type=str.lower, default="floorplan")
    data.add_argument("--shuffle", action=argparse.BooleanOptionalAction,
                      default=True)
    data.add_argument("--buffer_size", type=int, default=10000,
                      help="Unread: the epoch is shuffled whole, as in "
                           "hemx.")
    data.add_argument("--resize", type=int, nargs=2, default=None,
                      metavar=("H", "W"),
                      help="Resize input images for any dataset (TF1 "
                           "bilinear); nyuv2's own --resize takes precedence "
                           "there.")
    data.add_argument("--grayscale", action="store_true", default=False,
                      help="Convert RGB input images to single-channel luma.")
    data.add_argument("--cache_dir", default=None,
                      help="Unread, as in hemx: decoded samples are cached "
                           "in memory.")
    data.add_argument("--raw_dataset_dir", default="/tmp",
                      help="Where a dataset's raw files are (converted to "
                           "records when --dataset_dir has none).")
    data.add_argument("--dataset_dir", default="datasets",
                      help="Where the converted records are kept, one "
                           "directory per dataset.")
    data.add_argument("--n_threads", type=int, default=os.cpu_count() or 1,
                      help="Unread, as in hemx.")
    data.add_argument("--device_data_cache",
                      action=argparse.BooleanOptionalAction, default=True,
                      help="Keep the whole compact dataset on the device and "
                           "gather batches there when it fits "
                           "--device_cache_mb; other splits (host "
                           "augmentation, too large, or --no-device_data_cache)"
                           " stream through the host pipeline.")
    data.add_argument("--device_cache_mb", type=int, default=1024,
                      help="Device memory budget of --device_data_cache, per "
                           "split.")
    return parser


def _expand(argv) -> list:
    """``argv`` (default ``sys.argv[1:]``) with ``--config FILE`` as
    ``@FILE``."""
    argv = list(sys.argv[1:] if argv is None else argv)
    while "--config" in argv:
        i = argv.index("--config")
        argv[i:i + 2] = ["@" + argv[i + 1]]
    return argv


def parse_base_args(argv=None):
    """The general flags alone, with nothing reported and nothing
    resolved (an entry point reads ``--n_devices`` and ``--device`` with
    it before the run parses everything)."""
    return build_base_parser().parse_known_args(_expand(argv))[0]


def parse_args(argv=None):
    from hemx_torch.data.plugin import get_dataset
    from hemx_torch.models.plugin import get_model
    from hemx_torch.parallel import dp

    argv = _expand(argv)
    parser = build_base_parser()
    args, leftover = parser.parse_known_args(argv)
    for cls in (get_dataset(args.dataset), get_model(args.model)):
        if cls is not None:
            for k, v in cls.arguments().items():
                parser.add_argument(k, **v)
            args, leftover = parser.parse_known_args(leftover, namespace=args)
    if leftover and dp.is_primary():
        print(f"WARNING: unknown and unused arguments provided: {leftover}",
              file=sys.stderr)
    # BooleanOptionalAction flags are dumped in their no- form when False
    args._negatable = {a.dest for a in parser._actions
                       if isinstance(a, argparse.BooleanOptionalAction)}
    if args.seed is None:
        args.seed = int.from_bytes(os.urandom(4), "little")
    if args.dir is None:
        args.dir = os.path.join("workspace", str(uuid.uuid4()))
    return args


def init_working_dir(args) -> str:
    """Create the workspace and dump the resolved options."""
    os.makedirs(args.dir, exist_ok=True)
    dump_options(args, os.path.join(args.dir, "options.config"))
    with open(os.path.join(args.dir, "options.json"), "w") as f:
        json.dump({k: _jsonable(v) for k, v in vars(args).items()
                   if not k.startswith("_")}, f, indent=2, sort_keys=True)
    return args.dir


def load_options(path: str) -> dict:
    """A run's ``options.json`` as a dict (the evaluation tools rebuild the
    model from it). It may come from hemx, whose file also holds keys the
    port does not read (``deconv_impl``, ...): they are kept and
    ignored."""
    with open(path) as f:
        return json.load(f)


def dump_options(args, path: str) -> None:
    negatable = getattr(args, "_negatable", {"shuffle", "device_data_cache"})
    with open(path, "w") as f:
        f.write("# hemx resolved options (re-ingestable with @thisfile)\n")
        for k in sorted(vars(args)):
            if k.startswith("_"):
                continue
            v = getattr(args, k)
            if isinstance(v, bool):
                if v:
                    f.write(f"{k}\n")
                elif k in negatable:
                    f.write(f"no-{k}\n")
            elif isinstance(v, (list, tuple)):
                if v:
                    f.write(f"{k} {' '.join(str(i) for i in v)}\n")
            elif v is not None:
                f.write(f"{k} {v}\n")


def _jsonable(v):
    if isinstance(v, (str, int, float, bool, type(None))):
        return v
    if isinstance(v, (list, tuple)):
        return [_jsonable(i) for i in v]
    return str(v)
