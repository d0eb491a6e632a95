"""Two-phase composed training (counterpart of the root ``experimental.py``;
reference: experimental.py).

    python -m hemx_torch.experimental --model experimental_sampler \\
        --dataset nyuv2 --random_crop 64 64 --include_location \\
        --estimator_epochs 30 --epochs 10 --batch_size 64 --optimizer adam \\
        --lr 1e-5 --beta1 0.5 --dir workspace/experimental

Phase 1 trains a ``mean_depth_estimator`` for ``--estimator_epochs`` epochs
(passed on as the epoch spec string, so ``--epochs``' ``+n`` rules apply to
it) into ``<dir>/estimator``. Phase 2 trains an ``experimental_sampler``
composed with the estimator's final state (its mean-depth estimate is a
frozen input channel) for ``--epochs`` at lr 1e-4 whatever ``--lr`` says
(experimental.py:45), into ``<dir>/sampler``. The resolved options go to
``<dir>`` first. Flags, exit codes and the last line (the sampler's run
summary) are ``python -m hemx_torch.cli``'s.
"""

from __future__ import annotations

import copy
import sys

from hemx_torch import cli
from hemx_torch.config import init_working_dir
from hemx_torch.models.plugin import get_model
from hemx_torch.parallel import dp
from hemx_torch.utils import terminal as term


def run(argv=None) -> dict:
    """Both phases. The result is the sampler's run (the CLI's keys) plus
    "estimator", the estimator's loop result."""
    from hemx_torch.train import loop

    args, device, _, splits = cli.build(argv, axes=False)
    if dp.is_primary():
        init_working_dir(args)

    term.message("Phase 1: training mean_depth_estimator...")
    est_args = copy.copy(args)
    est_args.epochs = str(getattr(args, "estimator_epochs", 30))
    est_args.dir = args.dir + "/estimator"
    estimator = get_model("mean_depth_estimator")(est_args, device)
    est_result = loop.train(estimator, splits, est_args, device)

    term.message("Phase 2: training experimental_sampler (composed)...")
    sampler_args = copy.copy(args)
    sampler_args.lr = 1e-4
    sampler_args.dir = args.dir + "/sampler"
    sampler = get_model("experimental_sampler")(sampler_args, device)
    sampler.set_estimator(estimator, est_result["train_state"])
    result = cli.train(sampler_args, device, sampler, splits)
    result["estimator"] = est_result
    return result


def main(argv=None) -> int:
    return cli.main(argv, run=run, axes=False)


if __name__ == "__main__":
    sys.exit(main())
