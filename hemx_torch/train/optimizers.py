"""Optimizer factory (counterpart of ``hemx.train.optimizers``).

Only the two optimizers the IWGAN slice needs are ported: ``adam``
(``optax.adam(lr, b1, b2)``, eps 1e-8 outside the sqrt, as
``torch.optim.Adam``) and ``sgd`` (``optax.sgd(lr)``). The rest of
``hemx``'s 9-way switch is ROADMAP queue 1 item 3.
"""

from __future__ import annotations

import torch


def init_optimizer(args, params) -> torch.optim.Optimizer:
    name = args.optimizer
    params = list(params)
    if name == "adam":
        return torch.optim.Adam(params, lr=args.lr,
                                betas=(args.beta1, args.beta2), eps=1e-8)
    if name == "sgd":
        return torch.optim.SGD(params, lr=args.lr)
    raise NotImplementedError(
        f"optimizer '{name}' is not ported to hemx_torch yet (only adam and "
        f"sgd; the rest is ROADMAP queue 1 item 3)")
