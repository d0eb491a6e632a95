"""Optimizer switch (counterpart of ``hemx.train.optimizers``).

Every name of hemx's switch: rmsprop (TF parity), adadelta, adagrad and
padagrad, sgd and pgd, momentum, adam, ftrl. Each is the chain of optax
transforms that hemx builds, written out in PyTorch with optax's arithmetic
in optax's order, and keeps optax's state under optax's names: ``state`` is
the flax state dict of the optax state, with every per-parameter tree held
as a :class:`Moments` (``{parameter name: tensor}``). rmsprop at hemx's
defaults, ``chain(scale_by_rms, scale_by_learning_rate, trace)``, has the
state ``{"0": {"nu": Moments}, "1": {}, "2": {"trace": Moments}}``;
``hemx_torch.convert`` turns a Moments into hemx's parameter-shaped tree,
so a checkpoint's optimizer state is a rename plus the layout permutes.

TF parity of rmsprop: the mean-square accumulator starts at ones and eps is
1e-10 inside the square root (``optax.rmsprop(initial_scale=1.0,
eps_in_sqrt=True)``); ``torch.optim.RMSprop`` starts at zeros and adds eps
outside, so it is not used. ``pgd`` and ``padagrad`` are sgd and adagrad, as
in hemx (TF's proximal terms at their default strength of zero).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch
import torch.nn as nn

from hemx_torch.parallel import dp
from hemx_torch.utils import tracing


class Moments(dict):
    """One parameter-shaped tree of an optimizer state:
    ``{parameter name: tensor}``, names as in ``module.named_parameters()``."""


class Transform(NamedTuple):
    """An optax ``GradientTransformation``: ``init(params) -> state``,
    ``update(updates, state, params) -> (updates, state)``; params and
    updates are ``{name: tensor}`` dicts."""
    init: Callable
    update: Callable


def _full(params: dict, value: float) -> Moments:
    return Moments({n: torch.full_like(p, value) for n, p in params.items()})


def _empty():
    """``optax.EmptyState`` / ``identity()``: no state, updates unchanged."""
    return Transform(lambda params: {}, lambda g, s, params: (g, s))


def chain(*transforms: Transform) -> Transform:
    """``optax.chain``: the state is the tuple of states, ``{"0": ...}``."""
    def init(params):
        return {str(i): t.init(params) for i, t in enumerate(transforms)}

    def update(g, state, params):
        new = {}
        for i, t in enumerate(transforms):
            g, new[str(i)] = t.update(g, state[str(i)], params)
        return g, new
    return Transform(init, update)


def _moment(g, t, decay):
    """optax ``update_moment`` (order 1): ``(1 - decay) * g + decay * t``."""
    return (1 - decay) * g + decay * t


def _moment2(g, t, decay):
    """optax ``update_moment_per_elem_norm`` (order 2)."""
    return (1 - decay) * (g * g) + decay * t


def scale_by_learning_rate(lr: float) -> Transform:
    """``optax.scale_by_learning_rate``: updates times ``-lr``."""
    return Transform(lambda params: {},
                     lambda g, s, params: ({n: -lr * u for n, u in g.items()},
                                          s))


def trace(decay: float) -> Transform:
    def update(g, s, params):
        tr = Moments({n: u + decay * s["trace"][n] for n, u in g.items()})
        return dict(tr), {"trace": tr}
    return Transform(lambda params: {"trace": _full(params, 0.0)}, update)


def scale_by_rms(decay: float, eps: float, initial_scale: float) -> Transform:
    """``optax.scale_by_rms(eps_in_sqrt=True)``."""
    def update(g, s, params):
        nu = Moments({n: _moment2(u, s["nu"][n], decay) for n, u in g.items()})
        return ({n: torch.rsqrt(nu[n] + eps) * u for n, u in g.items()},
                {"nu": nu})
    return Transform(lambda params: {"nu": _full(params, initial_scale)},
                     update)


def scale_by_stddev(decay: float, eps: float, initial_scale: float) -> Transform:
    """``optax.scale_by_stddev(eps_in_sqrt=True)`` (centered rmsprop)."""
    def init(params):
        return {"mu": _full(params, 0.0), "nu": _full(params, initial_scale)}

    def update(g, s, params):
        mu = Moments({n: _moment(u, s["mu"][n], decay) for n, u in g.items()})
        nu = Moments({n: _moment2(u, s["nu"][n], decay) for n, u in g.items()})
        return ({n: torch.rsqrt(nu[n] - mu[n] * mu[n] + eps) * u
                 for n, u in g.items()}, {"mu": mu, "nu": nu})
    return Transform(init, update)


def scale_by_adadelta(rho: float, eps: float) -> Transform:
    def init(params):
        return {"e_g": _full(params, 0.0), "e_x": _full(params, 0.0)}

    def update(g, s, params):
        e_g = Moments({n: _moment2(u, s["e_g"][n], rho) for n, u in g.items()})
        out = {n: torch.sqrt(s["e_x"][n] + eps) / torch.sqrt(e_g[n] + eps) * u
               for n, u in g.items()}
        e_x = Moments({n: _moment2(u, s["e_x"][n], rho)
                       for n, u in out.items()})
        return out, {"e_g": e_g, "e_x": e_x}
    return Transform(init, update)


def scale_by_rss(initial_accumulator_value: float = 0.1,
                 eps: float = 1e-7) -> Transform:
    def update(g, s, params):
        ss = Moments({n: u * u + s["sum_of_squares"][n] for n, u in g.items()})
        out = {n: torch.where(ss[n] > 0, torch.rsqrt(ss[n] + eps), 0.0) * u
               for n, u in g.items()}
        return out, {"sum_of_squares": ss}
    return Transform(
        lambda params: {"sum_of_squares": _full(params,
                                                initial_accumulator_value)},
        update)


def _bias_correction(decay: float, count: int) -> float:
    """``1 - decay**count``, in float32 as optax computes it."""
    return float(np.float32(1) - np.float32(decay) ** np.float32(count))


def scale_by_adam(b1: float, b2: float, eps: float = 1e-8) -> Transform:
    def init(params):
        return {"count": 0, "mu": _full(params, 0.0), "nu": _full(params, 0.0)}

    def update(g, s, params):
        mu = Moments({n: _moment(u, s["mu"][n], b1) for n, u in g.items()})
        nu = Moments({n: _moment2(u, s["nu"][n], b2) for n, u in g.items()})
        count = min(s["count"] + 1, np.iinfo(np.int32).max)
        c1, c2 = _bias_correction(b1, count), _bias_correction(b2, count)
        out = {n: (mu[n] / c1) / (torch.sqrt(nu[n] / c2) + eps) for n in g}
        return out, {"count": count, "mu": mu, "nu": nu}
    return Transform(init, update)


def ftrl(lr: float) -> Transform:
    """FTRL-Proximal at tf.train.FtrlOptimizer's defaults, the only ones
    hemx uses (``hemx.train.optimizers.ftrl``: learning-rate power -0.5,
    accumulator 0.1, l1 = l2 = 0, where the proximal step is
    ``-z / (sqrt(n) / lr)``); its state is ``{"n", "z"}``, not a chain."""
    def init(params):
        return {"n": _full(params, 0.1), "z": _full(params, 0.0)}

    def update(g, s, params):
        out, new_n, new_z = {}, Moments(), Moments()
        for name, u in g.items():
            n, z, p = s["n"][name], s["z"][name], params[name]
            nn_ = n + u * u
            nz = z + u - (nn_ ** 0.5 - n ** 0.5) / lr * p
            new_n[name], new_z[name] = nn_, nz
            out[name] = -nz / (nn_ ** 0.5 / lr) - p
        return out, {"n": new_n, "z": new_z}
    return Transform(init, update)


def adam(lr: float, b1: float = 0.9, b2: float = 0.999) -> Transform:
    """``optax.adam(lr, b1, b2)``: ``chain(scale_by_adam, scale_by_learning_rate)``."""
    return chain(scale_by_adam(b1, b2), scale_by_learning_rate(lr))


def rmsprop(lr: float) -> Transform:
    """``optax.rmsprop(lr)`` at optax's defaults: decay 0.9, eps 1e-8 inside
    the square root, the accumulator starting at zeros, no momentum (an
    ``identity()`` in the chain's third slot). Not the switch's rmsprop,
    whose TF parity starts at ones with eps 1e-10 (paper_cgan's ``wgan``
    generator uses this one, ``hemx/models/paper_cgan.py:64-69``)."""
    return chain(scale_by_rms(0.9, 1e-8, 0.0), scale_by_learning_rate(lr),
                 _empty())


class Optimizer:
    """A transform applied to the parameters of ``module``:
    ``step(grads)`` computes the updates from ``grads`` (in
    ``named_parameters`` order) and adds them in place
    (``optax.apply_updates``). ``state`` is replaced on every step."""

    def __init__(self, module: nn.Module, tx: Transform):
        self.module = module
        self.params = dict(module.named_parameters())
        self.tx = tx
        self.state = tx.init(self._values())

    def _values(self) -> dict:
        return {n: p.detach() for n, p in self.params.items()}

    @torch.no_grad()
    @tracing.spanned("optimizer")
    def step(self, grads) -> None:
        """In a process group ``grads`` are first averaged over the ranks,
        in place (every model's updates pass here, so every rank applies
        the same update, WGAN's clipping after it included)."""
        dp.all_reduce_grads(grads)
        g = dict(zip(self.params, grads))
        updates, self.state = self.tx.update(g, self.state, self._values())
        for n, p in self.params.items():
            p.add_(updates[n])


def make_transform(args) -> Transform:
    """The optax chain ``hemx.train.optimizers.init_optimizer`` builds."""
    name = args.optimizer
    if name == "rmsprop":
        scaler = scale_by_stddev if args.centered else scale_by_rms
        return chain(scaler(args.decay, 1e-10, 1.0),
                     scale_by_learning_rate(args.lr), trace(args.momentum))
    if name == "adadelta":
        return chain(_empty(), scale_by_adadelta(0.95, 1e-8),
                     scale_by_learning_rate(args.lr))
    if name in ("adagrad", "padagrad"):
        return chain(scale_by_rss(), scale_by_learning_rate(args.lr))
    if name in ("sgd", "pgd"):
        return chain(_empty(), scale_by_learning_rate(args.lr))
    if name == "momentum":
        return chain(trace(args.momentum), scale_by_learning_rate(args.lr))
    if name == "adam":
        return adam(args.lr, args.beta1, args.beta2)
    if name == "ftrl":
        return ftrl(args.lr)
    raise ValueError(f"unknown optimizer: {name}")


def init_optimizer(args, module: nn.Module) -> Optimizer:
    return Optimizer(module, make_transform(args))


@torch.no_grad()
def clip_params(params, clip: float = 0.01) -> None:
    """WGAN weight clipping to ``[-clip, clip]``, in place, after the update
    (``hemx.train.optimizers.clip_params``)."""
    for p in params:
        p.clamp_(-clip, clip)
