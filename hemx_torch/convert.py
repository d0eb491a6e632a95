"""The seam between ``hemx`` pytrees and ``hemx_torch`` train states.

A ``hemx`` parameter or BN-state pytree is a nested dict of arrays; the
``state_dict`` key of a leaf is its path joined with dots (parameter names
are shared, ``hemx_torch.ops.layers``), so conversion is a rename plus a
layout change for kernels:

* conv ``w``: HWIO -> OIHW, ``permute(3, 2, 0, 1)``;
* deconv ``w``: ``[H, W, out, in]`` -> torch's ``(in, out, H, W)``, the same
  permute (no flip);
* dense ``w``: ``[in, out]`` -> ``(out, in)``, a transpose;
* a depth net's flat ``{name}_w`` (``hemx_torch.models.depth_nets``, the
  names in its ``kernels``; improved_sampler's ``e*``, ``d*``, ``final``,
  ``hx*``, ``hy*``, ``h*`` too; pix2pix's U-Net ``e*``, ``d*`` and
  PatchGAN ``m*``, artist's ``e*`` and ``d*``, info_gan's ``g*``, ``d*``
  and ``q1``): a conv or deconv kernel, the same permute. (The mean-depth
  estimator's ``l1``-``l8`` are conv and dense modules.)

Trees built from modules keep hemx's empty subtrees: a layer with no
parameters (``flatten``, ``unflatten``) or no BN state is ``{}``, in the
parameters, in the BN state and in every optimizer moment tree, as in
hemx's pytrees and so in its checkpoints.

The whole train state crosses as hemx's checkpoint tree (the flax state
dict of ``{"train_state": {params, mstate, opt, step, rng}, "epoch"}``):
``opt`` is the optax state of the model's one optimizer (CNN, VAE), or a
dict of them (the GANs' and the conditional GANs' ``{"g", "d"}``, artist's
``{"x", "y"}``, info_gan's ``{"g", "d", "q"}``; the standalone depth
models keep one), under optax's names. An optimizer over several networks
(artist's ``y`` over the encoder and the y decoder, info_gan's ``q`` over
the predictor and the generator) keeps one subtree per network, as optax
does for a dict of parameter trees
(``hemx_torch.train.optimizers``), ``step`` is a 0-d int32 array, ``rng``
the uint32[2] key, ``epoch`` an int64 (0-d array or numpy scalar).
Loading checks that the tree
has exactly the leaves and shapes of the port's own, no more and no fewer.
Values cross as numpy arrays; this module never imports JAX.

Under ``--model_parallel`` (``hemx_torch.parallel.tp``) the trees hold
whole tensors: a sliced kernel and its optimizer moments are gathered
from the axis group's slices on the way out (every rank of the group
calls in), and each rank loads its slice of the whole tensor, so a
checkpoint has the same tree and bytes as a one-process run's and either
resumes the other.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch
import torch.nn as nn

from hemx_torch.ops.layers import Conv2d, Deconv2d, Dense
from hemx_torch.parallel import tp
from hemx_torch.train.optimizers import Moments, Optimizer

_W_TO_TORCH = {Conv2d: lambda t: t.permute(3, 2, 0, 1),
               Deconv2d: lambda t: t.permute(3, 2, 0, 1),
               Dense: lambda t: t.t()}
_W_TO_JAX = {Conv2d: lambda t: t.permute(2, 3, 1, 0),
             Deconv2d: lambda t: t.permute(2, 3, 1, 0),
             Dense: lambda t: t.t()}


def flatten_tree(tree: dict, prefix: tuple = ()) -> dict:
    """Nested dict -> {path tuple: leaf}; empty subtrees vanish."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flatten_tree(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


def _layout(net: nn.Module, path: tuple, t: torch.Tensor, table) -> torch.Tensor:
    owner = net.get_submodule(".".join(path[:-1]))
    if path[-1] in getattr(owner, "kernels", ()):  # a depth net's flat name
        return table[Conv2d](t)
    if path[-1] != "w":
        return t
    return table[type(owner)](t)


def state_dict_from_jax(net: nn.Module, params: dict, mstate: dict) -> dict:
    """``hemx`` params + mstate pytrees -> a ``state_dict`` for ``net``
    (under the model axis, this rank's slice of each sliced kernel)."""
    sd = {}
    own = dict(net.named_parameters())
    for tree in (params, mstate):
        for path, leaf in flatten_tree(tree).items():
            t = torch.from_numpy(np.array(leaf, dtype=np.float32))
            name = ".".join(path)
            t = _layout(net, path, t, _W_TO_TORCH)
            sd[name] = tp.local_part(t, own[name]) if name in own else t
    return sd


def load_from_jax(net: nn.Module, params: dict, mstate: dict) -> None:
    """Load ``hemx`` pytrees into ``net``; every key must match both ways."""
    net.load_state_dict(state_dict_from_jax(net, params, mstate), strict=True)


def jax_view(net: nn.Module, name: str, t: torch.Tensor) -> torch.Tensor:
    """The tensor at ``state_dict`` key ``name`` of ``net`` (or a tensor of
    its shape, e.g. its gradient) in ``hemx`` layout, as a view on its
    device."""
    return _layout(net, tuple(name.split(".")), t.detach(), _W_TO_JAX)


def _numpy(t: torch.Tensor) -> np.ndarray:
    return t.contiguous().cpu().numpy()


def tensor_to_jax(net: nn.Module, name: str, t: torch.Tensor) -> np.ndarray:
    """:func:`jax_view` as a numpy array."""
    return _numpy(jax_view(net, name, t))


def _module_tree(module: nn.Module, names: Callable, get: Callable,
                 prefix: str = "") -> dict:
    """Nested dict over ``module``'s hierarchy: the leaves ``names(m)`` of
    each module, fetched by their dotted name with ``get``, beside one
    subtree per child (``{}`` for a child without leaves)."""
    out = {n: get(prefix + n) for n in names(module)}
    for cname, child in module.named_children():
        out[cname] = _module_tree(child, names, get, f"{prefix}{cname}.")
    return out


def _param_names(m: nn.Module) -> list:
    return [n for n, _ in m.named_parameters(recurse=False)]


def _buffer_names(m: nn.Module) -> list:
    return [n for n, _ in m.named_buffers(recurse=False)]


def _trees(net: nn.Module, leaf: Callable) -> tuple[dict, dict]:
    params = dict(net.named_parameters())
    buffers = dict(net.named_buffers())
    return (_module_tree(net, _param_names,
                         lambda n: leaf(jax_view(net, n, tp.full(
                             params[n], params[n])))),
            _module_tree(net, _buffer_names,
                         lambda n: leaf(jax_view(net, n, buffers[n]))))


def to_jax(net: nn.Module) -> tuple[dict, dict]:
    """``net`` -> (params, mstate) pytrees of numpy arrays in ``hemx``
    layout and structure (parameters -> params, BN buffers -> mstate)."""
    return _trees(net, _numpy)


def opt_state_to_jax(opt: Optimizer, leaf: Callable = _numpy):
    """An optimizer's state as optax's state dict: each :class:`Moments` as
    a parameter-shaped tree in ``hemx`` layout, a step count as a 0-d
    int32 array."""
    net = opt.module
    params = dict(net.named_parameters())

    def walk(state):
        if isinstance(state, Moments):
            return _module_tree(net, _param_names,
                                lambda n: leaf(jax_view(net, n, tp.full(
                                    state[n], params[n]))))
        if isinstance(state, dict):
            return {k: walk(v) for k, v in state.items()}
        return np.asarray(state, np.int32)
    return walk(opt.state)


def _opt_tree(opt, fn: Callable):
    """``fn`` over a train state's optimizers: one optimizer over the whole
    model (hemx's CNN and VAE keep its optax state as ``opt`` itself), or a
    dict of them (the GANs' ``{"g", "d"}``)."""
    if isinstance(opt, Optimizer):
        return fn(opt)
    return {k: fn(o) for k, o in opt.items()}


def train_state_to_jax(ts, leaf: Callable = _numpy) -> dict:
    """The train state as hemx's ``{params, mstate, opt, step, rng}``."""
    params, mstate = _trees(ts.nets, leaf)
    return {"params": params, "mstate": mstate,
            "opt": _opt_tree(ts.opt, lambda o: opt_state_to_jax(o, leaf)),
            "step": np.asarray(ts.step, np.int32),
            "rng": np.asarray(ts.rng, np.uint32)}


def to_checkpoint(ts, epoch: int) -> dict:
    """hemx's checkpoint tree ``{"train_state", "epoch"}``. hemx's manager
    turns every leaf into an array before packing (``np.asarray``), so its
    files hold ``epoch`` as a 0-d int64 array, and so do the port's."""
    return {"train_state": train_state_to_jax(ts),
            "epoch": np.asarray(epoch, np.int64)}


def check_same_structure(want, got, path: tuple = ()) -> None:
    """Raise unless ``got`` has exactly ``want``'s keys (empty subtrees
    included) and leaf shapes."""
    where = "/".join(path) or "<root>"
    if isinstance(want, dict):
        if not isinstance(got, dict):
            raise ValueError(f"{where}: expected a subtree, found a leaf")
        if set(want) != set(got):
            raise ValueError(
                f"{where}: missing keys {sorted(set(want) - set(got))}, "
                f"extra keys {sorted(set(got) - set(want))}")
        for k in want:
            check_same_structure(want[k], got[k], path + (k,))
    elif isinstance(got, dict):
        raise ValueError(f"{where}: expected a leaf, found a subtree")
    elif tuple(np.shape(got)) != tuple(want.shape):
        raise ValueError(f"{where}: expected shape {tuple(want.shape)}, "
                         f"found {tuple(np.shape(got))}")


def _load_opt_state(opt: Optimizer, tree) -> None:
    net = opt.module
    params = dict(net.named_parameters())

    def walk(state, sub):
        if isinstance(state, Moments):
            out = Moments()
            for path, leaf in flatten_tree(sub).items():
                name = ".".join(path)
                t = torch.from_numpy(np.array(leaf, dtype=np.float32))
                t = _layout(net, path, t, _W_TO_TORCH)
                out[name] = state[name].copy_(tp.local_part(t, params[name]))
            return out
        if isinstance(state, dict):
            return {k: walk(v, sub[k]) for k, v in state.items()}
        return int(sub)
    opt.state = walk(opt.state, tree)


def load_checkpoint(ts, tree: dict) -> int:
    """Load hemx's checkpoint tree into ``ts`` in place; returns its epoch.
    The tree must hold exactly the leaves of ``ts``'s own tree."""
    template = {"train_state": train_state_to_jax(ts, leaf=lambda t: t),
                "epoch": np.asarray(0, np.int64)}
    check_same_structure(template, tree)
    state = tree["train_state"]
    load_from_jax(ts.nets, state["params"], state["mstate"])
    if isinstance(ts.opt, Optimizer):
        _load_opt_state(ts.opt, state["opt"])
    else:
        for k, opt in ts.opt.items():
            _load_opt_state(opt, state["opt"][k])
    ts.step = int(state["step"])
    ts.rng = np.array(state["rng"], dtype=np.uint32)
    return int(tree["epoch"])
