"""The seam between ``hemx`` pytrees and ``hemx_torch`` modules.

A ``hemx`` parameter or BN-state pytree is a nested dict of arrays; the
``state_dict`` key of a leaf is its path joined with dots (parameter names
are shared, ``hemx_torch.ops.layers``), so conversion is a rename plus a
layout change for kernels:

* conv ``w``: HWIO -> OIHW, ``permute(3, 2, 0, 1)``;
* deconv ``w``: ``[H, W, out, in]`` -> torch's ``(in, out, H, W)``, the same
  permute (no flip);
* dense ``w``: ``[in, out]`` -> ``(out, in)``, a transpose.

Empty subtrees (``flatten``/``unflatten`` layers, convs without BN state)
have no torch counterpart and are skipped. Values cross as numpy arrays;
this module never imports JAX.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn

from hemx_torch.ops.layers import Conv2d, Deconv2d, Dense

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


def unflatten_tree(flat: dict) -> dict:
    tree: dict = {}
    for path, leaf in flat.items():
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
    return tree


def _layout(net: nn.Module, path: tuple, t: torch.Tensor, table) -> torch.Tensor:
    if path[-1] != "w":
        return t
    owner = net.get_submodule(".".join(path[:-1]))
    return table[type(owner)](t)


def state_dict_from_jax(net: nn.Module, params: dict, mstate: dict) -> dict:
    """``hemx`` params + mstate pytrees -> a ``state_dict`` for ``net``."""
    sd = {}
    for tree in (params, mstate):
        for path, leaf in flatten_tree(tree).items():
            t = torch.from_numpy(np.array(leaf, dtype=np.float32))
            sd[".".join(path)] = _layout(net, path, t, _W_TO_TORCH)
    return sd


def load_from_jax(net: nn.Module, params: dict, mstate: dict) -> None:
    """Load ``hemx`` pytrees into ``net``; every key must match both ways."""
    net.load_state_dict(state_dict_from_jax(net, params, mstate), strict=True)


def tensor_to_jax(net: nn.Module, name: str, t: torch.Tensor) -> np.ndarray:
    """The tensor at ``state_dict`` key ``name`` of ``net`` (or a tensor of
    its shape, e.g. its gradient) as a numpy array in ``hemx`` layout."""
    path = tuple(name.split("."))
    t = _layout(net, path, t.detach().cpu(), _W_TO_JAX)
    return np.ascontiguousarray(t.numpy())


def to_jax(net: nn.Module) -> tuple[dict, dict]:
    """``net`` -> (params, mstate) pytrees of numpy arrays in ``hemx``
    layout (parameters -> params, BN buffers -> mstate)."""
    params = {tuple(n.split(".")): tensor_to_jax(net, n, p)
              for n, p in net.named_parameters()}
    mstate = {tuple(n.split(".")): tensor_to_jax(net, n, b)
              for n, b in net.named_buffers()}
    return unflatten_tree(params), unflatten_tree(mstate)


def adam_moments_to_jax(net: nn.Module, opt: torch.optim.Adam) -> dict:
    """Adam's first and second moments of ``net``'s parameters as the
    ``mu`` / ``nu`` pytrees of ``optax.scale_by_adam``'s state."""
    mu, nu = {}, {}
    for n, p in net.named_parameters():
        state = opt.state[p]
        mu[tuple(n.split("."))] = tensor_to_jax(net, n, state["exp_avg"])
        nu[tuple(n.split("."))] = tensor_to_jax(net, n, state["exp_avg_sq"])
    return {"mu": unflatten_tree(mu), "nu": unflatten_tree(nu)}
