"""Tensor parallelism: hemx's ``model`` mesh axis (``--model_parallel M``).

hemx shards the LAST dimension of every train-state leaf of rank >= 2 whose
last dimension ``M`` divides (``hemx.parallel.mesh.param_spec``), and GSPMD
partitions the work to match. In the port's layouts hemx's last dimension
is always dim 0: conv OIHW (out), dense ``(out, in)`` (out) and deconv
``(in, out, kh, kw)`` (in, since hemx's deconv kernel is
``[H, W, out, in]``). :func:`shard_module` keeps rank ``a`` of an axis
group only rows ``[a*n : (a+1)*n]`` of dim 0 of each such parameter (its
optimizer moments are made from it, so they follow), and the ops split the
work the same way, in Megatron's form:

* conv and dense are column-parallel: the rank's output channels from the
  whole input, then an all-gather of the channels;
* deconv is row-parallel: the rank's input channels, then an all-reduce of
  the partial outputs.

Everything after a layer (bias, BN, activation) runs on the whole tensor,
the same on every rank of the axis group, so a loss is the same on each of
them and its gradient reaches a slice whole (:func:`gather`'s backward
takes the rank's slice of it).

The collectives are ``torch.autograd.Function`` s in conjugate pairs
(:class:`_Linear`): each one's backward is its partner, itself an
autograd op, so a backward is differentiable again (the IWGAN's gradient
penalty differentiates through the critic's backward):

* :func:`copy`: identity forward, all-reduce backward;
* :func:`reduce`: all-reduce forward, identity backward;
* :func:`gather`: all-gather forward, split backward;
* :func:`scatter`: split forward, all-gather backward.

Each is built on ``all_reduce`` alone, which gloo runs on CUDA tensors (an
all-gather is the all-reduce of a zeroed buffer in which each rank fills
its own slot: adding zeros is exact); NCCL runs the same code.
:func:`full` and :func:`local_part` move whole tensors in and out of the
slices (checkpoints), :func:`sum_squares` gives the whole kernels'
gradient norm, and :func:`full_weights` lends every rank the whole model
for the summaries rank 0 writes alone.
"""

from __future__ import annotations

import contextlib

import torch
import torch.distributed as dist

from hemx_torch.parallel import dp
from hemx_torch.utils import tracing

#: collectives and bytes the all-reduces of this module and of
#: ``hemx_torch.parallel.sp`` have run in this process
COLLECTIVES = tracing.counter("collectives", "collectives", "bytes")

# NCHW dim -> the dim of the same axis in the NHWC view of a 4-D tensor
_NHWC_DIM = {0: 0, 1: 3, 2: 1, 3: 2}


def active() -> bool:
    return dp.model_axis_size() > 1


def shardable(shape, m: int) -> bool:
    """hemx's ``param_spec`` on the port's layout (its last dim is dim 0
    here): rank >= 2 and ``m`` divides dim 0."""
    return m > 1 and len(shape) >= 2 and shape[0] >= m and shape[0] % m == 0


def sharded(t: torch.Tensor) -> bool:
    """``t`` is a parameter :func:`shard_module` sliced (or a cast of one,
    :func:`mark`)."""
    return getattr(t, "tp_sharded", False)


def mark(t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """``t`` (a cast of ``like``) marked sliced when ``like`` is."""
    if sharded(like) and t is not like:
        t.tp_sharded = True
    return t


def shard_module(net: torch.nn.Module) -> None:
    """Keep this rank's slice of dim 0 of every parameter of ``net`` hemx
    shards (all ranks built the same whole weights)."""
    if not active():
        return
    m, a = dp.axis_size(), dp.axis_index()
    for p in net.parameters():
        if shardable(p.shape, m):
            n = p.shape[0] // m
            p.data = p.data[a * n:(a + 1) * n].clone()
            p.tp_sharded = True


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1) if x.dim() == 4 else x


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2) if x.dim() == 4 else x


def _dim(x: torch.Tensor, dim: int) -> int:
    dim %= x.dim()
    return _NHWC_DIM[dim] if x.dim() == 4 else dim


def all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` summed over ``group``, as a new tensor (4-D: reduced in NHWC
    order, returned channels_last)."""
    buf = _nhwc(x).clone(memory_format=torch.contiguous_format)
    dist.all_reduce(buf, group=group)
    COLLECTIVES["collectives"] += 1
    COLLECTIVES["bytes"] += buf.numel() * buf.element_size()
    return _nchw(buf)


def all_gather(x: torch.Tensor, dim: int, group, k: int,
               index: int) -> torch.Tensor:
    """The ``k`` ranks' ``x`` concatenated along ``dim`` (this rank's at
    slot ``index``): the all-reduce of a zeroed buffer holding ``x`` in
    its slot."""
    xn, d = _nhwc(x), _dim(x, dim)
    shape = list(xn.shape)
    n = shape[d]
    shape[d] = n * k
    buf = xn.new_zeros(shape)
    buf.narrow(d, index * n, n).copy_(xn)
    dist.all_reduce(buf, group=group)
    COLLECTIVES["collectives"] += 1
    COLLECTIVES["bytes"] += buf.numel() * buf.element_size()
    return _nchw(buf)


def take(x: torch.Tensor, dim: int, k: int, index: int) -> torch.Tensor:
    """Slot ``index`` of ``k`` equal slots of ``x`` along ``dim``."""
    n = x.shape[dim] // k
    return x.narrow(dim, index * n, n)


class _Linear(torch.autograd.Function):
    """A linear map ``fwd`` whose backward is its partner ``adj``, applied
    through this same Function (so the backward has a backward: ``fwd``)."""

    @staticmethod
    def forward(ctx, x, fwd, adj):
        ctx.fns = (fwd, adj)
        return fwd(x)

    @staticmethod
    def backward(ctx, g):
        fwd, adj = ctx.fns
        return _Linear.apply(g, adj, fwd), None, None


def _identity(x):
    return x.view_as(x)


def _reduce_fn(x):
    return all_reduce(x, dp.axis_group())


def _gather_fn(dim):
    return lambda x: all_gather(x, dim, dp.axis_group(), dp.axis_size(),
                                dp.axis_index())


def _split_fn(dim):
    return lambda x: take(x, dim, dp.axis_size(), dp.axis_index())


def copy(x: torch.Tensor) -> torch.Tensor:
    """Identity forward, all-reduce backward: the input of a
    column-parallel layer, whose slices each give part of its gradient."""
    return _Linear.apply(x, _identity, _reduce_fn)


def reduce(x: torch.Tensor) -> torch.Tensor:
    """All-reduce forward, identity backward: a row-parallel layer's
    partial outputs summed."""
    return _Linear.apply(x, _reduce_fn, _identity)


def gather(x: torch.Tensor, dim: int) -> torch.Tensor:
    """All-gather forward along ``dim``, split backward."""
    return _Linear.apply(x, _gather_fn(dim), _split_fn(dim))


def scatter(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Split forward along ``dim`` (this rank's slot), all-gather
    backward."""
    return _Linear.apply(x, _split_fn(dim), _gather_fn(dim))


def full(t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """The whole tensor of which ``t`` is this rank's slice, when ``like``
    (its parameter) is sliced; ``t`` otherwise. Every rank of the axis
    group calls it."""
    if not (active() and sharded(like)):
        return t
    return all_gather(t.detach(), 0, dp.axis_group(), dp.axis_size(),
                      dp.axis_index())


def local_part(t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """This rank's slice of the whole tensor ``t`` when ``like`` (its
    parameter) is sliced; ``t`` otherwise."""
    if not (active() and sharded(like)):
        return t
    return take(t, 0, dp.axis_size(), dp.axis_index())


def sum_squares(grads, params) -> torch.Tensor:
    """The sum of squares of whole gradients from slices: the slices'
    part summed over the axis group, the unsliced counted once."""
    total = sum((torch.sum(g.float() ** 2) for g, p in zip(grads, params)
                 if not (active() and sharded(p))),
                torch.zeros((), device=grads[0].device))
    if active():
        part = sum((torch.sum(g.float() ** 2) for g, p in zip(grads, params)
                    if sharded(p)), torch.zeros((), device=grads[0].device))
        total = total + all_reduce(part, dp.axis_group())
    return total


@contextlib.contextmanager
def full_weights(*nets: torch.nn.Module):
    """Within the block every sliced parameter of ``nets`` holds the whole
    tensor (the summaries rank 0 computes alone under ``dp.local``); its
    slice again after. Every rank enters it."""
    if not active():
        yield
        return
    params = [p for net in nets for p in net.parameters() if sharded(p)]
    slices = [p.data for p in params]
    for p in params:
        p.data = full(p.data, p)
    try:
        yield
    finally:
        for p, s in zip(params, slices):
            p.data = s
