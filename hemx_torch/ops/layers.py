"""Layers of the BASELINE models (counterpart of ``hemx.ops.layers``).

Tensors are NCHW logically and ``torch.channels_last`` in memory, so cuDNN
runs its NHWC kernels. Parameter names follow the ``hemx`` pytree (``w``,
``b``, BN ``beta`` under ``bn`` for dense and ``norm0`` for conv/deconv;
BN buffers ``mean`` and ``var``) so ``hemx_torch.convert`` is a rename plus
the layout permutes below. Every layer's ``forward`` returns
``(y, stats)``: ``stats`` maps a BN module's name (relative to the
returning module) to its new moving ``(mean, var)``; ``BatchNorm`` itself
returns ``(y, (mean, var))``. Nothing writes a
buffer inside ``forward``; the caller commits the stats it keeps with
:func:`commit_moving_stats` (the IWGAN critic step runs G and discards
them, ``hemx/models/gan.py:236``).

Hazards reproduced from ``hemx`` (each gives right shapes, wrong values):

* SAME conv padding is asymmetric (``lo = total // 2`` on top/left); it
  is applied with ``F.pad`` before an unpadded conv.
* ``conv_transpose2d`` with ``padding=lo`` crops ``lo`` from both sides of
  the full transpose; the extra ``hi - lo`` rows/cols are cropped after.
* BN is hand-written: decay 0.999, eps 1e-3, beta only, batch statistics,
  and the moving variance is the *biased* one.

Compute dtype (``--dtype bfloat16``): hemx rounds at fixed points instead of
autocasting, and the port rounds at the same ones. The dtype is a
constructor argument of each layer (hemx keeps it in a process global,
``hemx.ops.layers.set_compute_dtype``):

* conv, deconv and dense cast their input and weight to it
  (``_cast_in``, ``hemx/ops/layers.py:78-83``); the product comes out in it
  (bf16 with f32 accumulation), and the bias is added after being cast to
  the product's dtype (``:399-401,451,509``);
* BN's batch mean and variance of a bf16 input are bf16 and the
  normalized value stays bf16 until ``+ beta`` (f32) promotes it: a layer
  with BN outputs f32, one without outputs bf16; the moving stats are f32
  (``:274-300``).

Autocast would keep BN and reductions in f32 and fuse the bias into the
conv, which rounds elsewhere. Parameters (master weights) stay f32.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from hemx_torch.ops.initializers import xavier_uniform
from hemx_torch.parallel import dp, sp, tp

CL = torch.channels_last


def set_precision(name: str) -> None:
    """``--precision``: 'default' and 'high' let cuBLAS and cuDNN use TF32
    for float32; 'highest' keeps full float32 (the counterpart of
    ``hemx.ops.layers.set_default_precision``)."""
    if name not in ("default", "high", "highest"):
        raise ValueError(f"unknown precision '{name}'")
    tf32 = name != "highest"
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32


def same_padding(in_dim: int, k: int, s: int) -> tuple[int, int]:
    """XLA/TF SAME padding (lo, hi) for one spatial dim."""
    total = max((math.ceil(in_dim / s) - 1) * s + k - in_dim, 0)
    return total // 2, total - total // 2


def cast_in(x: torch.Tensor, w: torch.Tensor, dtype: Optional[torch.dtype]):
    """``hemx.ops.layers._cast_in``: under a compute dtype both operands go
    to it; otherwise ``x`` follows ``w``'s dtype. A cast of a sliced
    kernel stays marked sliced (``tp.mark``)."""
    if dtype is not None:
        return x.to(dtype), tp.mark(w.to(dtype), w)
    if x.dtype != w.dtype:
        return x.to(w.dtype), w
    return x, w


def conv2d_op(x: torch.Tensor, w: torch.Tensor, stride: int,
              padding: str = "SAME") -> torch.Tensor:
    """SAME or VALID conv of NCHW ``x`` with OIHW ``w``
    (``hemx.ops.layers.conv2d_op``). A kernel sliced over the model axis
    runs column-parallel, a band of a spatial axis with its halo rows
    (``hemx_torch.parallel.tp``, ``sp``)."""
    if tp.active() and tp.sharded(w):
        return tp.gather(_conv2d(tp.copy(x), w, stride, padding), 1)
    if sp.banded():
        return sp.conv2d(x, w, stride, padding)
    return _conv2d(x, w, stride, padding)


def _conv2d(x, w, stride, padding):
    if padding == "SAME":
        kh, kw = w.shape[2:]
        ph = same_padding(x.shape[2], kh, stride)
        pw = same_padding(x.shape[3], kw, stride)
        if any(ph + pw):
            x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]))
    elif padding != "VALID":
        raise ValueError(f"unknown padding '{padding}'")
    return F.conv2d(x, w, stride=stride)


def deconv_check(h: int, wd: int, w: torch.Tensor, out_hw: tuple[int, int],
                 stride: int, padding: str) -> None:
    """Refuse an ``out_hw`` outside TF's legal range for the padding (see
    :func:`deconv2d_op`)."""
    kh, kw = w.shape[2:]
    oh, ow = out_hw
    for axis, i_dim, o_dim, k_dim in (("H", h, oh, kh), ("W", wd, ow, kw)):
        if padding == "SAME":
            lo, hi = (i_dim - 1) * stride + 1, i_dim * stride
        elif padding == "VALID":
            lo, hi = (i_dim - 1) * stride + k_dim, i_dim * stride + k_dim - 1
        else:
            raise ValueError(f"unknown padding '{padding}'")
        if not lo <= o_dim <= hi:
            raise ValueError(
                f"deconv2d_op: output {axis}={o_dim} is not a valid {padding} "
                f"conv2d_transpose size for input {i_dim}, kernel {k_dim}, "
                f"stride {stride} (legal: {lo}..{hi})")


def deconv2d_op(x: torch.Tensor, w: torch.Tensor, out_hw: tuple[int, int],
                stride: int, padding: str = "SAME") -> torch.Tensor:
    """Transposed conv matching ``tf.nn.conv2d_transpose`` with SAME or
    VALID padding (``hemx.ops.layers.deconv2d_op``); ``w`` is torch's
    (in, out, kh, kw). ``out_hw`` must lie in TF's legal range for the
    padding: SAME ``(in-1)*s+1 .. in*s``, VALID ``(in-1)*s+k .. in*s+k-1``.
    A size beyond the full transpose (a VALID 5 -> 14 at k5 s2, whose
    transpose is 13) gets zero rows and columns at the bottom and right, as
    hemx pads them before the bias: ``output_padding`` adds them. A kernel
    sliced over the model axis (its input channels) runs row-parallel, a
    band of a spatial axis with its halo rows."""
    if tp.active() and tp.sharded(w):
        return tp.reduce(_deconv2d(tp.scatter(x, 1), w, out_hw, stride,
                                   padding))
    if sp.banded():
        return sp.deconv2d(x, w, out_hw, stride, padding)
    return _deconv2d(x, w, out_hw, stride, padding)


def _deconv2d(x, w, out_hw, stride, padding):
    kh, kw = w.shape[2:]
    h, wd = x.shape[2:]
    oh, ow = out_hw
    deconv_check(h, wd, w, out_hw, stride, padding)
    pad_h = (h - 1) * stride + kh - oh
    pad_w = (wd - 1) * stride + kw - ow
    extra = (max(-pad_h, 0), max(-pad_w, 0))
    lo_h, lo_w = max(pad_h, 0) // 2, max(pad_w, 0) // 2
    y = F.conv_transpose2d(x, w, stride=stride, padding=(lo_h, lo_w),
                           output_padding=extra)
    return y[:, :, :oh, :ow]


def linear_op(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w.T`` (``w`` torch's (out, in)); column-parallel when ``w`` is
    sliced over the model axis."""
    if tp.active() and tp.sharded(w):
        return tp.gather(F.linear(tp.copy(x), w), 1)
    return F.linear(x, w)


def commit_moving_stats(net: nn.Module, stats: dict) -> None:
    """Write the BN moving stats a forward returned into ``net``'s buffers."""
    with torch.no_grad():
        for name, (mean, var) in stats.items():
            bn = net.get_submodule(name)
            bn.mean.copy_(mean)
            bn.var.copy_(var)


class BatchNorm(nn.Module):
    """Batch norm over every axis but channels: (B, F) -> axis 0, NCHW ->
    (0, 2, 3). TF contrib defaults (decay 0.999, eps 1e-3, center only).
    In a process group the statistics (and so the moving ones) are the
    global batch's, reduced differentiably over the ranks holding distinct
    rows or bands (``dp.batch_group``)."""

    DECAY = 0.999
    EPS = 1e-3

    def __init__(self, channels: int):
        super().__init__()
        self.beta = nn.Parameter(torch.zeros(channels))
        self.register_buffer("mean", torch.zeros(channels))
        self.register_buffer("var", torch.ones(channels))

    def forward(self, x: torch.Tensor):
        dims = (0,) if x.dim() == 2 else (0, 2, 3)
        shape = (1, -1) if x.dim() == 2 else (1, -1, 1, 1)
        if dp.active():
            # the global batch's statistics, as hemx's sharded jit takes
            # them: the mean, then the mean of the centred squares, each
            # summed in float32 and rounded once to x's dtype, as x.mean
            # and x.var round
            n = x.numel() // x.shape[1] * dp.batch_group()[1]
            f32 = torch.float32
            mean = (dp.global_sum(x.sum(dims, dtype=f32)) / n).to(x.dtype)
            centred = x - mean.view(shape)
            var = (dp.global_sum((centred * centred).sum(dims, dtype=f32))
                   / n).to(x.dtype)
        else:
            mean = x.mean(dims)
            var = x.var(dims, correction=0)
        y = (x - mean.view(shape)) * torch.rsqrt(var.view(shape) + self.EPS)
        y = y + self.beta.view(shape)
        with torch.no_grad():
            new_mean = self.DECAY * self.mean + (1.0 - self.DECAY) * mean
            new_var = self.DECAY * self.var + (1.0 - self.DECAY) * var
        return y, (new_mean, new_var)


class _Layer(nn.Module):
    """Shared post-op chain of the parameterized layers: bias -> BN ->
    activation (``hemx.ops.layers`` order)."""

    norm_name = "norm0"

    def _post(self, y: torch.Tensor, bias_shape):
        y = y + self.b.view(bias_shape).to(y.dtype)
        stats = {}
        norm = getattr(self, self.norm_name, None)
        if norm is not None:
            y, s = norm(y)
            stats = {self.norm_name: s}
        if self.activation is not None:
            y = self.activation(y)
        return y, stats


class Dense(_Layer):
    """Fully connected layer; ``w`` is torch's (out, in)."""

    norm_name = "bn"

    def __init__(self, in_features: int, out_features: int, *,
                 generator: torch.Generator, use_batch_norm: bool = False,
                 activation: Optional[Callable] = None,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.compute_dtype = dtype
        w = xavier_uniform((in_features, out_features), generator=generator)
        self.w = nn.Parameter(w.t().contiguous())
        self.b = nn.Parameter(xavier_uniform((out_features,), generator=generator))
        if use_batch_norm:
            self.bn = BatchNorm(out_features)
        self.activation = activation

    def forward(self, x):
        y = linear_op(*cast_in(x, self.w, self.compute_dtype))
        return self._post(y, (1, -1))


class Conv2d(_Layer):
    """SAME conv; ``w`` is OIHW (from ``hemx``'s HWIO by permute(3,2,0,1))."""

    def __init__(self, in_ch: int, out_ch: int, k: int, stride: int, *,
                 generator: torch.Generator, use_batch_norm: bool = False,
                 activation: Optional[Callable] = None,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.compute_dtype = dtype
        w = xavier_uniform((k, k, in_ch, out_ch), generator=generator)
        self.w = nn.Parameter(w.permute(3, 2, 0, 1).contiguous(memory_format=CL))
        self.b = nn.Parameter(xavier_uniform((out_ch,), generator=generator))
        self.stride = stride
        if use_batch_norm:
            self.norm0 = BatchNorm(out_ch)
        self.activation = activation

    def forward(self, x):
        y = conv2d_op(*cast_in(x, self.w, self.compute_dtype), self.stride)
        return self._post(y, (1, -1, 1, 1))


class Deconv2d(_Layer):
    """SAME transposed conv doubling H and W (v1 semantics); ``w`` is
    torch's (in, out, kh, kw), from ``hemx``'s ``[H, W, out, in]`` by
    permute(3,2,0,1) — both are true transposes, no flip."""

    def __init__(self, in_ch: int, out_ch: int, k: int, stride: int, *,
                 generator: torch.Generator, use_batch_norm: bool = False,
                 activation: Optional[Callable] = None,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.compute_dtype = dtype
        w = xavier_uniform((k, k, out_ch, in_ch), generator=generator)
        self.w = nn.Parameter(w.permute(3, 2, 0, 1).contiguous(memory_format=CL))
        self.b = nn.Parameter(xavier_uniform((out_ch,), generator=generator))
        self.stride = stride
        if use_batch_norm:
            self.norm0 = BatchNorm(out_ch)
        self.activation = activation

    def forward(self, x):
        out_hw = (sp.height(x) * self.stride, x.shape[3] * self.stride)
        x, w = cast_in(x, self.w, self.compute_dtype)
        y = deconv2d_op(x, w, out_hw, self.stride)
        return self._post(y, (1, -1, 1, 1))


class Flatten(nn.Module):
    """(B, C, H, W) -> (B, H*W*C) in NHWC order, like ``hemx``'s flatten of
    an NHWC tensor (the dense weights that follow depend on the order).
    Bands of a spatial axis are gathered to whole height first."""

    def forward(self, x):
        if sp.banded():
            x = sp.gather(x)
            sp.leave()
        return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1), {}


class Sequential(nn.Module):
    """Named layers applied in order; collects every child's BN stats under
    the child's name (``hemx.core.sequential``). With a ``capture`` dict,
    each child's output is also stored there under the child's name (the
    ``Ctx(capture=True)`` intermediates of ``hemx.core``); a nested
    Sequential's children land under ``<child>/<name>``, before the child's
    own output."""

    def __init__(self, layers: dict):
        super().__init__()
        for name, layer in layers.items():
            self.add_module(name, layer)

    def forward(self, x, capture: Optional[dict] = None):
        stats = {}
        for name, layer in self.named_children():
            if capture is not None and isinstance(layer, Sequential):
                inner = {}
                x, s = layer(x, inner)
                capture.update({f"{name}/{k}": v for k, v in inner.items()})
            else:
                x, s = layer(x)
            stats.update({f"{name}.{k}": v for k, v in s.items()})
            if capture is not None:
                capture[name] = x
        return x, stats
