"""Plain PyTorch building blocks of the references: TF's SAME convolution
and transposed convolution, batch norm over the batch, the initial weights
and optax's Adam. Imports torch alone, never the program.

A reference computes in the precision its configuration states
(:class:`Precision`): every product in ``dtype`` (None: float32) with TF32
as ``tf32`` says, rounded where hemx rounds (a product's operands cast to
its dtype, its bias cast to the product's dtype, a batch norm's statistics
in its input's dtype and float32 after its float32 offset). ``round``, the
control's lower precision, rounds every product's operands first, and the
gradients they pass back (:func:`fp8_e4m3`).
"""

from __future__ import annotations

import contextlib
import math
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F


class Precision(NamedTuple):
    """What a reference computes in: ``dtype`` of every product (None:
    its operands' float32), ``tf32`` for float32 products, ``round`` of
    every product's operands (None: none)."""
    dtype: Optional[torch.dtype] = None
    tf32: bool = False
    round: Optional[Callable] = None


def precision(cfg, round=None) -> Precision:
    """The precision the configuration's flags state: ``--dtype`` and
    ``--precision`` (TF32 unless ``highest``)."""
    f = cfg["flags"]
    return Precision(torch.bfloat16 if f.get("dtype") == "bfloat16" else None,
                     f.get("precision", "default") != "highest", round)


@contextlib.contextmanager
def tf32(on: bool):
    """TF32 in cuBLAS and cuDNN as ``on`` says, for the block."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def _fp8(x):
    amax = x.detach().abs().amax().float().clamp_min(1e-30)
    scale = 448.0 / amax
    return ((x * scale).to(torch.float8_e4m3fn).to(x.dtype)) / scale


class _RoundFp8(torch.autograd.Function):
    """float8 e4m3 rounding with a per-tensor scale (the tensor's largest
    magnitude mapped to e4m3's 448), of the value and of its gradient."""

    @staticmethod
    def forward(ctx, x):
        return _fp8(x)

    @staticmethod
    def backward(ctx, g):
        return _fp8(g)


def fp8_e4m3(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 (per-tensor scaled), in ``x``'s dtype;
    its gradient rounded the same way."""
    return _RoundFp8.apply(x)


def _operands(p: Precision, x, w):
    """A product's operands: both cast to the product's dtype (without
    one, ``x`` follows ``w``), then rounded."""
    x, w = x.to(p.dtype or w.dtype), w.to(p.dtype or w.dtype)
    if p.round is not None:
        x, w = p.round(x), p.round(w)
    return x, w


def same_pad(n: int, k: int, s: int) -> tuple[int, int]:
    """TF's SAME padding of one dimension: (before, after), the odd one
    after."""
    total = max((math.ceil(n / s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def conv(x, w, b, stride: int, p: Precision = Precision(), cast_bias=True):
    """TF's SAME conv2d of NCHW ``x`` with OIHW ``w``, plus ``b`` (cast to
    the product's dtype unless ``cast_bias`` is False)."""
    x, w = _operands(p, x, w)
    ph = same_pad(x.shape[2], w.shape[2], stride)
    pw = same_pad(x.shape[3], w.shape[3], stride)
    y = F.conv2d(F.pad(x, (pw[0], pw[1], ph[0], ph[1])), w, stride=stride)
    return y + (b.to(y.dtype) if cast_bias else b).view(1, -1, 1, 1)


def deconv(x, w, b, stride: int, p: Precision = Precision(),
           cast_bias=True):
    """TF's SAME conv2d_transpose to ``stride`` times the size: the
    gradient of a SAME conv2d on the output, i.e. the full transposed
    convolution with the conv's padding cut off. ``w`` is (in, out, kh,
    kw)."""
    x, w = _operands(p, x, w)
    oh, ow = x.shape[2] * stride, x.shape[3] * stride
    top = same_pad(oh, w.shape[2], stride)[0]
    left = same_pad(ow, w.shape[3], stride)[0]
    full = F.conv_transpose2d(x, w, stride=stride)
    y = full[:, :, top:top + oh, left:left + ow]
    return y + (b.to(y.dtype) if cast_bias else b).view(1, -1, 1, 1)


def dense(x, w, b, p: Precision = Precision()):
    """``x @ w.T + b``, ``w`` (out, in), the bias cast to the product's
    dtype."""
    x, w = _operands(p, x, w)
    y = F.linear(x, w)
    return y + b.to(y.dtype)


def batch_norm(x, beta, eps: float = 1e-3):
    """Normalised by the batch's mean and biased variance over every axis
    but the channels (each rounded once to ``x``'s dtype), plus the float32
    ``beta`` (no scale)."""
    dims = (0,) if x.dim() == 2 else (0, 2, 3)
    shape = (1, -1) if x.dim() == 2 else (1, -1, 1, 1)
    mean = x.mean(dims).view(shape)
    var = x.var(dims, correction=0).view(shape)
    return (x - mean) * torch.rsqrt(var + eps) + beta.view(shape)


def lrelu(x, leak: float = 0.2):
    """Leaky relu as hemx writes it, ``maximum(x, leak * x)``: at a tie
    (x = 0) the gradient is split between the two, 0.6, not 1 or 0.2."""
    return torch.maximum(x, leak * x)


def sigmoid_xent(z, labels):
    """``tf.nn.sigmoid_cross_entropy_with_logits`` in JAX's stable form,
    ``max(z, 0) - z * labels + log1p(exp(-|z|))``, with JAX's gradients at
    z = 0: the maximum's split between its arguments and ``|z|``'s slope
    1."""
    abs_z = torch.where(z >= 0, z, -z)
    return (torch.maximum(z, torch.zeros_like(z)) - z * labels
            + torch.log1p(torch.exp(-abs_z)))


def init_state(specs: list, seed: int, device) -> dict:
    """Initial tensors from ``seed``: ``specs`` lists ``(name, shape,
    init, trainable)`` with ``init`` one of ``("xavier", fan_in,
    fan_out)`` (uniform on +-sqrt(6 / (fan_in + fan_out))), ``("normal",
    std)``, ``("zeros",)`` or ``("ones",)``. The random ones are two draws on ``device`` (one
    uniform, one normal) cut into leaves; kernels are kept channels-last,
    as the inputs are (NHWC rows seen as NCHW)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(np.random.SeedSequence(
        [seed % 2 ** 64, 1]).generate_state(1, np.uint64)[0]))
    sizes = {k: sum(math.prod(s) for _, s, i, _ in specs if i[0] == k)
             for k in ("xavier", "normal")}
    flat = {"xavier": torch.rand(sizes["xavier"], generator=gen,
                                 device=device),
            "normal": torch.randn(sizes["normal"], generator=gen,
                                  device=device)}
    offset = {"xavier": 0, "normal": 0}
    out = {}
    for name, shape, init, _ in specs:
        kind, n = init[0], math.prod(shape)
        if kind in flat:
            t = flat[kind][offset[kind]:offset[kind] + n].view(shape)
            offset[kind] += n
            if kind == "xavier":
                limit = math.sqrt(6.0 / (init[1] + init[2]))
                t = t * (2.0 * limit) - limit
            else:
                t = t * init[1]
        else:
            t = (torch.zeros if kind == "zeros" else torch.ones)(
                shape, device=device)
        out[name] = (t.contiguous(memory_format=torch.channels_last)
                     if t.dim() == 4 else t.clone())
    return out


class Adam:
    """optax's ``adam(lr, b1, b2)`` (eps 1e-8 outside the root) over a
    dict of leaves: ``mu``, ``nu`` and ``count`` as optax keeps them."""

    def __init__(self, params: dict, lr: float, b1: float, b2: float,
                 eps: float = 1e-8):
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.mu = {k: torch.zeros_like(v) for k, v in params.items()}
        self.nu = {k: torch.zeros_like(v) for k, v in params.items()}
        self.count = 0

    @torch.no_grad()
    def step(self, params: dict, grads: dict) -> None:
        self.count += 1
        c1 = 1.0 - self.b1 ** self.count
        c2 = 1.0 - self.b2 ** self.count
        for k, g in grads.items():
            self.mu[k] = self.b1 * self.mu[k] + (1.0 - self.b1) * g
            self.nu[k] = self.b2 * self.nu[k] + (1.0 - self.b2) * g * g
            params[k] -= self.lr * (self.mu[k] / c1) / (
                torch.sqrt(self.nu[k] / c2) + self.eps)


def optimizers(cfg, specs: list, params: dict) -> dict:
    """One :class:`Adam` per network over its trainable leaves, with the
    configuration's ``lr``, ``beta1`` and ``beta2``."""
    f = cfg["flags"]
    hyper = (float(f["lr"]), float(f["beta1"]), float(f["beta2"]))
    return {net: Adam({k: params[k] for k, _, _, trainable in specs
                       if trainable and k.startswith(net + ".")}, *hyper)
            for net in ("generator", "discriminator")}


def normalize_u8(rows: torch.Tensor) -> torch.Tensor:
    """uint8 NHWC rows as float32 NCHW on [0, 1]."""
    return rows.permute(0, 3, 1, 2).float() * (1.0 / 255.0)
