"""Activation functions (counterpart of ``hemx.ops.activations``)."""

from __future__ import annotations

import torch

# SELU constants: hemx's, the paper values (Klambauer et al. 2017)
_SELU_ALPHA = 1.6732632423543772848170429916717
_SELU_SCALE = 1.0507009873554804934193349852946


def lrelu(x: torch.Tensor, leak: float = 0.2) -> torch.Tensor:
    """Leaky ReLU, default leak 0.2, written as ``maximum(x, leak*x)`` like
    ``hemx`` (not ``F.leaky_relu``) so the gradient at a tie matches."""
    return torch.maximum(x, leak * x)


def selu(x: torch.Tensor) -> torch.Tensor:
    """Scaled exponential linear unit (``hemx.ops.activations.selu``). The
    negative branch clamps its input at 0 before ``expm1``: unclamped,
    expm1 overflows to inf for x >~ 88.7 in float32 in the branch ``where``
    does not select, and the gradient there is 0 * inf = NaN."""
    safe = torch.clamp(x, max=0.0)
    return _SELU_SCALE * torch.where(x >= 0.0, x,
                                     _SELU_ALPHA * torch.expm1(safe))


def value_fraction(x: torch.Tensor, value: float = 0.0) -> torch.Tensor:
    """Fraction of entries equal to ``value``, as float32 (``hemx``'s
    ``value_fraction``; the ``--g_sparsity`` term)."""
    return torch.mean((x == value).float())
