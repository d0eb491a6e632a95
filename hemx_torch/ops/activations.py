"""Activation functions (counterpart of ``hemx.ops.activations``)."""

from __future__ import annotations

import torch


def lrelu(x: torch.Tensor, leak: float = 0.2) -> torch.Tensor:
    """Leaky ReLU, default leak 0.2, written as ``maximum(x, leak*x)`` like
    ``hemx`` (not ``F.leaky_relu``) so the gradient at a tie matches."""
    return torch.maximum(x, leak * x)


def value_fraction(x: torch.Tensor, value: float = 0.0) -> torch.Tensor:
    """Fraction of entries equal to ``value``, as float32 (``hemx``'s
    ``value_fraction``; the ``--g_sparsity`` term)."""
    return torch.mean((x == value).float())
