"""WGAN losses and the IWGAN gradient penalty (counterpart of
``hemx.ops.losses``)."""

from __future__ import annotations

from typing import Callable

import torch


def wgan_g_loss(d_fake: torch.Tensor) -> torch.Tensor:
    """Wasserstein generator loss (reference: models/gan.py:198)."""
    return -torch.mean(d_fake)


def wgan_d_loss(d_real: torch.Tensor, d_fake: torch.Tensor) -> torch.Tensor:
    """Wasserstein critic loss (reference: models/gan.py:199)."""
    return torch.mean(d_fake) - torch.mean(d_real)


def gradient_penalty(d_apply: Callable[[torch.Tensor], torch.Tensor],
                     x_real: torch.Tensor, x_fake: torch.Tensor,
                     alpha: torch.Tensor, *,
                     per_sample: bool = False) -> torch.Tensor:
    """IWGAN gradient penalty (``hemx.ops.losses.gradient_penalty``).

    By default ``slopes = sqrt(sum(grad**2))`` over the WHOLE batch (the
    reference's quirk, a scalar); ``per_sample=True`` takes the IWGAN
    paper's per-sample norm. The input gradient is built with
    ``create_graph=True`` so the penalty differentiates into ``d_apply``'s
    weights (the double backward).
    """
    a = alpha.reshape((-1,) + (1,) * (x_real.dim() - 1))
    interp = x_real + a * (x_fake - x_real)
    if not interp.requires_grad:
        interp.requires_grad_(True)
    grads, = torch.autograd.grad(d_apply(interp).sum(), interp,
                                 create_graph=True)
    if per_sample:
        slopes = torch.sqrt(torch.sum(grads.reshape(grads.shape[0], -1) ** 2,
                                      dim=1))
    else:
        slopes = torch.sqrt(torch.sum(grads ** 2))
    return torch.mean((slopes - 1.0) ** 2)
