"""Losses of the BASELINE models, the IWGAN gradient penalty and the depth
models' losses (counterpart of ``hemx.ops.losses``).

The log guards keep the reference's order: ``1 - p`` first, then ``+ eps``
(``eps + (1 - p)``), so a sigmoid output of exactly 0 or 1 gives a finite
loss. hemx pins ``1 - p`` behind ``lax.optimization_barrier`` because XLA
would fold ``eps + (1 - p)`` into ``(eps + 1) - p``; eager PyTorch evaluates
in the written order and needs no barrier. Do not ``torch.compile`` these
functions: a compiler may reassociate the sum the same way.

In a process group, what hemx reduces over the global batch beyond a
per-sample mean is reduced over the ranks (``hemx_torch.parallel.dp``):
the sum-reduced VAE losses, the mean under ``rmse``'s root and the GP's
whole-batch norm.
"""

from __future__ import annotations

from typing import Callable

import torch

from hemx_torch.parallel import dp


def guarded_one_minus(p: torch.Tensor) -> torch.Tensor:
    """``1 - p``, for a log guard written ``log(guarded_one_minus(p) + eps)``
    (``hemx.ops.losses.guarded_one_minus``). hemx hides ``1 - p`` behind an
    optimization barrier so XLA cannot fold the sum into ``(1 + eps) - p``;
    eager PyTorch adds in the written order, so ``p == 1`` gives
    ``log(eps)``, not ``-inf``."""
    return 1.0 - p


def l1_loss(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Mean absolute error (reference: models/cnn.py:75-79)."""
    return torch.mean(torch.abs(x - y))


def l2_loss(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return torch.mean((x - y) ** 2)


def bernoulli_recon_loss(x: torch.Tensor, x_hat: torch.Tensor,
                         eps: float = 1e-8) -> torch.Tensor:
    """Sum-reduced Bernoulli reconstruction loss (reference:
    models/vae.py:75-79); the second guard is ``eps + (1 - x_hat)``."""
    ll = x * torch.log(eps + x_hat) + (1.0 - x) * torch.log(eps + (1.0 - x_hat))
    return -dp.global_sum(torch.sum(ll))


def kl_gaussian_loss(z_mean: torch.Tensor, z_stddev: torch.Tensor,
                     eps: float = 1e-8) -> torch.Tensor:
    """Sum-reduced KL(q || N(0, 1)) in the reference's stddev-head
    parameterization (reference: models/vae.py:81-83)."""
    term = (torch.square(z_mean) + torch.square(z_stddev)
            - torch.log(eps + torch.square(z_stddev)) - 1.0)
    return 0.5 * dp.global_sum(torch.sum(term))


def gan_g_loss(d_fake: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Non-saturating generator loss -E[log D(G(z))] over sigmoid outputs
    (reference: models/gan.py:195)."""
    return torch.mean(-torch.log(d_fake + eps))


def gan_d_loss(d_real: torch.Tensor, d_fake: torch.Tensor,
               eps: float = 1e-8) -> torch.Tensor:
    """Discriminator log loss (reference: models/gan.py:196); the fake
    term is ``log((1 - d_fake) + eps)``."""
    return torch.mean(-torch.log(d_real + eps)
                      - torch.log((1.0 - d_fake) + eps))


def wgan_g_loss(d_fake: torch.Tensor) -> torch.Tensor:
    """Wasserstein generator loss (reference: models/gan.py:198)."""
    return -torch.mean(d_fake)


def wgan_d_loss(d_real: torch.Tensor, d_fake: torch.Tensor) -> torch.Tensor:
    """Wasserstein critic loss (reference: models/gan.py:199)."""
    return torch.mean(d_fake) - torch.mean(d_real)


def sigmoid_xent(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """``tf.nn.sigmoid_cross_entropy_with_logits`` in its stable form,
    elementwise: ``max(z, 0) - z * labels + log1p(exp(-|z|))``. At z = 0
    the gradient is JAX's: ``torch.maximum`` splits the tie in halves, and
    ``|z|`` is written as a select whose slope there is 1, as ``jnp.abs``'s
    is (``torch.abs``'s is 0)."""
    abs_z = torch.where(logits >= 0, logits, -logits)
    return (torch.maximum(logits, torch.zeros_like(logits)) - logits * labels
            + torch.log1p(torch.exp(-abs_z)))


def rmse(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Root mean squared error (reference: hem/ops/losses.py:10-11)."""
    return torch.sqrt(dp.global_mean((a - b) ** 2))


def rmse_scale_invariant(x: torch.Tensor, x_hat: torch.Tensor) -> torch.Tensor:
    """The reference's scale-invariant RMSE, ``0.5 * (rmse(x, x_hat) +
    mean(x_hat - x))`` in linear space (hem/ops/losses.py:14-15), not
    Eigen et al.'s log-space form (``hemx_torch.metrics.eigen``)."""
    return 0.5 * (rmse(x, x_hat) + torch.mean(x_hat - x))


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
        slopes = torch.sqrt(dp.global_sum(torch.sum(grads ** 2)))
    return torch.mean((slopes - 1.0) ** 2)
