"""Parameter initializers (counterpart of ``hemx.ops.initializers``).

Every variable — biases included — is Xavier-uniform with TF's fan rules,
as in the reference, except where a model asks for ``normal(stddev)``
(``sampler_gan``'s critic). Shapes are given in the JAX/TF layout (HWIO conv,
``[H, W, out, in]`` deconv, ``[in, out]`` dense) so the fans are computed
exactly as ``hemx`` computes them; layers permute the draw into the torch
layout. Draws come from an explicit ``torch.Generator`` (JAX's threefry
bits cannot be reproduced, so equality tests load JAX-initialized weights
through ``hemx_torch.convert`` instead).
"""

from __future__ import annotations

import math

import torch


def _fans(shape) -> tuple[float, float]:
    """Fan-in/out following TF variance_scaling_initializer rules."""
    if len(shape) == 0:
        return 1.0, 1.0
    if len(shape) == 1:
        # TF treats 1-D shapes (biases) as fan_in == fan_out == shape[0].
        return float(shape[0]), float(shape[0])
    if len(shape) == 2:
        return float(shape[0]), float(shape[1])
    receptive = 1.0
    for d in shape[:-2]:
        receptive *= d
    return receptive * shape[-2], receptive * shape[-1]


def xavier_uniform(shape, *, generator: torch.Generator) -> torch.Tensor:
    """Glorot/Xavier uniform float32: U(-limit, limit),
    limit = sqrt(6/(fan_in+fan_out)), drawn on the generator's device."""
    fan_in, fan_out = _fans(shape)
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    u = torch.rand(tuple(shape), generator=generator, device=generator.device)
    return u * (2.0 * limit) - limit


def normal(stddev: float = 0.02):
    """An initializer drawing ``stddev * N(0, 1)`` float32."""
    def init(shape, *, generator: torch.Generator) -> torch.Tensor:
        return stddev * torch.randn(tuple(shape), generator=generator,
                                    device=generator.device)
    return init
