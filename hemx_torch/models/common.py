"""Shared training-state machinery (counterpart of ``hemx.models.common``).

The train state holds what ``hemx``'s dict pytree holds — ``params`` and
``mstate`` (the parameters and BN buffers of ``nets``; ``hemx_torch.convert``
turns them into ``hemx``'s pytrees), ``opt``, ``step`` and the random
source — but as live PyTorch objects that the train call updates in
place. ``step`` increments once per train call (critic substeps
keep it fixed), as in ``hemx``.

Random numbers: JAX's threefry key chain cannot be reproduced in PyTorch,
so noise comes from the state's own ``torch.Generator`` unless the caller
passes it in (the noise seam of ``IwganModel.train``); equality tests
draw it with ``jax.random`` and hand it over.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn as nn


@dataclasses.dataclass
class TrainState:
    nets: nn.ModuleDict
    opt: dict
    step: int
    rng: torch.Generator


def new_train_state(nets: nn.ModuleDict, opt: dict, seed: int,
                    device: torch.device) -> TrainState:
    rng = torch.Generator(device=device)
    rng.manual_seed(seed)
    return TrainState(nets=nets, opt=opt, step=0, rng=rng)


def draw_noise(ts: TrainState, batch: int, latent: int, *,
               alpha: bool) -> dict:
    """One substep's noise from the state's generator: ``z`` (B, latent)
    standard normal, plus the GP's ``alpha`` (B, 1) uniform for a critic
    substep (``hemx/models/gan.py:229-231,254,289-291``)."""
    dev = ts.rng.device
    out = {"z": torch.randn((batch, latent), generator=ts.rng, device=dev)}
    if alpha:
        out["alpha"] = torch.rand((batch, 1), generator=ts.rng, device=dev)
    return out


class Unflatten(nn.Module):
    """(B, h*w*c) -> (B, c, h, w), reading the flat vector in NHWC order
    like ``hemx.models.common.unflatten``; the result is channels_last in
    memory."""

    def __init__(self, h: int, w: int, c: int):
        super().__init__()
        self.hwc = (h, w, c)

    def forward(self, x):
        return x.reshape((x.shape[0],) + self.hwc).permute(0, 3, 1, 2), {}
