"""pix2pix's networks: the U-Net generator and the PatchGAN critic
(counterpart of ``hemx.models.networks``; reference:
hem/models/pix2pix.py:160-262).

* :class:`UNet`: 4x4 SAME stride-2 convs with lrelu 0.2 halve a square
  power-of-two input down to 1x1 (the stage count is log2 of its size;
  channels double from ``base`` and cap at ``max_filters``), then 4x4 SAME
  stride-2 deconvs with relu double it back, each followed by the
  concatenation of the encoder output of the same size; the last deconv
  gives one channel through tanh. BN: on e2..eN under ``bn_gen``, and
  always on every decoder layer, the final one before tanh included.
* Noise sites (``noise``): ``input`` concatenates one uniform [-1, 1)
  channel onto the input, ``latent`` a block as wide as the bottleneck
  onto it (d1 takes 1,024 channels at 256 px), ``end`` one channel onto
  the last deconv's input. ``dropout_keep`` > 0 is a keep-prob: on d1-d3,
  after the activation and before the skip concatenation, ``where(mask,
  h / keep, 0)``. Every kernel is 4x4, every weight drawn from
  Normal(0, 0.02), as pix2pix builds them.
* :class:`PatchGAN`: four 4x4 SAME stride-2 convs (64-512, lrelu 0.2) and a
  1-channel 4x4 stride-2 conv of logits; sizes halve rounding up (8x8
  logits at 256 px). BN under ``bn_disc`` on m2..m5, the logits conv m5
  included.

Parameters have hemx's flat names (``e{i}_w``, ``e{i}_b``, ``e{i}_bn``,
``d{i}_*``, ``m{i}_*`` and the ``_`` buffer) on :class:`DepthNet`'s
layouts. The draws of a forward (:meth:`UNet.noise_draws`) come in hemx's
order: ``z_input``, ``z_latent``, the keep masks ``keep_d1``-``keep_d3``,
``z_end``. Unlike the depth nets, these add the float32 bias to a product
uncast, as hemx's do: under a bf16 compute dtype the sum is float32.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch

from hemx_torch.models.depth_nets import (DepthNet, Keep, Uniform,
                                          check_draws)
from hemx_torch.ops import initializers
from hemx_torch.ops.activations import lrelu

SITES = ("input", "latent", "end")
K = 4  # every conv and deconv kernel is 4x4
N_DROPOUT = 3  # dropout on d1-d3
INIT = initializers.normal(0.02)  # hemx's normal_init at pix2pix's stddev


def unet_stages(h: int, w: int) -> int:
    """The U-Net's stage count for an h x w input, refused as hemx refuses
    it (``networks.py:76-78``) unless square and a power of two."""
    if h != w:
        raise ValueError(f"unet requires square inputs, got {h}x{w}")
    n = int(math.log2(h))
    if 2 ** n != h:
        raise ValueError(f"unet requires power-of-2 size, got {h}")
    return n


class _UncastBias(DepthNet):
    """The product + bias -> BN -> activation chain with the bias added
    uncast, as ``networks.py`` writes it (``conv2d_op(...) + b``)."""

    def _post(self, name, y, activation, bn, stats):
        y = y + getattr(self, f"{name}_b").view(1, -1, 1, 1)
        if bn:
            y, stats[f"{name}_bn"] = getattr(self, f"{name}_bn")(y)
        return activation(y) if activation is not None else y


class UNet(_UncastBias):
    """``hemx.models.networks.unet``; ``forward(x, noise)`` with ``noise``
    the draws :meth:`noise_draws` names (``{}`` when there are none)."""

    def __init__(self, in_shape, *, base: int = 64, max_filters: int = 512,
                 bn_gen: bool = False, noise: Sequence[str] = (),
                 dropout_keep: float = 0.0, generator: torch.Generator,
                 dtype: Optional[torch.dtype] = None):
        super().__init__(INIT, generator, dtype)
        c, h, w = in_shape
        self.n_down = n = unet_stages(h, w)
        self.noise, self.dropout_keep = tuple(noise), dropout_keep
        self.n_dropout = min(N_DROPOUT, n - 1)
        self.bn_gen = bn_gen
        enc = [min(base * 2 ** i, max_filters) for i in range(n)]
        cin = c + ("input" in self.noise)
        for i, cout in enumerate(enc):
            self.add_conv(f"e{i+1}", K, cin, cout)
            if bn_gen and i > 0:  # no BN on the first conv
                self.add_bn(f"e{i+1}", cout)
            cin = cout
        cin = enc[-1] * (2 if "latent" in self.noise else 1)
        self.dec_channels = []
        for i in range(n):
            from_end = n - 1 - i
            last = i == n - 1
            cout = 1 if last else min(base * 2 ** (from_end - 1), max_filters)
            if last and "end" in self.noise:
                cin += 1
            self.add_deconv(f"d{i+1}", K, cin, cout)
            self.add_bn(f"d{i+1}", cout)
            if not last:
                cin = cout + enc[from_end - 1]
            self.dec_channels.append(cout)
        self.bottleneck = enc[-1]
        self.done()

    def noise_draws(self, n, h, w):
        draws = {}
        if "input" in self.noise:
            draws["z_input"] = Uniform((n, 1, h, w), -1.0, 1.0)
        if "latent" in self.noise:
            draws["z_latent"] = Uniform((n, self.bottleneck, 1, 1), -1.0, 1.0)
        if self.dropout_keep > 0 and self.training:
            for i in range(self.n_dropout):
                side = h >> (self.n_down - 1 - i)  # d{i+1}'s output
                draws[f"keep_d{i+1}"] = Keep(
                    (n, self.dec_channels[i], side, side), self.dropout_keep)
        if "end" in self.noise:
            draws["z_end"] = Uniform((n, 1, h // 2, w // 2), -1.0, 1.0)
        return draws

    def forward(self, x, noise=None):
        noise = noise or {}
        n, _, h, w = x.shape
        draws = check_draws(self, noise, n, h, w)
        stats = {}
        if "input" in self.noise:
            x = torch.cat([x, noise["z_input"]], dim=1)
        skips, y = [], x
        for i in range(self.n_down):
            y = self.conv(f"e{i+1}", y, 2, "SAME", lrelu, self.bn_gen and i > 0,
                          stats)
            skips.append(y)
        if "latent" in self.noise:
            y = torch.cat([y, noise["z_latent"]], dim=1)
        for i in range(self.n_down):
            last = i == self.n_down - 1
            if last and "end" in self.noise:
                y = torch.cat([y, noise["z_end"]], dim=1)
            y = self.deconv(f"d{i+1}", y, y.shape[2] * 2, 2, "SAME",
                            torch.tanh if last else torch.relu, True, stats)
            if not last:
                if f"keep_d{i+1}" in draws:
                    y = torch.where(noise[f"keep_d{i+1}"], y / self.dropout_keep,
                                    0.0)
                y = torch.cat([y, skips[self.n_down - 2 - i]], dim=1)
        return y, stats


class PatchGAN(_UncastBias):
    """``hemx.models.networks.patchgan``: per-patch logits of an NCHW
    input (pix2pix: the image and a depth map concatenated)."""

    def __init__(self, in_shape, channels: Sequence[int] = (64, 128, 256, 512),
                 *, bn_disc: bool = False, generator: torch.Generator,
                 dtype: Optional[torch.dtype] = None):
        super().__init__(INIT, generator, dtype)
        self.n_convs, self.bn_disc = len(channels), bn_disc
        cin = in_shape[0]
        for i, cout in enumerate(channels):
            self.add_conv(f"m{i+1}", K, cin, cout)
            if bn_disc and i > 0:
                self.add_bn(f"m{i+1}", cout)
            cin = cout
        k = len(channels) + 1
        self.add_conv(f"m{k}", K, cin, 1)
        if bn_disc:
            self.add_bn(f"m{k}", 1)
        self.done()

    def forward(self, x):
        stats, y = {}, x
        for i in range(self.n_convs):
            y = self.conv(f"m{i+1}", y, 2, "SAME", lrelu,
                          self.bn_disc and i > 0, stats)
        y = self.conv(f"m{self.n_convs + 1}", y, 2, "SAME", None, self.bn_disc,
                      stats)
        return y, stats
