"""Sampler GAN: conditional 65x65 RGB -> 31x31 depth (counterpart of
``hemx.models.sampler_gan``; reference: hem/models/sampler_gan.py).

* Image and depth rescaled to [-1, 1]; the depth center-cropped by
  ``round(65 * 0.4769) = 31`` (sampler_gan.py:86-91).
* G: the VALID U-Net with a uniform [-1, 1] noise channel on its input, a
  5x5 SAME tanh head at 31x31, ``--garch large`` adding the stride-1
  stages, ``--batch_norm_gen`` BN (the head's included); Xavier init.
* D (``--darch``): ``early`` or ``late`` two-path critic, ``--batch_norm_
  disc`` BN where the reference's scope applies it (``early``'s h3 without
  an activation; ``late``'s ha and hb with lrelu); normal(0.02) init.
* Sigmoid cross-entropy losses; ``rmse`` and ``l1`` reported on [0, 1]
  depths; ``--n_disc_train`` D steps then one G step per call; the
  optimizers from hemx's switch (``--optimizer``).
"""

from __future__ import annotations

import torch

from hemx_torch.models.conditional import ConditionalGanBase
from hemx_torch.models.depth_nets import TwoPathDisc, ValidUnet
from hemx_torch.ops.images import center_crop
from hemx_torch.ops.initializers import normal
from hemx_torch.ops.losses import rmse


class SamplerGan(ConditionalGanBase):
    name = "sampler_gan"

    @staticmethod
    def arguments() -> dict:
        return {
            "--batch_norm_disc": dict(action="store_true", default=False),
            "--batch_norm_gen": dict(action="store_true", default=False),
            "--garch": dict(default="large", choices=["small", "large"]),
            "--darch": dict(default="early", choices=["early", "late"]),
            "--n_disc_train": dict(type=int, default=1),
        }

    def prepare(self, batch):
        x = 2.0 * (batch["image"] - 0.5)
        y = center_crop(2.0 * (batch["depth"] - 0.5), 0.4769)
        return {"g_input": x, "y": y}

    def _build(self, image_shape, generator):
        a = self.args
        kw = dict(generator=generator, dtype=self.compute_dtype)
        return torch.nn.ModuleDict({
            "generator": ValidUnet(
                image_shape, noise_channel=True, garch=a.garch,
                use_batch_norm=a.batch_norm_gen, final_activation=torch.tanh,
                final_filter=5, **kw),
            "discriminator": TwoPathDisc(
                image_shape, variant=a.darch, use_batch_norm=a.batch_norm_disc,
                init=normal(0.02), **kw)})

    def d_forward(self, D, prep, depth):
        return D((prep["g_input"], depth))

    def extra_losses(self, g, prep):
        g01 = (g + 1.0) / 2.0
        y01 = (prep["y"] + 1.0) / 2.0
        return {"rmse": rmse(y01, g01), "l1": torch.mean(torch.abs(y01 - g01))}
