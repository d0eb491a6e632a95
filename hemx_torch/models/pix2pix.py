"""pix2pix, the image -> depth conditional GAN (counterpart of
``hemx.models.pix2pix``; reference: hem/models/pix2pix.py).

* G: the U-Net of :mod:`hemx_torch.models.networks` on the image rescaled
  to [-1, 1], one tanh depth channel; ``--noise`` sites, ``--dropout``
  (a keep-prob on d1-d3, 0 disables), BN on e2..eN under
  ``--batch_norm_gen`` and always on the decoder.
* D: the PatchGAN on (image, depth) concatenated, BN under
  ``--batch_norm_disc``; sigmoid cross-entropy on its patch logits.
* G's loss adds ``lambda * l1`` under ``--add_l1`` (hemx honours a
  non-default ``--lambda``); ``l1`` and ``rmse`` of the [0, 1]-rescaled
  depths are reported always.
* ``--n_disc_train`` critic substeps, then one generator substep, each on
  a fresh batch with fresh draws (:class:`ConditionalGanBase`);
  Normal(0, 0.02) initialisation throughout. The switch's optimizer
  (``--optimizer``) on each network.
"""

from __future__ import annotations

import torch

from hemx_torch.models.conditional import ConditionalGanBase
from hemx_torch.models.networks import SITES, PatchGAN, UNet
from hemx_torch.ops.losses import rmse


class Pix2Pix(ConditionalGanBase):
    name = "pix2pix"

    @staticmethod
    def arguments() -> dict:
        return {
            "--noise": dict(type=str, nargs="*", choices=list(SITES),
                            default=[],
                            help="Inject uniform noise into the generator at "
                                 "these points (pix2pix.py:44-49)."),
            "--dropout": dict(type=float, default=0,
                              help="Keep-prob for dropout on early decoder "
                                   "layers (0 disables)."),
            "--batch_norm_disc": dict(action="store_true", default=False),
            "--batch_norm_gen": dict(action="store_true", default=False),
            "--n_disc_train": dict(type=int, default=1),
            "--add_l1": dict(action="store_true", default=False,
                             help="Add lambda*L1 to the generator loss."),
            "--lambda": dict(type=float, default=10.0, dest="l1_lambda"),
        }

    def prepare(self, batch: dict) -> dict:
        return {"g_input": 2.0 * (batch["image"] - 0.5),
                "y": 2.0 * (batch["depth"] - 0.5)}

    def _build(self, image_shape, generator):
        a = self.args
        c, h, w = image_shape
        kw = dict(generator=generator, dtype=self.compute_dtype)
        return torch.nn.ModuleDict({
            "generator": UNet(image_shape, bn_gen=a.batch_norm_gen,
                              noise=a.noise or [],
                              dropout_keep=a.dropout or 0, **kw),
            "discriminator": PatchGAN((c + 1, h, w),
                                      bn_disc=a.batch_norm_disc, **kw)})

    def g_forward(self, G, prep, noise):
        return G(prep["g_input"], noise)

    def d_forward(self, D, prep, depth):
        return D(torch.cat([prep["g_input"], depth], dim=1))

    def extra_g_loss(self, g, prep):
        g01 = (g + 1.0) / 2.0
        y01 = (prep["y"] + 1.0) / 2.0
        l1 = torch.mean(torch.abs(y01 - g01))
        add = self.args.l1_lambda * l1 if self.args.add_l1 else None
        return add, {"l1": l1}

    def extra_losses(self, g, prep):
        return {"rmse": rmse((prep["y"] + 1.0) / 2.0, (g + 1.0) / 2.0)}
