"""InfoGAN on image -> depth (counterpart of ``hemx.models.info_gan``;
reference: hem/models/info_gan.py, which hemx made a working model).

* G(x, z): x (the image in [-1, 1]) with one uniform [0, 1) z channel
  concatenated; SAME 5x5 stride-2 convs 64-512 with lrelu 0.2, then
  mirrored SAME deconvs 256, 128, 64 (lrelu) and 1 (tanh) back to the
  input size.
* D(depth): six SAME 5x5 stride-2 convs (64, 128, 256, 512, 256, 1), lrelu
  then a sigmoid score.
* Q(depth): a 1x1 conv to 3 channels with tanh.
* Losses: ``d_loss = -mean(log(d_real + eps) + log((1 - d_fake) + eps))``,
  ``g_loss = -mean(log(d_fake + eps))``, and Q's mutual-information term
  ``cross_entropy + entropy`` exactly as hemx writes it (``:213-220``).
* Three optimizers of hemx's switch (``{"g", "d", "q"}``, Q's over the
  predictor and the generator). A call runs the D, G and Q steps, each
  on a fresh batch with its own z; only Q's step adds 1 to ``step``.

Normal(0, 0.02) initialisation, no BN. Noise: hemx draws z from each
step's key itself (not a ``Ctx`` split); the port draws one z per step
from the call's seeded generator, or takes the seam's ``noise`` (a list of
three ``{"z": (N, 1, H, W)}``).
"""

from __future__ import annotations

import torch
import torch.nn as nn

from hemx_torch.models import common
from hemx_torch.models.conditional import draw_noise
from hemx_torch.models.depth_nets import DepthNet, Uniform, check_draws
from hemx_torch.models.plugin import ModelPlugin
from hemx_torch.ops import initializers
from hemx_torch.ops.activations import lrelu
from hemx_torch.ops.losses import guarded_one_minus
from hemx_torch.train.optimizers import Optimizer, make_transform

EPS = 1e-8


class Generator(DepthNet):
    def __init__(self, in_shape, *, generator: torch.Generator, dtype=None):
        super().__init__(initializers.normal(0.02), generator, dtype)
        cin = in_shape[0] + 1  # the z channel
        for i, ch in enumerate((64, 128, 256, 512, 256, 128, 64, 1)):
            (self.add_conv if i < 4 else self.add_deconv)(f"g{i+1}", 5, cin,
                                                          ch)
            cin = ch
        self.done()

    def noise_draws(self, n, h, w):
        return {"z": Uniform((n, 1, h, w), 0.0, 1.0)}

    def forward(self, x, z):
        n, _, h, w = x.shape
        check_draws(self, {"z": z}, n, h, w)
        stats, y = {}, torch.cat([x, z], dim=1)
        sizes = [y.shape[2]]
        for i in range(4):
            y = self.conv(f"g{i+1}", y, 2, "SAME", lrelu, False, stats)
            sizes.append(y.shape[2])
        for i in range(4):
            y = self.deconv(f"g{i+5}", y, sizes[3 - i], 2, "SAME",
                            torch.tanh if i == 3 else lrelu, False, stats)
        return y, stats


class Discriminator(DepthNet):
    CHANNELS = (64, 128, 256, 512, 256, 1)

    def __init__(self, *, generator: torch.Generator, dtype=None):
        super().__init__(initializers.normal(0.02), generator, dtype)
        cin = 1
        for i, ch in enumerate(self.CHANNELS):
            self.add_conv(f"d{i+1}", 5, cin, ch)
            cin = ch
        self.done()

    def forward(self, y):
        stats, last = {}, len(self.CHANNELS) - 1
        for i in range(last + 1):
            y = self.conv(f"d{i+1}", y, 2, "SAME",
                          torch.sigmoid if i == last else lrelu, False, stats)
        return y, stats


class Predictor(DepthNet):
    def __init__(self, *, generator: torch.Generator, dtype=None):
        super().__init__(initializers.normal(0.02), generator, dtype)
        self.add_conv("q1", 1, 1, 3)
        self.done()

    def forward(self, y):
        return self.conv("q1", y, 1, "SAME", torch.tanh, False, {}), {}


def scaled(batch: dict):
    return 2.0 * (batch["image"] - 0.5), 2.0 * (batch["depth"] - 0.5)


def d_loss_of(d_real, d_fake):
    return -torch.mean(torch.log(d_real + EPS)
                       + torch.log(guarded_one_minus(d_fake) + EPS))


def g_loss_of(d_fake):
    return -torch.mean(torch.log(d_fake + EPS))


def mutual_information(x, q):
    """Q's loss: ``cross_entropy + entropy`` of the [0, 1]-rescaled image
    and Q's prediction, summed over channels, averaged over the rest."""
    x01 = (x + 1.0) / 2.0
    q01 = (q + 1.0) / 2.0
    cross_entropy = torch.mean(-torch.sum(torch.log(q01 + EPS) * x01, dim=1))
    entropy = torch.mean(-torch.sum(torch.log(x01 + EPS) * x01, dim=1))
    return cross_entropy + entropy


class InfoGan(ModelPlugin):
    name = "info_gan"
    batch_keys = ("image", "depth")

    def _build(self, image_shape, generator):
        kw = dict(generator=generator, dtype=self.compute_dtype)
        return nn.ModuleDict({"generator": Generator(image_shape, **kw),
                              "discriminator": Discriminator(**kw),
                              "predictor": Predictor(**kw)})

    def init_state(self, image_shape, seed: int) -> common.TrainState:
        nets = self.build_nets(image_shape, seed)
        tx = make_transform(self.args)
        q_nets = nn.ModuleDict({"predictor": nets["predictor"],
                                "generator": nets["generator"]})
        return common.new_train_state(
            nets, {"g": Optimizer(nets["generator"], tx),
                   "d": Optimizer(nets["discriminator"], tx),
                   "q": Optimizer(q_nets, tx)}, seed)

    def n_substeps(self) -> int:
        return 3

    def batches_per_train_call(self) -> int:
        return 3

    @staticmethod
    def _step(opt: Optimizer, loss) -> None:
        opt.step(torch.autograd.grad(loss, list(opt.params.values())))

    def d_step(self, ts, batch, z) -> dict:
        N = ts.nets
        x, y = scaled(batch)
        with torch.no_grad():
            g, _ = N["generator"](x, z)
        d_loss = d_loss_of(N["discriminator"](y)[0],
                           N["discriminator"](g)[0])
        self._step(ts.opt["d"], d_loss)
        return {"d_loss": d_loss.detach()}

    def g_step(self, ts, batch, z) -> dict:
        N = ts.nets
        x, _ = scaled(batch)
        g, _ = N["generator"](x, z)
        g_loss = g_loss_of(N["discriminator"](g)[0])
        self._step(ts.opt["g"], g_loss)
        return {"g_loss": g_loss.detach()}

    def q_step(self, ts, batch, z) -> dict:
        N = ts.nets
        x, _ = scaled(batch)
        g, _ = N["generator"](x, z)
        q_loss = mutual_information(x, N["predictor"](g)[0])
        self._step(ts.opt["q"], q_loss)
        ts.step += 1
        return {"q_loss": q_loss.detach()}

    def train(self, ts: common.TrainState, stream, noise=None):
        """One call: the D, G and Q steps; ``noise``: optional list of three
        ``{"z": NCHW tensor}`` replacing the call's draws."""
        if noise is not None and len(noise) != 3:
            raise ValueError(f"noise must hold 3 substeps, got {len(noise)}")
        gen = (common.generator(ts, common.TRAIN, self.device)
               if noise is None else None)
        metrics = {}
        for i, step in enumerate((self.d_step, self.g_step, self.q_step)):
            batch = next(stream)
            z = (draw_noise(ts.nets["generator"], gen, batch["image"])["z"]
                 if noise is None else common.seam(noise[i], self.device)["z"])
            metrics.update(step(ts, batch, z))
        return ts, metrics

    @torch.no_grad()
    def eval_losses(self, ts: common.TrainState, batch: dict,
                    noise=None) -> dict:
        N = ts.nets
        x, y = scaled(batch)
        z = (draw_noise(N["generator"],
                        common.generator(ts, common.EVAL, self.device),
                        x)["z"] if noise is None
             else common.seam(noise, self.device)["z"])
        g, _ = N["generator"](x, z)
        d_fake = N["discriminator"](g)[0]
        return {"g_loss": g_loss_of(d_fake),
                "d_loss": d_loss_of(N["discriminator"](y)[0], d_fake)}
