"""The thesis ``paper_*`` family (counterpart of
``hemx.models.paper_family``; reference: hem/models/paper_sampler.py,
paper_noise.py, paper_baseline_sampler.py, paper_standalone.py,
paper_baseline_standalone.py).

All share paper_cgan's prep (depth ×10 meters, the (17, 17, 29, 29) crop,
the per-image mean ``y_bar``) and the VALID 65 -> 31 -> 14 -> 5 -> 1
generator with a 1x1 linear head cropped to 29x29.

* ``paper_sampler``: experiment 2, a mean-adjusted cGAN whose generator
  takes uniform [0, 1) noise at ``--noise_layer`` (``x``, ``e1``-``e4``,
  ``e4-512``, ``d2``-``d4``) with optional encoder BN (``--e_bn``); one D
  step and one G step per call; Adam with separate lr and betas; summaries
  add the Eigen scalars of y_hat, y_0 (= y_bar), y_mean and the sampler
  path (paper_sampler.py:304-342).
* ``paper_noise``: the same with input noise only.
* ``paper_baseline_sampler``: paper_cgan without noise, ``gan`` only,
  versions baseline / mean_adjusted / mean_provided, Adam.
* ``paper_standalone``: no critic; one Adam over G; loss
  ``rmse(y / 10, y_hat / 10)``; eval and predict as hemx's
  ``Ctx(training=False)``, which for these nets (no BN) changes nothing.
* ``paper_baseline_standalone``: the standalone model's baseline and
  mean_adjusted versions.
"""

from __future__ import annotations

import numpy as np
import torch

from hemx_torch.models import common
from hemx_torch.models.conditional import ConditionalGanBase, numpy_nhwc
from hemx_torch.models.depth_nets import (NOISE_SITES, NoiseSiteGenerator,
                                          TwoPathDisc, ValidUnet)
from hemx_torch.models.paper_cgan import (PaperCgan, eigen_scalars,
                                          mean_variants, ones_channel,
                                          paper_prepare)
from hemx_torch.models.plugin import ModelPlugin
from hemx_torch.ops.images import colorize
from hemx_torch.ops.layers import commit_moving_stats
from hemx_torch.ops.losses import rmse
from hemx_torch.train import optimizers as O


def _adam_args() -> dict:
    return {
        "--g_lr": dict(type=float, default=1e-4),
        "--d_lr": dict(type=float, default=1e-4),
        "--g_beta1": dict(type=float, default=0.5),
        "--d_beta1": dict(type=float, default=0.9),
        "--g_beta2": dict(type=float, default=0.999),
        "--d_beta2": dict(type=float, default=0.999),
    }


class _AdamBothSides:
    """Adam on each side with its own lr and betas."""

    def g_transform(self):
        a = self.args
        return O.adam(a.g_lr, a.g_beta1, a.g_beta2)

    def d_transform(self):
        a = self.args
        return O.adam(a.d_lr, a.d_beta1, a.d_beta2)


class PaperSampler(_AdamBothSides, ConditionalGanBase):
    name = "paper_sampler"

    @staticmethod
    def arguments() -> dict:
        return {**_adam_args(),
                "--noise_layer": dict(type=str, choices=NOISE_SITES,
                                      default="x"),
                "--e_bn": dict(action="store_true", default=False)}

    #: the dataset's mean depth image (29x29, [0, 1]), set by paper_train
    mean_image = None
    noise_layer = None  # --noise_layer unless a subclass fixes it

    @property
    def n_disc_train(self) -> int:
        return 1  # one D step, one G step (paper_sampler.py:154-157)

    def prepare(self, batch):
        return paper_prepare(batch)

    def _build(self, image_shape, generator):
        a = self.args
        kw = dict(generator=generator, dtype=self.compute_dtype)
        site = self.noise_layer or getattr(a, "noise_layer", "x")
        e_bn = False if self.noise_layer else getattr(a, "e_bn", False)
        return torch.nn.ModuleDict({
            "generator": NoiseSiteGenerator(image_shape, noise_layer=site,
                                            e_bn=e_bn, **kw),
            "discriminator": TwoPathDisc(image_shape, variant="paper", **kw)})

    def transform_g(self, g, prep):
        return g + prep["y_bar"]  # mean-adjusted (paper_sampler.py:96-98)

    def d_forward(self, D, prep, depth):
        return D((prep["g_input"], depth - prep["y_bar"]))

    def extra_losses(self, g, prep):
        return {"rmse": rmse(prep["y"], g)}

    def depth_range(self):
        return (0.0, 10.0)

    def write_summaries(self, writer, step, ts, batch) -> None:
        super().write_summaries(writer, step, ts, batch)
        g, prep = self.predict(ts, batch)
        g_s, prep_s = self.sample(ts, batch)
        y = numpy_nhwc(prep["y"]) / 10.0
        y_bar = numpy_nhwc(prep["y_bar"]) / 10.0
        variants = {"y_hat": numpy_nhwc(g) / 10.0,
                    **mean_variants(y, y_bar, self.mean_image, False),
                    "y_sampler": numpy_nhwc(g_s) / 10.0}
        eigen_scalars(writer, step, y, variants,
                      {"y_sampler": numpy_nhwc(prep_s["y"]) / 10.0})


class PaperNoise(PaperSampler):
    """Ablation: input-noise-only mean-adjusted cGAN (paper_noise.py)."""
    name = "paper_noise"
    noise_layer = "x"

    @staticmethod
    def arguments() -> dict:
        return {**_adam_args(),
                "--model_version": dict(type=str, default="baseline",
                                        choices=["baseline"])}


class PaperBaselineSampler(_AdamBothSides, PaperCgan):
    """The no-noise GAN baseline (paper_baseline_sampler.py)."""
    name = "paper_baseline_sampler"
    training_version = "gan"

    @staticmethod
    def arguments() -> dict:
        return {**_adam_args(),
                "--model_version": dict(type=str, default="baseline",
                                        choices=["baseline", "mean_adjusted",
                                                 "mean_provided"])}


class PaperStandalone(ModelPlugin):
    """Supervised generator, no critic: RMSE on /10 meters
    (paper_standalone.py). The train state's ``nets`` is the generator and
    ``opt`` its one Adam, so hemx's tree has no ``generator`` level."""
    name = "paper_standalone"
    VERSIONS = ["baseline", "mean_adjusted", "mean_provided", "mean_provided2"]
    batch_keys = ("image", "depth")

    @staticmethod
    def arguments() -> dict:
        return {"--g_lr": dict(type=float, default=1e-4),
                "--g_beta1": dict(type=float, default=0.5),
                "--g_beta2": dict(type=float, default=0.999),
                "--model_version": dict(
                    type=str, default="baseline",
                    choices=PaperStandalone.VERSIONS)}

    mean_image = None

    def _build(self, image_shape, generator):
        version = self.args.model_version
        c, h, w = image_shape
        return ValidUnet((c + (version == "mean_provided2"), h, w),
                         mean_at_e1=version == "mean_provided",
                         final_activation=None, final_filter=1,
                         final_crop=29, generator=generator,
                         dtype=self.compute_dtype)

    def init_state(self, image_shape, seed: int) -> common.TrainState:
        nets = self.build_nets(image_shape, seed)
        a = self.args
        return common.new_train_state(
            nets, O.Optimizer(nets, O.adam(a.g_lr, a.g_beta1, a.g_beta2)),
            seed)

    def prepare(self, batch: dict) -> dict:
        prep = paper_prepare(batch)
        if self.args.model_version == "mean_provided2":
            prep["g_input"] = ones_channel(prep["g_input"])
        return prep

    def _forward(self, net, prep):
        version = self.args.model_version
        y_bar = prep["y_bar"] if version == "mean_provided" else None
        g, stats = net(prep["g_input"], y_bar=y_bar)
        return (g if version == "baseline" else g + prep["y_bar"]), stats

    @staticmethod
    def _loss(y, y_hat):
        return rmse(y / 10.0, y_hat / 10.0)

    def depth_range(self):
        """G outputs are meters in [0, 10] (the prep scales depth ×10)."""
        return (0.0, 10.0)

    def train(self, ts: common.TrainState, stream):
        """One supervised step on one batch."""
        prep = self.prepare(next(stream))
        y_hat, stats = self._forward(ts.nets, prep)
        loss = self._loss(prep["y"], y_hat)
        grads = torch.autograd.grad(loss, list(ts.nets.parameters()))
        ts.opt.step(grads)
        commit_moving_stats(ts.nets, stats)
        ts.step += 1
        metrics = {"rmse": loss.detach()}
        if getattr(self.args, "check_numerics", False):
            metrics["grad_finite"] = common.grad_finite_report("", ts.nets,
                                                               grads)
        return ts, metrics

    @torch.no_grad()
    def eval_losses(self, ts: common.TrainState, batch: dict) -> dict:
        prep = self.prepare(batch)
        return {"rmse": self._loss(prep["y"], self._forward(ts.nets, prep)[0])}

    @torch.no_grad()
    def predict(self, ts: common.TrainState, batch: dict):
        prep = self.prepare(batch)
        return self._forward(ts.nets, prep)[0], prep

    def write_summaries(self, writer, step, ts, batch) -> None:
        """Image, real and fake depth montages and the Eigen scalars of
        y_hat, y_0 and y_mean (paper_standalone.py)."""
        y_hat, prep = self.predict(ts, batch)
        n = min(getattr(self.args, "examples", 64), y_hat.shape[0])
        y = numpy_nhwc(prep["y"]) / 10.0
        y_bar = numpy_nhwc(prep["y_bar"]) / 10.0
        pred = numpy_nhwc(y_hat) / 10.0
        x = numpy_nhwc(batch["image"])[:n]
        writer.montage("model/images", np.clip(x, 0, 1), step)
        writer.montage("model/real_depths", colorize(np.clip(y, 0, 1)[:n]),
                       step)
        writer.montage("model/fake_depths", colorize(np.clip(pred, 0, 1)[:n]),
                       step)
        eigen_scalars(writer, step, y, {"y_hat": pred, **mean_variants(
            y, y_bar, self.mean_image,
            getattr(self.args, "model_version", "baseline") == "baseline")})


class PaperBaselineStandalone(PaperStandalone):
    """The supervised RMSE-only baseline (paper_baseline_standalone.py)."""
    name = "paper_baseline_standalone"

    @staticmethod
    def arguments() -> dict:
        return {"--g_lr": dict(type=float, default=1e-4),
                "--g_beta1": dict(type=float, default=0.5),
                "--g_beta2": dict(type=float, default=0.999),
                "--model_version": dict(type=str, default="baseline",
                                        choices=["baseline", "mean_adjusted"])}
