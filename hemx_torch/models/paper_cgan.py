"""Thesis experiment 1: the conditional GAN with mean-depth variants
(counterpart of ``hemx.models.paper_cgan``; reference:
hem/models/paper_cgan.py).

* Input prep: x = the 65x65 RGB patch as it is (not rescaled); depth ×10
  into meters, cropped by ``crop_to_bounding_box(17, 17, 29, 29)``; the
  per-image mean ``y_bar``.
* ``--model_version``: ``baseline`` (y_hat = G(x)); ``mean_adjusted``
  (y_hat = G(x) + y_bar, D sees depth - y_bar); ``mean_provided`` (G gets
  y_bar as a constant channel at e1, D's depth path gets it too);
  ``mean_provided2`` (G's input gains a constant ONES channel, the
  reference's bug kept, and D's rgb path gains y_bar).
* G: the VALID U-Net with a 1x1 linear head cropped 31 -> 29; D: the
  two-path ``paper`` critic.
* ``--training_version wgan``: ``optax.rmsprop(g_lr)`` at optax's defaults
  for G, ``optax.adam(d_lr)`` for D, both clipped to +-0.01, 5 critic
  steps per G step; ``gan``: Adam on each side with its own lr and betas,
  one critic step.
* Summaries add the Eigen metrics (inputs clipped at 1e-3, depths /10)
  of y_hat, y_0 (zeros for ``baseline``, y_bar otherwise) and, once
  ``mean_image`` is set (``hemx_torch.paper_train``), the dataset's mean
  depth image.
"""

from __future__ import annotations

import numpy as np
import torch

from hemx_torch.metrics.eigen import eigen_metrics
from hemx_torch.models.conditional import ConditionalGanBase, numpy_nhwc
from hemx_torch.models.depth_nets import TwoPathDisc, ValidUnet
from hemx_torch.ops.images import crop_to_bounding_box
from hemx_torch.ops.losses import rmse
from hemx_torch.train import optimizers as O


def paper_prepare(batch: dict) -> dict:
    """The paper models' prep: depth to meters, the 29x29 crop, the
    per-image mean ``y_bar`` (N, 1, 1, 1)."""
    y = crop_to_bounding_box(batch["depth"] * 10.0, 17, 17, 29, 29)
    return {"g_input": batch["image"], "y": y,
            "y_bar": torch.mean(y, dim=(1, 2, 3), keepdim=True)}


def ones_channel(x: torch.Tensor) -> torch.Tensor:
    """``x`` with a constant ones channel appended (``mean_provided2``)."""
    n, _, h, w = x.shape
    return torch.cat([x, torch.ones((n, 1, h, w), dtype=x.dtype,
                                    device=x.device)], dim=1)


def eigen_scalars(writer, step: int, y: np.ndarray, variants: dict,
                  targets: dict | None = None) -> None:
    """``metrics_<variant>/<metric>`` scalars of each prediction against
    ``y`` (or ``targets[variant]``), both clipped below at 1e-3."""
    for name, pred in variants.items():
        target = (targets or {}).get(name, y)
        m = eigen_metrics(np.clip(target, 1e-3, None),
                          np.clip(np.ascontiguousarray(pred), 1e-3, None))
        writer.scalars({f"metrics_{name}/{k}": float(v)
                        for k, v in m.items()}, step)


def mean_variants(y: np.ndarray, y_bar: np.ndarray, mean_image,
                  zero_baseline: bool) -> dict:
    """The reference predictors: y_0 (zeros, or the per-image mean) and,
    when set, the dataset's mean depth image."""
    out = {"y_0": np.zeros_like(y) if zero_baseline
           else np.broadcast_to(y_bar, y.shape)}
    if mean_image is not None:
        out["y_mean"] = np.broadcast_to(mean_image[None, :, :, None], y.shape)
    return out


class PaperCgan(ConditionalGanBase):
    name = "paper_cgan"

    @staticmethod
    def arguments() -> dict:
        return {
            "--g_lr": dict(type=float, default=1e-4),
            "--d_lr": dict(type=float, default=1e-4),
            "--g_beta1": dict(type=float, default=0.5),
            "--d_beta1": dict(type=float, default=0.5),
            "--g_beta2": dict(type=float, default=0.999),
            "--d_beta2": dict(type=float, default=0.999),
            "--model_version": dict(type=str, default="baseline",
                                    choices=["baseline", "mean_adjusted",
                                             "mean_provided", "mean_provided2"]),
            "--training_version": dict(type=str, default="gan",
                                       choices=["gan", "wgan"]),
        }

    #: the dataset's mean depth image (29x29, [0, 1]), set by paper_train
    mean_image = None

    @property
    def n_disc_train(self) -> int:
        return 5 if self.training_version == "wgan" else 1

    def g_transform(self):
        a = self.args
        if self.training_version == "wgan":
            return O.rmsprop(a.g_lr)
        return O.adam(a.g_lr, a.g_beta1, a.g_beta2)

    def d_transform(self):
        a = self.args
        if self.training_version == "wgan":
            return O.adam(a.d_lr)
        return O.adam(a.d_lr, a.d_beta1, a.d_beta2)

    def prepare(self, batch: dict) -> dict:
        prep = paper_prepare(batch)
        if self.args.model_version == "mean_provided2":
            x = prep["g_input"]
            prep["g_input"] = ones_channel(x)
            prep["d_x"] = torch.cat([x, prep["y_bar"].expand(
                x.shape[0], 1, x.shape[2], x.shape[3])], dim=1)
        return prep

    def _build(self, image_shape, generator):
        version = self.args.model_version
        c, h, w = image_shape
        kw = dict(generator=generator, dtype=self.compute_dtype)
        g_in = (c + (1 if version == "mean_provided2" else 0), h, w)
        return torch.nn.ModuleDict({
            "generator": ValidUnet(
                g_in, mean_at_e1=version == "mean_provided",
                final_activation=None, final_filter=1, final_crop=29, **kw),
            "discriminator": TwoPathDisc(
                image_shape, variant="paper",
                depth_extra_channels=int(version in ("mean_provided",
                                                     "mean_provided2")),
                rgb_extra_channels=int(version == "mean_provided2"), **kw)})

    def g_forward(self, G, prep, noise):
        version = self.args.model_version
        y_bar = prep["y_bar"] if version == "mean_provided" else None
        g, stats = G(prep["g_input"], noise.get("z"), y_bar=y_bar)
        return (g if version == "baseline" else g + prep["y_bar"]), stats

    def d_forward(self, D, prep, depth):
        version = self.args.model_version
        if version != "baseline":
            depth = depth - prep["y_bar"]
        if version in ("mean_provided", "mean_provided2"):
            depth = torch.cat([depth, prep["y_bar"].expand_as(depth)], dim=1)
        return D((prep.get("d_x", prep["g_input"]), depth))

    def extra_losses(self, g, prep):
        return {"rmse": rmse(prep["y"], g)}

    def depth_range(self):
        return (0.0, 10.0)

    def eigen_metrics_for(self, ts, batch) -> dict:
        """The Eigen suite of a batch on /10 meters (paper_metrics.py:12-35)."""
        g, prep = self.predict(ts, batch)
        return {k: float(v) for k, v in eigen_metrics(
            numpy_nhwc(prep["y"]) / 10.0, numpy_nhwc(g) / 10.0).items()}

    def write_summaries(self, writer, step, ts, batch) -> None:
        """The base montages and sampler scalars, then the Eigen scalars of
        y_hat, y_0 and y_mean (paper_cgan.py:175-177)."""
        super().write_summaries(writer, step, ts, batch)
        g, prep = self.predict(ts, batch)
        y = numpy_nhwc(prep["y"]) / 10.0
        y_bar = numpy_nhwc(prep["y_bar"]) / 10.0
        variants = {"y_hat": numpy_nhwc(g) / 10.0, **mean_variants(
            y, y_bar, self.mean_image,
            getattr(self.args, "model_version", "baseline") == "baseline")}
        eigen_scalars(writer, step, y, variants)
