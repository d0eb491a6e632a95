"""Supervised per-image mean-depth estimator (counterpart of
``hemx.models.mean_depth_estimator``; reference:
hem/models/mean_depth_estimator.py).

* E2 stack: six 5x5 stride-2 SAME relu convs (64, 128, 256, 512, 1024,
  2048; SAME pads asymmetrically on odd sizes, 53 -> 27 -> 14 -> 7 -> 4 ->
  2 -> 1), an NHWC flatten, dense 2048 (linear), dense 1 with sigmoid.
* Input: ``x_full`` / ``y_full`` when the batch has them (NYUv2's
  ``--include_originals``), else ``image`` / ``depth``; the networks are
  built for that input's shape.
* Loss ``mean(sqrt(square(mean_depth - m)))``, kept as written (its
  gradient at 0 is not ``abs``'s); metrics ``m_loss`` and ``m_grad_norm``.
  One optimizer from hemx's switch over the whole net; one step per call.
* :meth:`MeanDepthEstimator.predict_mean` gives the (B, 1) estimates that
  ``experimental_sampler`` conditions on.
"""

from __future__ import annotations

import numpy as np
import torch

from hemx_torch.models import common
from hemx_torch.models.plugin import ModelPlugin
from hemx_torch.ops.images import colorize
from hemx_torch.ops.layers import Conv2d, Dense, Flatten, Sequential
from hemx_torch.train.optimizers import init_optimizer

CHANNELS = (64, 128, 256, 512, 1024, 2048)


def x_y(batch: dict):
    """(input, target depth): the full-frame keys when present."""
    return (batch.get("x_full", batch.get("image")),
            batch.get("y_full", batch.get("depth")))


class MeanDepthEstimator(ModelPlugin):
    name = "mean_depth_estimator"
    batch_keys = ("image", "depth", "x_full", "y_full")

    @staticmethod
    def arguments() -> dict:
        return {
            "--m_arch": dict(type=str, default="E2",
                             help="Estimator architecture (E2 only, like the "
                                  "reference)."),
        }

    def input_shape(self, host_batch: dict) -> tuple:
        h, w, c = x_y(host_batch)[0].shape[1:]
        return (c, h, w)

    def _build(self, image_shape, generator):
        c, h, w = image_shape
        kw = dict(generator=generator, dtype=self.compute_dtype)
        layers, cin = {}, c
        for i, ch in enumerate(CHANNELS):
            layers[f"l{i+1}"] = Conv2d(cin, ch, 5, 2, activation=torch.relu,
                                       **kw)
            cin, h, w = ch, -(-h // 2), -(-w // 2)
        layers["flatten"] = Flatten()
        layers["l7"] = Dense(h * w * cin, 2048, **kw)
        layers["l8"] = Dense(2048, 1, activation=torch.sigmoid, **kw)
        return Sequential(layers)

    def init_state(self, image_shape, seed: int) -> common.TrainState:
        nets = self.build_nets(image_shape, seed)
        return common.new_train_state(nets, init_optimizer(self.args, nets),
                                      seed)

    @staticmethod
    def loss(m: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        mean_depth = torch.mean(y, dim=(1, 2, 3))[:, None]
        return torch.mean(torch.sqrt(torch.square(mean_depth - m)))

    def train(self, ts: common.TrainState, stream):
        x, y = x_y(next(stream))
        params = list(ts.nets.parameters())
        m, _ = ts.nets(x)
        loss = self.loss(m, y)
        grads = torch.autograd.grad(loss, params)
        ts.opt.step(grads)
        ts.step += 1
        metrics = {"m_loss": loss.detach(),
                   "m_grad_norm": common.grad_norm(grads, ts.nets)}
        if getattr(self.args, "check_numerics", False):
            metrics["grad_finite"] = common.grad_finite_report("", ts.nets,
                                                               grads)
        return ts, metrics

    @torch.no_grad()
    def eval_losses(self, ts: common.TrainState, batch: dict) -> dict:
        x, y = x_y(batch)
        return {"m_loss": self.loss(ts.nets(x)[0], y)}

    @torch.no_grad()
    def predict_mean(self, ts: common.TrainState, batch: dict) -> torch.Tensor:
        """Per-image predicted mean depth, (B, 1) float32."""
        return ts.nets(x_y(batch)[0])[0].float()

    def write_summaries(self, writer, step: int, ts: common.TrainState,
                        batch: dict) -> None:
        """Input, depth, and true and predicted mean-depth montages
        (``mean_depth_estimator.py:134-149``)."""
        x, y = x_y(batch)
        n = min(getattr(self.args, "examples", 64), x.shape[0])
        m = self.predict_mean(ts, batch)[:n].cpu().numpy()
        x_host = common.nhwc(x[:n]).float().cpu().numpy()
        y_host = common.nhwc(y[:n]).float().cpu().numpy()
        writer.montage("model/real_images", np.clip(x_host, 0, 1), step)
        writer.montage("model/real_depths", colorize(y_host), step)
        real_means = y_host.mean(axis=(1, 2, 3))
        writer.montage("model/real_average_depths",
                       np.broadcast_to(real_means[:, None, None, None],
                                       (n, 8, 8, 1)).copy(), step)
        writer.montage("model/predicted_average_depths",
                       np.broadcast_to(m[:, :, None, None],
                                       (n, 8, 8, 1)).copy(), step)
