"""'Artist': a shared encoder with two decoders, the image x_hat and the
depth y_hat (counterpart of ``hemx.models.artist``; reference:
hem/models/artist.py).

* Encoder: VALID 5x5 stride-2 convs with channels 6, 12, 24, 48, 192, 384,
  BN and lrelu 0.2 on all but the first; the stage count follows the
  input (256 -> 126 -> 61 -> 29 -> 13 -> 5 -> 1; 65 -> 31 -> 14 -> 5 -> 1).
* Decoders mirror it with VALID deconvs (BN and lrelu, the last tanh
  without BN) back to the input size; 61 -> 126 and 126 -> 256 (65 px:
  5 -> 14) are one past the full transpose, a bias-only last row and
  column.
* Losses: MSE of the [0, 1]-rescaled tensors, and ``y_hat_rmse``.
* Two optimizers of hemx's switch, each call two substeps on fresh
  batches: the y step first updates the encoder and the y decoder and
  leaves ``step``; the x step updates the x decoder alone and adds 1 to
  ``step``. Each step keeps the BN moving stats of all three nets from its
  forward, so the x step moves the encoder's stats but not its weights.
* Summaries: montages of x, y (jet), x_hat and y_hat (jet).

Xavier-uniform initialisation (``hemx.models.depth_nets._P``); optimizer
state ``{"x": {"x_decoder"}, "y": {"encoder", "y_decoder"}}``.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn

from hemx_torch.models import common
from hemx_torch.models.depth_nets import DepthNet
from hemx_torch.models.plugin import ModelPlugin
from hemx_torch.ops.activations import lrelu
from hemx_torch.ops.images import colorize
from hemx_torch.ops.initializers import xavier_uniform
from hemx_torch.ops.layers import commit_moving_stats
from hemx_torch.parallel import dp
from hemx_torch.train.optimizers import Optimizer, make_transform

CHANNELS = (6, 12, 24, 48, 192, 384)


def chain(size: int) -> list[int]:
    """[size, then each VALID 5x5 stride-2 stage's output], at most six
    stages, stopping below 5 (``artist.py:35-39``)."""
    sizes = [size]
    while sizes[-1] >= 5 and len(sizes) <= len(CHANNELS):
        sizes.append((sizes[-1] - 5) // 2 + 1)
    return sizes


class Encoder(DepthNet):
    def __init__(self, in_shape, *, generator: torch.Generator, dtype=None):
        super().__init__(xavier_uniform, generator, dtype)
        cin = in_shape[0]
        self.n_layers = len(chain(in_shape[1])) - 1
        for i in range(self.n_layers):
            self.add_conv(f"e{i+1}", 5, cin, CHANNELS[i])
            if i > 0:
                self.add_bn(f"e{i+1}", CHANNELS[i])
            cin = CHANNELS[i]
        self.done()

    def forward(self, x):
        stats, h = {}, x
        for i in range(self.n_layers):
            h = self.conv(f"e{i+1}", h, 2, "VALID", lrelu, i > 0, stats)
        return h, stats


class Decoder(DepthNet):
    def __init__(self, out_channels: int, image_size: int, *,
                 generator: torch.Generator, dtype=None):
        super().__init__(xavier_uniform, generator, dtype)
        self.sizes = chain(image_size)
        n = self.n_layers = len(self.sizes) - 1
        cin = CHANNELS[n - 1]
        for i in range(n):
            last = i == n - 1
            cout = out_channels if last else CHANNELS[n - 2 - i]
            self.add_deconv(f"d{i+1}", 5, cin, cout)
            if not last:
                self.add_bn(f"d{i+1}", cout)
            cin = cout
        self.done()

    def forward(self, x):
        stats, h, n = {}, x, self.n_layers
        for i in range(n):
            last = i == n - 1
            h = self.deconv(f"d{i+1}", h, self.sizes[n - 1 - i], 2, "VALID",
                            torch.tanh if last else lrelu, not last, stats)
        return h, stats


def scaled(batch: dict):
    """(x, y): image and depth rescaled to [-1, 1]."""
    return 2.0 * (batch["image"] - 0.5), 2.0 * (batch["depth"] - 0.5)


def mse01(a: torch.Tensor, a_hat: torch.Tensor) -> torch.Tensor:
    """MSE of two [-1, 1] tensors rescaled to [0, 1]."""
    return torch.mean(((a + 1) / 2 - (a_hat + 1) / 2) ** 2)


class Artist(ModelPlugin):
    name = "artist"
    batch_keys = ("image", "depth")

    def _build(self, image_shape, generator):
        c, h, _ = image_shape
        kw = dict(generator=generator, dtype=self.compute_dtype)
        return nn.ModuleDict({"encoder": Encoder(image_shape, **kw),
                              "x_decoder": Decoder(c, h, **kw),
                              "y_decoder": Decoder(1, h, **kw)})

    def init_state(self, image_shape, seed: int) -> common.TrainState:
        nets = self.build_nets(image_shape, seed)

        def over(*names):
            return Optimizer(nn.ModuleDict({n: nets[n] for n in names}),
                             make_transform(self.args))
        return common.new_train_state(
            nets, {"x": over("x_decoder"), "y": over("encoder", "y_decoder")},
            seed)

    @staticmethod
    def _commit(nets, *stats) -> None:
        for name, s in zip(("encoder", "x_decoder", "y_decoder"), stats):
            commit_moving_stats(nets[name], s)

    def y_step(self, ts: common.TrainState, batch: dict) -> dict:
        """Encoder and y decoder on the y loss (the x decoder runs for its
        BN stats alone)."""
        N = ts.nets
        x, y = scaled(batch)
        e, ms_e = N["encoder"](x)
        with torch.no_grad():
            _, ms_x = N["x_decoder"](e)
        y_hat, ms_y = N["y_decoder"](e)
        y_loss = mse01(y, y_hat)
        opt = ts.opt["y"]
        opt.step(torch.autograd.grad(y_loss, list(opt.params.values())))
        self._commit(N, ms_e, ms_x, ms_y)
        y_loss = y_loss.detach()
        return {"y_loss": y_loss,
                "y_hat_rmse": torch.sqrt(dp.mean_over_ranks(y_loss))}

    def x_step(self, ts: common.TrainState, batch: dict) -> dict:
        """The x decoder on the x loss; ``step`` + 1."""
        N = ts.nets
        x, _ = scaled(batch)
        with torch.no_grad():
            e, ms_e = N["encoder"](x)
            _, ms_y = N["y_decoder"](e)
        x_hat, ms_x = N["x_decoder"](e)
        x_loss = mse01(x, x_hat)
        opt = ts.opt["x"]
        opt.step(torch.autograd.grad(x_loss, list(opt.params.values())))
        self._commit(N, ms_e, ms_x, ms_y)
        ts.step += 1
        return {"x_loss": x_loss.detach()}

    def batches_per_train_call(self) -> int:
        return 2

    def train(self, ts: common.TrainState, stream):
        y_metrics = self.y_step(ts, next(stream))
        return ts, {**y_metrics, **self.x_step(ts, next(stream))}

    @torch.no_grad()
    def predict(self, ts: common.TrainState, batch: dict):
        """(x_hat, y_hat) of a batch, nothing committed."""
        x, _ = scaled(batch)
        e, _ = ts.nets["encoder"](x)
        return ts.nets["x_decoder"](e)[0], ts.nets["y_decoder"](e)[0]

    def eval_losses(self, ts: common.TrainState, batch: dict) -> dict:
        x, y = scaled(batch)
        x_hat, y_hat = self.predict(ts, batch)
        y_loss = mse01(y, y_hat)
        return {"x_loss": mse01(x, x_hat), "y_loss": y_loss,
                "y_hat_rmse": torch.sqrt(dp.mean_over_ranks(y_loss))}

    def write_summaries(self, writer, step: int, ts: common.TrainState,
                        batch: dict) -> None:
        x_hat, y_hat = self.predict(ts, batch)
        n = min(getattr(self.args, "examples", 64), x_hat.shape[0])

        def host(t):
            return common.nhwc(t[:n]).float().cpu().numpy()

        def to01(t):
            return np.clip((host(t) + 1) / 2, 0, 1)
        writer.montage("x", np.clip(host(batch["image"]), 0, 1), step)
        writer.montage("y", colorize(host(batch["depth"])), step)
        writer.montage("x_hat", to01(x_hat), step)
        writer.montage("y_hat", colorize(to01(y_hat)), step)
