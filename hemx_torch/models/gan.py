"""IWGAN (counterpart of ``hemx.models.gan.IwganModel``).

* Input rescaled [0,1] -> [-1,1] by the model (``2*(x-0.5)``), not by the
  input kernel, so the rounding matches ``hemx``.
* G: dense(latent -> 4*4*4L) + BN + relu, NHWC unflatten, stride-2 5x5
  deconvs halving channels (BN + relu), last deconv to C channels + tanh.
* D (no BN for IWGAN): three stride-2 5x5 convs + lrelu(0.2), NHWC
  flatten, dense -> 1.
* One train call = ``n_disc_train`` critic steps, each on a fresh batch,
  then one generator step on another (``hemx/models/gan.py:515-565``),
  run eagerly; ``step`` goes up by one per call.
* Critic step: G runs in training mode under ``no_grad`` and its new BN
  stats are discarded; D scores one 2B batch ``cat([x, g])``; loss =
  Wasserstein + 10 * gradient penalty (whole-batch norm unless
  ``--gp_per_sample``).
* Generator step: gradients go to G only; the reported ``d_loss`` uses
  ``d_real`` from the current D and ``d_fake`` from G's forward; G's BN
  moving stats are committed.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn

from hemx_torch.models import common
from hemx_torch.models.plugin import ModelPlugin
from hemx_torch.ops import losses as L
from hemx_torch.ops.activations import lrelu
from hemx_torch.ops.layers import (Conv2d, Deconv2d, Dense, Flatten,
                                   Sequential, commit_moving_stats)
from hemx_torch.train.optimizers import init_optimizer


def _apply(opt: torch.optim.Optimizer, params: list, grads) -> None:
    for p, g in zip(params, grads):
        p.grad = g
    opt.step()
    opt.zero_grad(set_to_none=True)


class IwganModel(ModelPlugin):
    name = "iwgan"
    batch_keys = ("image",)

    @staticmethod
    def arguments() -> dict:
        return {
            "--latent_size": dict(type=int, default=200),
            "--n_disc_train": dict(type=int, default=5,
                                   help="Critic steps per generator step."),
            "--gp_per_sample": dict(action="store_true", default=False,
                                    help="Per-sample gradient-penalty norm "
                                         "instead of the reference's "
                                         "whole-batch norm."),
        }

    def __init__(self, args, device):
        super().__init__(args, torch.device(device))
        if getattr(args, "dtype", "float32") != "float32":
            raise NotImplementedError(
                f"--dtype {args.dtype} is not ported to hemx_torch yet (the "
                f"slice is float32; bf16 is ROADMAP queue 1 item 7)")

    def _build(self, image_shape, generator: torch.Generator) -> nn.ModuleDict:
        c, h, w = image_shape
        latent = self.args.latent_size
        if h != w or h % 4 != 0 or (h // 4) & (h // 4 - 1):
            raise ValueError(f"GAN requires square images with H/4 a power "
                             f"of 2; got {h}x{w}")
        n_up = int(math.log2(h // 4))
        kw = dict(generator=generator)

        g = {"fc1": Dense(latent, 4 * 4 * 4 * latent, use_batch_norm=True,
                          activation=torch.relu, **kw),
             "unflatten": common.Unflatten(4, 4, 4 * latent)}
        ch = 4 * latent
        for i in range(n_up - 1):
            g[f"dc{i + 1}"] = Deconv2d(ch, ch // 2, 5, 2, use_batch_norm=True,
                                       activation=torch.relu, **kw)
            ch //= 2
        g[f"dc{n_up}"] = Deconv2d(ch, c, 5, 2, activation=torch.tanh, **kw)

        side = math.ceil(math.ceil(math.ceil(h / 2) / 2) / 2)
        d = {"c1": Conv2d(c, latent, 5, 2, activation=lrelu, **kw),
             "c2": Conv2d(latent, 2 * latent, 5, 2, activation=lrelu, **kw),
             "c3": Conv2d(2 * latent, 4 * latent, 5, 2, activation=lrelu, **kw),
             "flatten": Flatten(),
             "fc2": Dense(side * side * 4 * latent, 1, **kw)}
        return nn.ModuleDict({"generator": Sequential(g),
                              "discriminator": Sequential(d)})

    def init_state(self, image_shape, seed: int) -> common.TrainState:
        """Fresh weights for images of shape (C, H, W), drawn on the CPU from
        ``seed`` (so every device starts from the same weights)."""
        gen = torch.Generator()
        gen.manual_seed(seed)
        nets = self._build(tuple(image_shape), gen).to(self.device)
        opt = {"g": init_optimizer(self.args, nets["generator"].parameters()),
               "d": init_optimizer(self.args, nets["discriminator"].parameters())}
        return common.new_train_state(nets, opt, seed, self.device)

    def batches_per_train_call(self) -> int:
        return self.args.n_disc_train + 1

    @staticmethod
    def _scores(net, x):
        return net(x)[0].reshape(-1)

    def d_step(self, ts: common.TrainState, batch: dict, noise: dict) -> dict:
        """One critic update on a fresh batch."""
        G, D = ts.nets["generator"], ts.nets["discriminator"]
        x = 2.0 * (batch["image"] - 0.5)
        n = x.shape[0]
        with torch.no_grad():
            g, _ = G(noise["z"])  # training-mode BN; new stats discarded
        both = self._scores(D, torch.cat([x, g]))
        d_loss = L.wgan_d_loss(both[:n], both[n:])
        gp = L.gradient_penalty(lambda t: self._scores(D, t), x, g,
                                noise["alpha"],
                                per_sample=getattr(self.args, "gp_per_sample",
                                                   False))
        d_loss = d_loss + 10.0 * gp
        params = list(D.parameters())
        _apply(ts.opt["d"], params, torch.autograd.grad(d_loss, params))
        return {"d_loss": d_loss.detach()}

    def g_step(self, ts: common.TrainState, batch: dict, noise: dict) -> dict:
        """One generator update on a fresh batch (used only for the
        reported ``d_loss``)."""
        G, D = ts.nets["generator"], ts.nets["discriminator"]
        x = 2.0 * (batch["image"] - 0.5)
        g, g_stats = G(noise["z"])
        d_fake = self._scores(D, g)
        g_loss = L.wgan_g_loss(d_fake)
        params = list(G.parameters())
        grads = torch.autograd.grad(g_loss, params)
        with torch.no_grad():
            d_loss = L.wgan_d_loss(self._scores(D, x), d_fake)
        _apply(ts.opt["g"], params, grads)
        commit_moving_stats(G, g_stats)
        ts.step += 1
        return {"g_loss": g_loss.detach(), "d_loss": d_loss}

    def train(self, ts: common.TrainState, stream, noise=None):
        """One train call: ``n_disc_train`` critic steps then one generator
        step, each pulling a fresh batch from ``stream``.

        ``noise``: optional list of ``n_disc_train + 1`` dicts — ``{"z",
        "alpha"}`` per critic step, ``{"z"}`` for the generator step —
        replacing the draws from ``ts.rng`` (the seam equality tests use to
        feed ``hemx``'s JAX draws). Returns ``(ts, metrics)``, metrics as
        0-d tensors on the device; ``ts`` is updated in place.
        """
        n_d = self.args.n_disc_train
        if noise is not None and len(noise) != n_d + 1:
            raise ValueError(f"noise must hold {n_d + 1} substeps, got "
                             f"{len(noise)}")
        latent = self.args.latent_size
        metrics = {}
        for i in range(n_d + 1):
            batch = next(stream)
            critic = i < n_d
            if noise is None:
                nz = common.draw_noise(ts, batch["image"].shape[0], latent,
                                       alpha=critic)
            else:
                nz = {k: v.to(self.device) for k, v in noise[i].items()}
            step = self.d_step if critic else self.g_step
            metrics.update(step(ts, batch, nz))
        return ts, metrics
