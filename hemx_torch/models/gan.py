"""IWGAN (counterpart of ``hemx.models.gan.IwganModel``).

* Input rescaled [0,1] -> [-1,1] by the model (``2*(x-0.5)``), not by the
  input kernel, so the rounding matches ``hemx``.
* G: dense(latent -> 4*4*4L) + BN + relu, NHWC unflatten, stride-2 5x5
  deconvs halving channels (BN + relu), last deconv to C channels + tanh.
* D (no BN for IWGAN): three stride-2 5x5 convs + lrelu(0.2), NHWC
  flatten, dense -> 1.
* ``--dtype bfloat16``: every conv, deconv and dense computes in bf16
  (``hemx_torch.ops.layers``); layers with BN output f32, the others bf16,
  so G's image and D's scores are bf16, ``cat([x, g])`` is f32, and the
  GP's input gradient comes back f32 through the cast, as in hemx.
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
* ``--check_numerics``: each step reports per-parameter finite-ness flags;
  the critic's are ANDed across its substeps (``gan.py:520-533``).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn as nn

from hemx_torch.models import common
from hemx_torch.models.plugin import ModelPlugin
from hemx_torch.ops import losses as L
from hemx_torch.ops.activations import lrelu
from hemx_torch.ops.layers import (Conv2d, Deconv2d, Dense, Flatten,
                                   Sequential, commit_moving_stats)
from hemx_torch.train.optimizers import init_optimizer

_COMPUTE_DTYPES = {"float32": None, "bfloat16": torch.bfloat16}


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
        self.compute_dtype = _COMPUTE_DTYPES[getattr(args, "dtype", "float32")]

    def _build(self, image_shape, generator: torch.Generator) -> nn.ModuleDict:
        c, h, w = image_shape
        latent = self.args.latent_size
        if h != w or h % 4 != 0 or (h // 4) & (h // 4 - 1):
            raise ValueError(f"GAN requires square images with H/4 a power "
                             f"of 2; got {h}x{w}")
        n_up = int(math.log2(h // 4))
        kw = dict(generator=generator, dtype=self.compute_dtype)

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
        opt = {"g": init_optimizer(self.args, nets["generator"]),
               "d": init_optimizer(self.args, nets["discriminator"])}
        return common.new_train_state(nets, opt, seed)

    def batches_per_train_call(self) -> int:
        return self.args.n_disc_train + 1

    @staticmethod
    def _scores(net, x):
        return net(x)[0].reshape(-1)

    def _critic_loss(self, D, x, g, alpha):
        """Wasserstein loss of one 2B pass over ``cat([x, g])`` plus
        10 * gradient penalty."""
        n = x.shape[0]
        both = self._scores(D, torch.cat([x, g]))
        gp = L.gradient_penalty(lambda t: self._scores(D, t), x, g, alpha,
                                per_sample=getattr(self.args, "gp_per_sample",
                                                   False))
        return L.wgan_d_loss(both[:n], both[n:]) + 10.0 * gp

    def _report(self, metrics: dict, prefix: str, net, grads) -> dict:
        if getattr(self.args, "check_numerics", False):
            metrics["grad_finite"] = common.grad_finite_report(prefix, net,
                                                               grads)
        return metrics

    def d_step(self, ts: common.TrainState, batch: dict, noise: dict) -> dict:
        """One critic update on a fresh batch."""
        G, D = ts.nets["generator"], ts.nets["discriminator"]
        x = 2.0 * (batch["image"] - 0.5)
        with torch.no_grad():
            g, _ = G(noise["z"])  # training-mode BN; new stats discarded
        d_loss = self._critic_loss(D, x, g, noise["alpha"])
        params = list(D.parameters())
        grads = torch.autograd.grad(d_loss, params)
        ts.opt["d"].step(grads)
        return self._report({"d_loss": d_loss.detach()}, "d", D, grads)

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
        ts.opt["g"].step(grads)
        commit_moving_stats(G, g_stats)
        ts.step += 1
        return self._report({"g_loss": g_loss.detach(), "d_loss": d_loss},
                            "g", G, grads)

    def train(self, ts: common.TrainState, stream, noise=None):
        """One train call: ``n_disc_train`` critic steps then one generator
        step, each pulling a fresh batch from ``stream``.

        ``noise``: optional list of ``n_disc_train + 1`` dicts — ``{"z",
        "alpha"}`` per critic step, ``{"z"}`` for the generator step —
        replacing the draws from the call's generator (the seam equality
        tests use to feed ``hemx``'s JAX draws). Returns ``(ts, metrics)``,
        metrics as 0-d tensors on the device; ``ts`` is updated in place.
        """
        n_d = self.args.n_disc_train
        if noise is not None and len(noise) != n_d + 1:
            raise ValueError(f"noise must hold {n_d + 1} substeps, got "
                             f"{len(noise)}")
        gen = (common.generator(ts, common.TRAIN, self.device)
               if noise is None else None)
        metrics, flags = {}, {}
        for i in range(n_d + 1):
            batch = next(stream)
            critic = i < n_d
            if noise is None:
                nz = common.draw_noise(gen, batch["image"].shape[0],
                                       self.args.latent_size, alpha=critic)
            else:
                nz = {k: v.to(self.device) for k, v in noise[i].items()}
            m = (self.d_step if critic else self.g_step)(ts, batch, nz)
            flags = common.and_flags(flags, m.pop("grad_finite", {}))
            metrics.update(m)
        if flags:
            metrics["grad_finite"] = flags
        return ts, metrics

    @torch.no_grad()
    def eval_losses(self, ts: common.TrainState, batch: dict,
                    noise=None) -> dict:
        """Losses of one batch without an update (``gan.py:323-334``): G in
        training mode (its new BN stats discarded), D on ``x`` and on the
        fake batch separately. ``noise``: optional ``{"z"}``."""
        G, D = ts.nets["generator"], ts.nets["discriminator"]
        x = 2.0 * (batch["image"] - 0.5)
        if noise is None:
            noise = common.draw_noise(
                common.generator(ts, common.EVAL, self.device), x.shape[0],
                self.args.latent_size, alpha=False)
        g, _ = G(noise["z"].to(self.device))
        d_real, d_fake = self._scores(D, x), self._scores(D, g)
        return {"g_loss": L.wgan_g_loss(d_fake),
                "d_loss": L.wgan_d_loss(d_real, d_fake)}

    @torch.no_grad()
    def sample(self, ts: common.TrainState, n: int) -> torch.Tensor:
        """``n`` generated images in [0, 1] (in the compute dtype), NCHW."""
        z = common.draw_noise(common.generator(ts, common.SAMPLE, self.device),
                              n, self.args.latent_size, alpha=False)["z"]
        g, _ = ts.nets["generator"](z)
        return (g + 1.0) / 2.0

    def write_summaries(self, writer, step: int, ts: common.TrainState,
                        batch: dict) -> None:
        """Input and fake montages and histograms (``gan.py:611-619``)."""
        n = min(getattr(self.args, "examples", 64), batch["image"].shape[0])
        x = common.nhwc(batch["image"][:n]).float().cpu().numpy()
        fake = common.nhwc(self.sample(ts, n)).float().cpu().numpy()
        writer.montage("examples/inputs", np.clip(x, 0, 1), step)
        writer.montage("examples/fake", np.clip(fake, 0, 1), step)
        writer.histogram("examples/fakes_hist", fake, step)
        writer.histogram("examples/real_hist", x, step)

    @torch.no_grad()
    def capture_activations(self, ts: common.TrainState, batch: dict) -> dict:
        """Per-layer output stats of G on z and D on real x, 8 rows
        (``--summarize_activations``, ``gan.py:342-356``)."""
        x = 2.0 * (batch["image"][:8] - 0.5)
        z = common.draw_noise(common.generator(ts, common.REPORT, self.device),
                              x.shape[0], self.args.latent_size,
                              alpha=False)["z"]
        acts = {}
        for name, net, inp in (("generator", ts.nets["generator"], z),
                               ("discriminator", ts.nets["discriminator"], x)):
            out = {}
            net(inp, out)
            acts.update({f"{name}/{k}": common.nhwc(v) for k, v in out.items()})
        return common.summarizable_stats(acts)

    def grad_report(self, ts: common.TrainState, batch: dict) -> dict:
        """Per-parameter gradient stats of the full critic loss (with
        10 * GP) and of the generator loss, without an update
        (``--summarize_gradients``, ``gan.py:358-411``)."""
        G, D = ts.nets["generator"], ts.nets["discriminator"]
        x = 2.0 * (batch["image"] - 0.5)
        nz = common.draw_noise(common.generator(ts, common.REPORT, self.device),
                               x.shape[0], self.args.latent_size, alpha=True)
        with torch.no_grad():
            g, _ = G(nz["z"])
        d_params = list(D.parameters())
        d_grads = torch.autograd.grad(
            self._critic_loss(D, x, g, nz["alpha"]), d_params)
        g_params = list(G.parameters())
        g_grads = torch.autograd.grad(
            L.wgan_g_loss(self._scores(D, G(nz["z"])[0])), g_params)
        return common.summarizable_stats(
            {**common.grads_by_path("discriminator", D, d_grads),
             **common.grads_by_path("generator", G, g_grads)})
