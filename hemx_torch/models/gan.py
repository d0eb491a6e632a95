"""GAN, WGAN and IWGAN (counterpart of ``hemx.models.gan``: one class,
three regimes picked by ``model_type``).

* Input rescaled [0,1] -> [-1,1] by the model (``2*(x-0.5)``), not by the
  input kernel, so the rounding matches ``hemx``.
* G: dense(latent -> 4*4*4L) + BN + relu, NHWC unflatten, stride-2 5x5
  deconvs halving channels (BN + relu), last deconv to C channels + tanh.
* D: three stride-2 5x5 convs + lrelu(0.2), BN on ``c2``/``c3`` except for
  IWGAN, NHWC flatten, dense -> 1, a sigmoid only for the vanilla GAN.
  Losses: log loss (``gan``), Wasserstein (``wgan``), Wasserstein + 10 *
  gradient penalty (``iwgan``; whole-batch norm unless
  ``--gp_per_sample``).
* ``--dtype bfloat16``: every conv, deconv and dense computes in bf16
  (``hemx_torch.ops.layers``); layers with BN output f32, the others bf16,
  so G's image and D's scores are bf16, ``cat([x, g])`` is f32, and the
  GP's input gradient comes back f32 through the cast, as in hemx.
* ``gan``: one fused step per call on one batch and one z; D's and G's
  gradients are both taken at the pre-update parameters, then both
  optimizers apply (``hemx/models/gan.py:178-220``).
* ``wgan``/``iwgan``: one train call = ``n_disc_train`` critic steps, each
  on a fresh batch, then one generator step on another
  (``gan.py:515-565``). ``wgan`` clips every parameter of D after each
  critic step and of G after the generator step to +-0.01, after the
  optimizer apply (``gan.py:273-274,310-311``).
* Critic BN: D scores ``x`` and the fake batch in two passes (batch
  statistics differ between one 2B pass and two B passes); the fake pass's
  moving stats start from the real pass's and the step keeps them. Only
  IWGAN's D, which has no BN, scores one 2B batch ``cat([x, g])``. G runs
  in training mode under ``no_grad`` in a critic step and its new BN stats
  are discarded.
* Generator step: gradients go to G only; D's BN stats of that step are
  discarded; the reported ``d_loss`` uses ``d_real`` from the current D and
  ``d_fake`` from G's forward; G's BN moving stats are committed.
* Run eagerly; ``step`` goes up by one per call.
* ``--spatial_parallel``: D runs on height bands, G's output is this
  rank's band (:meth:`_generate`), the IWGAN's GP runs on whole rows
  (:meth:`_critic_loss`); ``--model_parallel`` needs nothing here (the
  layers slice their kernels).
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
from hemx_torch.parallel import sp
from hemx_torch.train.optimizers import clip_params, init_optimizer
from hemx_torch.utils import tracing

WGAN_CLIP = 0.01


class GanModel(ModelPlugin):
    name = "gan"
    model_type = "gan"
    batch_keys = ("image",)
    band_input = True

    @staticmethod
    def arguments() -> dict:
        return {
            "--latent_size": dict(type=int, default=200),
            "--n_disc_train": dict(type=int, default=5,
                                   help="Critic steps per generator step "
                                        "(WGAN/IWGAN)."),
            "--gp_per_sample": dict(action="store_true", default=False,
                                    help="Per-sample gradient-penalty norm "
                                         "instead of the reference's "
                                         "whole-batch norm."),
        }

    def _build(self, image_shape, generator: torch.Generator) -> nn.ModuleDict:
        c, h, w = image_shape
        latent = self.args.latent_size
        if h != w or h % 4 != 0 or (h // 4) & (h // 4 - 1):
            raise ValueError(f"GAN requires square images with H/4 a power "
                             f"of 2; got {h}x{w}")
        n_up = int(math.log2(h // 4))
        d_bn = self.model_type != "iwgan"
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
             "c2": Conv2d(latent, 2 * latent, 5, 2, use_batch_norm=d_bn,
                          activation=lrelu, **kw),
             "c3": Conv2d(2 * latent, 4 * latent, 5, 2, use_batch_norm=d_bn,
                          activation=lrelu, **kw),
             "flatten": Flatten(),
             "fc2": Dense(side * side * 4 * latent, 1,
                          activation=(torch.sigmoid if self.model_type == "gan"
                                      else None), **kw)}
        return nn.ModuleDict({"generator": Sequential(g),
                              "discriminator": Sequential(d)})

    def init_state(self, image_shape, seed: int) -> common.TrainState:
        """Fresh weights for images of shape (C, H, W) from ``seed``
        (:meth:`build_nets`); one optimizer per network."""
        nets = self.build_nets(image_shape, seed)
        opt = {"g": init_optimizer(self.args, nets["generator"]),
               "d": init_optimizer(self.args, nets["discriminator"])}
        return common.new_train_state(nets, opt, seed)

    def batches_per_train_call(self) -> int:
        return 1 if self.model_type == "gan" else self.args.n_disc_train + 1

    @staticmethod
    def _scores(net, x, banded: bool = True):
        """D's scores of ``x``: under ``--spatial_parallel`` a band unless
        ``banded`` is False (the GP's whole-height rows)."""
        with sp.bands(banded):
            return net(x)[0].reshape(-1)

    @staticmethod
    def _generate(G, z):
        """G's images of ``z`` and its new BN stats; under
        ``--spatial_parallel`` this rank's band of them (G's ``Unflatten``
        cuts its tensor and the deconvs run on bands; hemx's
        ``_pin_fake``)."""
        with sp.bands(False) as state:
            g, stats = G(z)
        return state.band(g), stats

    def _g_loss(self, d_fake):
        return (L.gan_g_loss(d_fake) if self.model_type == "gan"
                else L.wgan_g_loss(d_fake))

    def _d_loss(self, d_real, d_fake):
        return (L.gan_d_loss(d_real, d_fake) if self.model_type == "gan"
                else L.wgan_d_loss(d_real, d_fake))

    def _real_fake(self, D, x, g, *, commit: bool):
        """D's scores of ``x`` and of ``g`` in two passes; with ``commit``,
        D keeps the BN stats of the fake pass, which starts from the real
        pass's (``gan.py:247-251``)."""
        with sp.bands():
            d_real, ms1 = D(x)
        if commit:
            commit_moving_stats(D, ms1)
        with sp.bands():
            d_fake, ms2 = D(g)
        if commit:
            commit_moving_stats(D, ms2)
        return d_real.reshape(-1), d_fake.reshape(-1)

    def _critic_loss(self, D, x, g, noise, *, commit: bool):
        """The critic's training loss: for IWGAN the Wasserstein loss of one
        2B pass over ``cat([x, g])`` plus 10 * gradient penalty, otherwise
        the loss of the two passes of :meth:`_real_fake`.

        Under ``--spatial_parallel`` the IWGAN's loss follows hemx's split
        (``hemx/models/gan.py:412-500``): the Wasserstein term over bands,
        the GP on whole-height rows gathered from them, the same on every
        rank of a data index (hemx pins it to the data-parallel layout);
        the one backward of their sum is ``gw + 10 * ggp``, and averaging
        over every rank counts the GP's gradient once."""
        if self.model_type != "iwgan":
            return self._d_loss(*self._real_fake(D, x, g, commit=commit))
        n = x.shape[0]
        both = self._scores(D, torch.cat([x, g]))
        gp = L.gradient_penalty(lambda t: self._scores(D, t, banded=False),
                                sp.gather(x), sp.gather(g), noise["alpha"],
                                per_sample=getattr(self.args, "gp_per_sample",
                                                   False))
        return L.wgan_d_loss(both[:n], both[n:]) + 10.0 * gp

    def _report(self, metrics: dict, *parts) -> dict:
        """``metrics`` plus, under ``--check_numerics``, the finite-ness
        flags of each ``(prefix, net, grads)`` part."""
        if getattr(self.args, "check_numerics", False):
            metrics["grad_finite"] = {
                k: v for part in parts
                for k, v in common.grad_finite_report(*part).items()}
        return metrics

    def _apply(self, ts, key: str, net, grads) -> None:
        ts.opt[key].step(grads)
        if self.model_type == "wgan":
            clip_params(net.parameters(), WGAN_CLIP)

    @tracing.spanned("step.critic")
    def d_step(self, ts: common.TrainState, batch: dict, noise: dict) -> dict:
        """One critic update on a fresh batch (WGAN, IWGAN)."""
        G, D = ts.nets["generator"], ts.nets["discriminator"]
        x = 2.0 * (batch["image"] - 0.5)
        with torch.no_grad():
            # training-mode BN; new stats discarded
            g, _ = self._generate(G, noise["z"])
        d_loss = self._critic_loss(D, x, g, noise, commit=True)
        with tracing.span("backward"):
            grads = torch.autograd.grad(d_loss, list(D.parameters()))
        self._apply(ts, "d", D, grads)
        return self._report({"d_loss": d_loss.detach()}, ("d", D, grads))

    @tracing.spanned("step.generator")
    def g_step(self, ts: common.TrainState, batch: dict, noise: dict) -> dict:
        """One generator update on a fresh batch (used only for the
        reported ``d_loss``) (WGAN, IWGAN)."""
        G, D = ts.nets["generator"], ts.nets["discriminator"]
        x = 2.0 * (batch["image"] - 0.5)
        g, g_stats = self._generate(G, noise["z"])
        d_fake = self._scores(D, g)
        g_loss = self._g_loss(d_fake)
        with tracing.span("backward"):
            grads = torch.autograd.grad(g_loss, list(G.parameters()))
        with torch.no_grad():
            d_loss = self._d_loss(self._scores(D, x), d_fake)
        self._apply(ts, "g", G, grads)
        commit_moving_stats(G, g_stats)
        ts.step += 1
        return self._report({"g_loss": g_loss.detach(), "d_loss": d_loss},
                            ("g", G, grads))

    @tracing.spanned("step.generator")
    def gan_step(self, ts: common.TrainState, batch: dict,
                 noise: dict) -> dict:
        """The vanilla GAN's fused step: one batch, one z; D's and G's
        gradients both at the pre-update parameters, then both apply. D's
        fake pass serves both losses (its BN output is the same whatever
        moving stats it starts from); D keeps the stats of its two passes,
        G those of its forward (``gan.py:178-220``)."""
        G, D = ts.nets["generator"], ts.nets["discriminator"]
        x = 2.0 * (batch["image"] - 0.5)
        g, g_stats = self._generate(G, noise["z"])
        d_real, d_fake = self._real_fake(D, x, g, commit=True)
        d_loss, g_loss = L.gan_d_loss(d_real, d_fake), L.gan_g_loss(d_fake)
        with tracing.span("backward"):
            d_grads = torch.autograd.grad(d_loss, list(D.parameters()),
                                          retain_graph=True)
        with tracing.span("backward"):
            g_grads = torch.autograd.grad(g_loss, list(G.parameters()))
        self._apply(ts, "d", D, d_grads)
        self._apply(ts, "g", G, g_grads)
        commit_moving_stats(G, g_stats)
        ts.step += 1
        return self._report({"g_loss": g_loss.detach(),
                             "d_loss": d_loss.detach()},
                            ("g", G, g_grads), ("d", D, d_grads))

    def train(self, ts: common.TrainState, stream, noise=None):
        """One train call, each substep pulling a fresh batch from
        ``stream``: the vanilla GAN's fused step, or ``n_disc_train``
        critic steps then one generator step.

        ``noise``: optional list of ``batches_per_train_call()`` dicts —
        ``{"z", "alpha"}`` per IWGAN critic step, ``{"z"}`` for every other
        step — replacing the draws from the call's generator (the seam
        equality tests use to feed ``hemx``'s JAX draws). Returns ``(ts,
        metrics)``, metrics as 0-d tensors on the device; ``ts`` is updated
        in place.
        """
        n = self.batches_per_train_call()
        if noise is not None and len(noise) != n:
            raise ValueError(f"noise must hold {n} substeps, got {len(noise)}")
        gen = (common.generator(ts, common.TRAIN, self.device)
               if noise is None else None)
        metrics, flags = {}, {}
        for i in range(n):
            batch = next(stream)
            critic = i < n - 1
            if noise is None:
                nz = common.draw_noise(
                    gen, batch["image"].shape[0], self.args.latent_size,
                    alpha=critic and self.model_type == "iwgan")
            else:
                nz = common.seam(noise[i], self.device)
            step = (self.gan_step if self.model_type == "gan"
                    else self.d_step if critic else self.g_step)
            m = step(ts, batch, nz)
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
        noise = (common.draw_noise(
            common.generator(ts, common.EVAL, self.device), x.shape[0],
            self.args.latent_size) if noise is None
            else common.seam(noise, self.device))
        g, _ = self._generate(G, noise["z"])
        d_real, d_fake = self._real_fake(D, x, g, commit=False)
        return {"g_loss": self._g_loss(d_fake),
                "d_loss": self._d_loss(d_real, d_fake)}

    @torch.no_grad()
    def sample(self, ts: common.TrainState, n: int,
               z: torch.Tensor | None = None) -> torch.Tensor:
        """``n`` generated images in [0, 1] (in the compute dtype), NCHW;
        ``z``: optional (n, latent) noise through the seam."""
        if z is None:
            z = common.draw_noise(
                common.generator(ts, common.SAMPLE, self.device), n,
                self.args.latent_size)["z"]
        else:
            z = z.to(self.device)
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
                              x.shape[0], self.args.latent_size)["z"]
        acts = {}
        for name, net, inp in (("generator", ts.nets["generator"], z),
                               ("discriminator", ts.nets["discriminator"], x)):
            out = {}
            net(inp, out)
            acts.update({f"{name}/{k}": common.nhwc(v) for k, v in out.items()})
        return common.summarizable_stats(acts)

    def grad_report(self, ts: common.TrainState, batch: dict) -> dict:
        """Per-parameter gradient stats of the full critic loss (with
        10 * GP for IWGAN) and of the generator loss, without an update
        (``--summarize_gradients``, ``gan.py:358-411``)."""
        G, D = ts.nets["generator"], ts.nets["discriminator"]
        x = 2.0 * (batch["image"] - 0.5)
        nz = common.draw_noise(common.generator(ts, common.REPORT, self.device),
                               x.shape[0], self.args.latent_size,
                               alpha=self.model_type == "iwgan")
        with torch.no_grad():
            g, _ = G(nz["z"])
        d_params = list(D.parameters())
        d_grads = torch.autograd.grad(
            self._critic_loss(D, x, g, nz, commit=False), d_params)
        g_params = list(G.parameters())
        g_grads = torch.autograd.grad(
            self._g_loss(self._scores(D, G(nz["z"])[0])), g_params)
        return common.summarizable_stats(
            {**common.grads_by_path("discriminator", D, d_grads),
             **common.grads_by_path("generator", G, g_grads)})


class WganModel(GanModel):
    name = "wgan"
    model_type = "wgan"


class IwganModel(GanModel):
    name = "iwgan"
    model_type = "iwgan"
