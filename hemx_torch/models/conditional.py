"""Conditional-GAN base of the image -> depth models (counterpart of
``hemx.models.conditional``).

Skeleton: ``prepare`` splits a batch into G's input, the target depth
``y`` and conditioning -> G predicts depth -> D scores (conditioning,
depth) pairs -> sigmoid cross-entropy (``gan``) or Wasserstein (``wgan``)
losses -> alternating D and G updates. Subclasses supply the networks
(:meth:`_build`), ``prepare``, ``transform_g``, ``d_forward``, the
optimizers, the generator's ``extra_g_loss`` (added to its loss, as
hemx's) and the reported ``extra_losses``.

Step semantics, as in hemx:

* a train call runs ``n_disc_train`` critic substeps, then one generator
  substep; each pulls a fresh batch and draws fresh noise; ``step`` goes up
  by one per call (a subclass may plan its substeps otherwise:
  :meth:`substeps`);
* critic substep: G runs once (no gradient; its BN stats discarded); D
  scores the real pair, then the fake pair, the fake pass's BN moving stats
  starting from the real pass's, and D keeps them; D updates, then under
  ``wgan`` every D parameter is clipped to +-0.01 (``conditional.py:
  165-205``);
* generator substep: G forward (its BN stats kept), D scores the fake pair
  (its stats discarded); G updates, clipped too under ``wgan`` (``:207-
  230``); ``extra_losses`` are reported from that forward;
* eval, predict, sample (row 0 repeated over the batch), grad_report: BN
  with batch statistics, nothing committed (``Ctx(training=True)``,
  ``:243-300``).

Optimizer state is ``{"g", "d"}``. Noise: a generator that needs it
(``noise_draws``) gets its draws per substep from the call's seeded
generator, or the seam's ``noise`` (a list of ``{name: NCHW tensor}``, one
per substep, ``n_substeps()`` of them: ``{"z"}`` for a net with one draw,
pix2pix's named draws and keep masks, ``{}`` for a net without noise).
The depth nets record no intermediates, so ``capture_activations`` is
empty, as hemx's is.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn

from hemx_torch.models import common
from hemx_torch.models.depth_nets import Keep
from hemx_torch.models.plugin import ModelPlugin
from hemx_torch.ops import losses as L
from hemx_torch.ops.images import colorize
from hemx_torch.ops.layers import commit_moving_stats
from hemx_torch.parallel import dp
from hemx_torch.train.optimizers import (Optimizer, clip_params,
                                         make_transform)
from hemx_torch.utils import tracing


def draw_noise(net: nn.Module, gen: torch.Generator, x: torch.Tensor) -> dict:
    """Every draw ``net.noise_draws`` names for input ``x`` (N, C, H, W),
    in its order: uniform noise in a :class:`Uniform`'s range, a boolean
    mask for a :class:`Keep`; ``{}`` for a net without noise. In a process
    group each is drawn for the global batch and this rank keeps its
    rows."""
    n, _, h, w = x.shape
    out = {}
    for name, d in net.noise_draws(n * dp.data_axis_size(), h, w).items():
        u = torch.rand(d.shape, generator=gen, device=gen.device)
        u = dp.slice_rows(u)
        out[name] = u < d.p if isinstance(d, Keep) else u * (d.hi - d.lo) + d.lo
    return out


def numpy_nhwc(t: torch.Tensor) -> np.ndarray:
    return common.nhwc(t.detach()).float().cpu().numpy()


class ConditionalGanBase(ModelPlugin):
    training_version = "gan"   # or "wgan"
    clip_value = 0.01
    clip_generator = True
    batch_keys = ("image", "depth")

    def __init__(self, args, device):
        super().__init__(args, device)
        self.training_version = getattr(args, "training_version",
                                        type(self).training_version)

    # ------------------------------------------------------------- hooks
    def g_transform(self):
        return make_transform(self.args)

    def d_transform(self):
        return make_transform(self.args)

    def prepare(self, batch: dict) -> dict:
        raise NotImplementedError

    def transform_g(self, g, prep: dict):
        return g

    def extra_g_loss(self, g, prep: dict):
        """(term added to G's loss, or None; {name: metric}) — the
        differentiable extras of hemx's ``extra_g_loss``."""
        return None, {}

    def extra_losses(self, g, prep: dict) -> dict:
        return {}

    def g_forward(self, G, prep: dict, noise: dict):
        g, stats = G(prep["g_input"], noise.get("z"))
        return self.transform_g(g, prep), stats

    def d_forward(self, D, prep: dict, depth):
        raise NotImplementedError

    def depth_range(self):
        """(lo, hi) of G outputs for montage rescaling."""
        return (-1.0, 1.0)

    # ---------------------------------------------------------- plumbing
    def init_state(self, image_shape, seed: int) -> common.TrainState:
        nets = self.build_nets(image_shape, seed)
        opt = {"g": Optimizer(nets["generator"], self.g_transform()),
               "d": Optimizer(nets["discriminator"], self.d_transform())}
        return common.new_train_state(nets, opt, seed)

    @property
    def n_disc_train(self) -> int:
        return getattr(self.args, "n_disc_train", 1)

    def batches_per_train_call(self) -> int:
        return self.n_disc_train + 1

    def n_substeps(self) -> int:
        """Substeps of one train call, each with its own noise draw."""
        return self.n_disc_train + 1

    def substeps(self, stream):
        """``(batch, step function)`` of each substep of a train call, in
        order: ``n_disc_train`` critic substeps then the generator's, each
        on a fresh batch."""
        for _ in range(self.n_disc_train):
            yield next(stream), self.d_step
        yield next(stream), self.g_step

    def _g_total(self, g_gan, g, prep):
        """(G's loss: the GAN term plus ``extra_g_loss``, its metrics)."""
        extra, metrics = self.extra_g_loss(g, prep)
        return (g_gan if extra is None else g_gan + extra), metrics

    def _g_loss_from_fake(self, fake):
        if self.training_version == "wgan":
            return L.wgan_g_loss(fake)
        return torch.mean(L.sigmoid_xent(fake, torch.ones_like(fake)))

    def _gan_losses(self, real, fake):
        """(g_loss, d_loss, d_real, d_fake)."""
        g_loss = self._g_loss_from_fake(fake)
        if self.training_version == "wgan":
            d_real, d_fake = -torch.mean(real), torch.mean(fake)
        else:
            d_real = torch.mean(L.sigmoid_xent(real, torch.ones_like(real)))
            d_fake = torch.mean(L.sigmoid_xent(fake, torch.zeros_like(fake)))
        return g_loss, d_real + d_fake, d_real, d_fake

    def _real_fake(self, D, prep, g, *, commit: bool):
        """D's logits of the real and the fake pair; with ``commit`` D keeps
        the fake pass's BN stats, which start from the real pass's."""
        real, ms1 = self.d_forward(D, prep, prep["y"])
        if commit:
            commit_moving_stats(D, ms1)
        fake, ms2 = self.d_forward(D, prep, g)
        if commit:
            commit_moving_stats(D, ms2)
        return real, fake

    def _flags(self, metrics: dict, prefix: str, net, grads) -> dict:
        if getattr(self.args, "check_numerics", False):
            metrics["grad_finite"] = common.grad_finite_report(prefix, net,
                                                               grads)
        return metrics

    @tracing.spanned("step.critic")
    def d_step(self, ts: common.TrainState, batch: dict, noise: dict) -> dict:
        G, D = ts.nets["generator"], ts.nets["discriminator"]
        prep = self.prepare(batch)
        with torch.no_grad():
            g, _ = self.g_forward(G, prep, noise)
        real, fake = self._real_fake(D, prep, g, commit=True)
        _, d_loss, d_real, d_fake = self._gan_losses(real, fake)
        with tracing.span("backward"):
            grads = torch.autograd.grad(d_loss, list(D.parameters()))
        ts.opt["d"].step(grads)
        if self.training_version == "wgan":
            clip_params(D.parameters(), self.clip_value)
        return self._flags({"d_loss": d_loss.detach(),
                            "d_real": d_real.detach(),
                            "d_fake": d_fake.detach(),
                            "d_grad_norm": common.grad_norm(grads, D)},
                           "d", D, grads)

    @tracing.spanned("step.generator")
    def g_step(self, ts: common.TrainState, batch: dict, noise: dict) -> dict:
        G, D = ts.nets["generator"], ts.nets["discriminator"]
        prep = self.prepare(batch)
        g, g_stats = self.g_forward(G, prep, noise)
        fake, _ = self.d_forward(D, prep, g)
        g_gan = self._g_loss_from_fake(fake)
        g_loss, extra_g = self._g_total(g_gan, g, prep)
        with tracing.span("backward"):
            grads = torch.autograd.grad(g_loss, list(G.parameters()))
        with torch.no_grad():
            extra = self.extra_losses(g, prep)
        ts.opt["g"].step(grads)
        if self.training_version == "wgan" and self.clip_generator:
            clip_params(G.parameters(), self.clip_value)
        commit_moving_stats(G, g_stats)
        ts.step += 1
        return self._flags({"g_loss": g_loss.detach(), "g_gan": g_gan.detach(),
                            "g_grad_norm": common.grad_norm(grads, G),
                            **{k: v.detach() for k, v in extra_g.items()},
                            **extra}, "g", G, grads)

    def train(self, ts: common.TrainState, stream, noise=None):
        """One train call; ``noise``: optional list of ``n_substeps()``
        dicts replacing the call's draws (the equality tests' seam).
        Returns ``(ts, metrics)``, the last critic substep's and the
        generator's metrics as 0-d device tensors."""
        n = self.n_substeps()
        if noise is not None and len(noise) != n:
            raise ValueError(f"noise must hold {n} substeps, got {len(noise)}")
        gen = (common.generator(ts, common.TRAIN, self.device)
               if noise is None else None)
        metrics, flags = {}, {}
        for i, (batch, step) in enumerate(self.substeps(stream)):
            if noise is None:  # G's input has the image's N, H and W
                nz = draw_noise(ts.nets["generator"], gen, batch["image"])
            else:
                nz = common.seam(noise[i], self.device)
            m = step(ts, batch, nz)
            flags = common.and_flags(flags, m.pop("grad_finite", {}))
            metrics.update(m)
        if flags:
            metrics["grad_finite"] = flags
        return ts, metrics

    def _noise(self, ts, stream: int, prep: dict, noise):
        if noise is not None:
            return common.seam(noise, self.device)
        return draw_noise(ts.nets["generator"],
                          common.generator(ts, stream, self.device),
                          prep["g_input"])

    @torch.no_grad()
    def eval_losses(self, ts: common.TrainState, batch: dict,
                    noise=None) -> dict:
        G, D = ts.nets["generator"], ts.nets["discriminator"]
        prep = self.prepare(batch)
        g, _ = self.g_forward(G, prep, self._noise(ts, common.EVAL, prep,
                                                   noise))
        real, fake = self._real_fake(D, prep, g, commit=False)
        g_gan, d_loss, _, _ = self._gan_losses(real, fake)
        g_loss, extra_g = self._g_total(g_gan, g, prep)
        return {"g_loss": g_loss, "d_loss": d_loss, **extra_g,
                **self.extra_losses(g, prep)}

    @torch.no_grad()
    def predict(self, ts: common.TrainState, batch: dict, noise=None):
        """(G's depth estimate, prep) of a batch, with eval's noise."""
        prep = self.prepare(batch)
        g, _ = self.g_forward(ts.nets["generator"], prep,
                              self._noise(ts, common.EVAL, prep, noise))
        return g, prep

    @torch.no_grad()
    def sample(self, ts: common.TrainState, batch: dict, noise=None):
        """The sampler path: row 0 repeated over the batch, so the outputs
        show G's conditional distribution (reference: pix2pix.py:106-113)."""
        n = next(iter(batch.values())).shape[0]
        rep = {k: v[:1].repeat((n,) + (1,) * (v.dim() - 1))
               for k, v in batch.items()}
        prep = self.prepare(rep)
        g, _ = self.g_forward(ts.nets["generator"], prep,
                              self._noise(ts, common.SAMPLE, prep, noise))
        return g, prep

    def capture_activations(self, ts: common.TrainState, batch: dict) -> dict:
        """hemx's capture of the depth nets finds no recorded intermediates
        (its ``_A`` helper records none), so its stats are empty."""
        return {}

    def grad_report(self, ts: common.TrainState, batch: dict,
                    noise=None) -> dict:
        """Per-parameter gradient stats of D's and G's losses, one noise
        draw for both, without an update (``--summarize_gradients``)."""
        G, D = ts.nets["generator"], ts.nets["discriminator"]
        prep = self.prepare(batch)
        nz = self._noise(ts, common.REPORT, prep, noise)
        with torch.no_grad():
            g, _ = self.g_forward(G, prep, nz)
        _, d_loss, _, _ = self._gan_losses(*self._real_fake(D, prep, g,
                                                            commit=False))
        d_grads = torch.autograd.grad(d_loss, list(D.parameters()))
        g = self.g_forward(G, prep, nz)[0]
        g_loss, _ = self._g_total(
            self._g_loss_from_fake(self.d_forward(D, prep, g)[0]), g, prep)
        g_grads = torch.autograd.grad(g_loss, list(G.parameters()))
        return common.summarizable_stats(
            {**common.grads_by_path("discriminator", D, d_grads),
             **common.grads_by_path("generator", G, g_grads)})

    def write_summaries(self, writer, step: int, ts: common.TrainState,
                        batch: dict) -> None:
        """Image, real/fake/sampler depth montages (jet) and the sampler's
        variance scalars (``conditional.py:339-384``)."""
        n = min(getattr(self.args, "examples", 64), batch["image"].shape[0])
        g, prep = self.predict(ts, batch)
        g_s, prep_s = self.sample(ts, batch)
        lo, hi = self.depth_range()

        def norm(t):
            return np.clip((numpy_nhwc(t) - lo) / (hi - lo), 0, 1)

        x = numpy_nhwc(batch["image"][:n])
        writer.montage("model/images", np.clip(x, 0, 1), step)
        writer.montage("model/real_depths", colorize(norm(prep["y"])[:n]), step)
        writer.montage("model/fake_depths", colorize(norm(g)[:n]), step)
        writer.montage("sampler/fake_depths", colorize(norm(g_s)[:n]), step)
        gs = norm(g_s)
        writer.scalar("sampler/sample_variance", float(gs.var(axis=0).mean()),
                      step)
        y_s = norm(prep_s["y"])[0]
        l2 = ((gs - y_s) ** 2).reshape(gs.shape[0], -1).sum(axis=1)
        writer.scalar("sampler/mean_sample_l2", float(l2.mean()), step)
        writer.scalar("sampler/min_sample_l2", float(l2.min()), step)
