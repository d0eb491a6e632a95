"""Variational autoencoder (counterpart of ``hemx.models.vae``).

* Encoder: the CNN autoencoder's (``hemx_torch.models.cnn``) with BN on
  every conv; two dense heads ``z_mean`` and ``z_stddev`` (the stddev head
  is a plain dense output, no softplus, as in the reference);
  ``z = z_mean + z_stddev * eps`` with ``eps ~ N(0, 1)``; the CNN's decoder
  ending in a sigmoid. The input is NOT rescaled: x stays in [0, 1]
  against the sigmoid.
* Losses, SUM-reduced over B*H*W*C (``hemx.ops.losses``): ``d_loss`` the
  Bernoulli reconstruction, ``l_loss`` the KL term, ``total_loss`` their
  sum. The step optimizes ``total_loss``, or ``d_loss`` alone under
  ``--vae_parity_loss`` (the reference's objective); ``grad_norm`` is the
  global norm of that gradient.
* One optimizer over the whole parameter tree ``{"encoder", "z_mean",
  "z_stddev", "decoder"}``; hemx's ``opt`` is its optax state.
* Eval runs the encoder's BN on batch statistics and keeps the moving
  stats unchanged (``eval_stats="batch"``, ``hemx/ops/layers.py:278-300``).
* ``--dtype bfloat16``: the heads have no BN, so ``z_mean``/``z_stddev``
  are bf16 and ``l_loss`` is bf16, as in hemx; ``d_loss`` (f32 ``x``) and
  ``total_loss`` are f32.
* ``--summarize_activations`` names each layer's output by its name alone
  (the nets are applied one after another, not nested), so a later net's
  layer overwrites an earlier one of the same name (the decoder's ``c1``
  the encoder's), as hemx's capture does.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn

from hemx_torch.models import common
from hemx_torch.models.cnn import decoder, encoder
from hemx_torch.models.plugin import ModelPlugin
from hemx_torch.ops import losses as L
from hemx_torch.ops.layers import Dense, Flatten, Sequential, commit_moving_stats
from hemx_torch.parallel import sp
from hemx_torch.train.optimizers import init_optimizer


class VaeModel(ModelPlugin):
    name = "vae"
    batch_keys = ("image",)
    band_input = True

    @staticmethod
    def arguments() -> dict:
        return {
            "--latent_size": dict(type=int, default=200),
            "--vae_parity_loss": dict(action="store_true", default=False,
                                      help="Optimize only the reconstruction "
                                           "loss, exactly like the "
                                           "reference."),
        }

    def _build(self, image_shape, generator: torch.Generator) -> nn.ModuleDict:
        c, h, w = image_shape
        latent = self.args.latent_size
        kw = dict(generator=generator, dtype=self.compute_dtype)
        flat = 32 * -(-h // 16) * -(-w // 16)
        return nn.ModuleDict({
            "encoder": encoder(c, kw, use_batch_norm=True),
            "z_mean": Sequential({"flatten": Flatten(),
                                  "d1": Dense(flat, latent, **kw)}),
            "z_stddev": Sequential({"flatten": Flatten(),
                                    "d2": Dense(flat, latent, **kw)}),
            "decoder": decoder(c, h, w, latent, kw, out_activation=torch.sigmoid),
        })

    def init_state(self, image_shape, seed: int) -> common.TrainState:
        """Fresh weights for images of shape (C, H, W) from ``seed``
        (:meth:`build_nets`); one optimizer over the whole model."""
        nets = self.build_nets(image_shape, seed)
        return common.new_train_state(nets, init_optimizer(self.args, nets),
                                      seed)

    def _eps(self, ts, stream: int, n: int, noise) -> torch.Tensor:
        if noise is None:
            return common.draw_noise(common.generator(ts, stream, self.device),
                                     n, self.args.latent_size, key="eps")["eps"]
        return common.seam(noise, self.device)["eps"]

    @staticmethod
    def _forward(nets, x, eps, capture=None):
        """(reconstruction, z_mean, z_stddev, the encoder's new BN stats);
        under ``--spatial_parallel`` the encoder runs on bands, each head's
        ``Flatten`` gathers them, the decoder's ``Unflatten`` cuts them and
        the reconstruction is this rank's band."""
        with sp.bands() as enc:
            e, stats = nets["encoder"](x, capture)
        with sp.bands(enc.banded):
            z_mean, _ = nets["z_mean"](e, capture)
        with sp.bands(enc.banded):
            z_stddev, _ = nets["z_stddev"](e, capture)
        with sp.bands(False) as dec:
            d, _ = nets["decoder"](z_mean + z_stddev * eps, capture)
        d = dec.rows(d, x.shape[2] * sp.size())[:, :, :, :x.shape[3]]
        return d, z_mean, z_stddev, stats

    @staticmethod
    def _losses(x, d, z_mean, z_stddev) -> dict:
        with sp.bands():  # sums over the bands of every rank
            d_loss = L.bernoulli_recon_loss(x, d)
        l_loss = L.kl_gaussian_loss(z_mean, z_stddev)
        return {"d_loss": d_loss, "l_loss": l_loss,
                "total_loss": d_loss + l_loss}

    def _objective_grads(self, ts, x, eps):
        """(losses, gradients of the objective, encoder BN stats)."""
        d, z_mean, z_stddev, stats = self._forward(ts.nets, x, eps)
        losses = self._losses(x, d, z_mean, z_stddev)
        objective = losses["d_loss" if getattr(self.args, "vae_parity_loss",
                                               False) else "total_loss"]
        grads = torch.autograd.grad(objective, list(ts.nets.parameters()))
        return losses, grads, stats

    def train(self, ts: common.TrainState, stream, noise=None):
        """One step on one batch from ``stream``. ``noise``: optional list
        of one ``{"eps"}`` (B, latent), replacing the draw from the call's
        generator (the seam equality tests use). Returns ``(ts, metrics)``,
        metrics as 0-d tensors on the device; ``ts`` is updated in place."""
        if noise is not None and len(noise) != 1:
            raise ValueError(f"noise must hold 1 substep, got {len(noise)}")
        x = next(stream)["image"]
        eps = self._eps(ts, common.TRAIN, x.shape[0],
                        None if noise is None else noise[0])
        losses, grads, stats = self._objective_grads(ts, x, eps)
        ts.opt.step(grads)
        commit_moving_stats(ts.nets["encoder"], stats)
        ts.step += 1
        metrics = {k: v.detach() for k, v in losses.items()}
        metrics["grad_norm"] = common.grad_norm(grads, ts.nets)
        if getattr(self.args, "check_numerics", False):
            metrics["grad_finite"] = common.grad_finite_report("", ts.nets,
                                                               grads)
        return ts, metrics

    @torch.no_grad()
    def eval_losses(self, ts: common.TrainState, batch: dict,
                    noise=None) -> dict:
        """Losses of one batch without an update; BN on batch statistics,
        moving stats unchanged. ``noise``: optional ``{"eps"}``."""
        x = batch["image"]
        eps = self._eps(ts, common.EVAL, x.shape[0], noise)
        d, z_mean, z_stddev, _ = self._forward(ts.nets, x, eps)
        return self._losses(x, d, z_mean, z_stddev)

    @torch.no_grad()
    def recon_and_samples(self, ts: common.TrainState, batch: dict,
                          n: int, noise=None) -> tuple:
        """Reconstructions of ``batch`` (BN on the whole batch's statistics)
        and ``n`` decoded N(0, 1) samples, both in [0, 1] (in the compute
        dtype), NCHW. ``noise``: optional ``{"eps"}`` (B, latent) for the
        reconstructions and ``{"z"}`` (n, latent) for the samples through
        the seam; what it lacks is drawn."""
        x = batch["image"]
        noise = noise or {}
        gen = common.generator(ts, common.SAMPLE, self.device)
        eps = common.draw_noise(gen, x.shape[0], self.args.latent_size,
                                key="eps")["eps"]
        recon = self._forward(ts.nets, x, noise.get("eps", eps)
                              .to(self.device))[0]
        z = common.draw_noise(gen, n, self.args.latent_size, key="eps")["eps"]
        return recon, ts.nets["decoder"](noise.get("z", z).to(self.device))[0]

    def write_summaries(self, writer, step: int, ts: common.TrainState,
                        batch: dict) -> None:
        """Input, reconstruction and sample montages (``vae.py:210-218``)."""
        n = min(getattr(self.args, "examples", 64), batch["image"].shape[0])
        recon, fake = self.recon_and_samples(ts, batch, n)
        for tag, t in (("examples/inputs", batch["image"][:n]),
                       ("examples/real_decoded", recon[:n]),
                       ("examples/fake_decoded", fake)):
            writer.montage(tag, np.clip(
                common.nhwc(t).float().cpu().numpy(), 0, 1), step)

    @torch.no_grad()
    def capture_activations(self, ts: common.TrainState, batch: dict) -> dict:
        """Per-layer output stats on 8 rows (``--summarize_activations``),
        named as hemx's capture names them (see the module docstring)."""
        x = batch["image"][:8]
        acts = {}
        self._forward(ts.nets, x, self._eps(ts, common.REPORT, x.shape[0],
                                            None), acts)
        return common.summarizable_stats(
            {k: common.nhwc(v) for k, v in acts.items()})

    def grad_report(self, ts: common.TrainState, batch: dict) -> dict:
        """Per-parameter gradient stats of the objective, without an update
        (``--summarize_gradients``)."""
        x = batch["image"]
        eps = self._eps(ts, common.REPORT, x.shape[0], None)
        _, grads, _ = self._objective_grads(ts, x, eps)
        return common.summarizable_stats(
            common.grads_by_path("", ts.nets, grads))
