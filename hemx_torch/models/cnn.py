"""Convolutional autoencoder (counterpart of ``hemx.models.cnn``).

* Input rescaled [0,1] -> [-1,1] (``2*(x-0.5)``); L1 loss between the
  rescaled input and the reconstruction.
* Encoder: four stride-2 5x5 convs (64, 128, 256, 256) and two 1x1 convs
  (96, 32), all lrelu(0.2); ``latent``: NHWC flatten + dense to
  ``--latent_size``; decoder: dense + relu, NHWC unflatten to
  ``ceil(H/16) x ceil(W/16) x 32``, two 1x1 convs (96, 256) and three
  stride-2 5x5 deconvs (256, 128, 64) with relu, a last deconv to C
  channels with tanh. No BN. The decoder's output is cropped to the input
  size (it differs when H or W is not a multiple of 16).
* The parameter tree is nested three deep, ``{"encoder": {c1..c6},
  "latent": {"flatten", "d1"}, "decoder": {"d1", "unflatten", "c1", "c2",
  "dc1".."dc4"}}``, and one optimizer runs over all of it: hemx's ``opt``
  is that optimizer's optax state, with no ``{"g", "d"}`` level.
* One train call = one step on one batch; metrics ``loss`` and
  ``grad_norm`` (global L2 norm of every gradient). The CNN draws no
  noise.
* Train-state key: hemx draws it from the init key
  (``PRNGKey(randint(k_state))``, ``hemx/models/cnn.py:90-96``), which the
  port cannot reproduce without JAX's threefry; the port writes
  ``PRNGKey(seed)``. Nothing the CNN computes reads the key, and a key
  read from a hemx checkpoint is kept as read.
"""

from __future__ import annotations

import numpy as np
import torch

from hemx_torch.models import common
from hemx_torch.models.plugin import ModelPlugin
from hemx_torch.ops import losses as L
from hemx_torch.ops.activations import lrelu
from hemx_torch.ops.layers import Conv2d, Deconv2d, Dense, Flatten, Sequential
from hemx_torch.parallel import sp
from hemx_torch.train.optimizers import init_optimizer


def encoder(c: int, kw: dict, *, use_batch_norm: bool = False) -> Sequential:
    """The CNN autoencoder's encoder (the VAE's, with BN)."""
    widths = [(c, 64, 5, 2), (64, 128, 5, 2), (128, 256, 5, 2),
              (256, 256, 5, 2), (256, 96, 1, 1), (96, 32, 1, 1)]
    return Sequential({f"c{i + 1}": Conv2d(a, b, k, s, activation=lrelu,
                                           use_batch_norm=use_batch_norm, **kw)
                       for i, (a, b, k, s) in enumerate(widths)})


def decoder(c: int, h: int, w: int, latent: int, kw: dict, *,
            out_activation) -> Sequential:
    """Dense seed of ``ceil(h/16) x ceil(w/16) x 32``, two 1x1 convs, four
    stride-2 deconvs; the last one to ``c`` channels with
    ``out_activation`` (tanh for the CNN, sigmoid for the VAE)."""
    eh, ew = -(-h // 16), -(-w // 16)
    layers = {"d1": Dense(latent, 32 * eh * ew, activation=torch.relu, **kw),
              "unflatten": common.Unflatten(eh, ew, 32),
              "c1": Conv2d(32, 96, 1, 1, activation=torch.relu, **kw),
              "c2": Conv2d(96, 256, 1, 1, activation=torch.relu, **kw)}
    for i, (a, b) in enumerate([(256, 256), (256, 128), (128, 64)]):
        layers[f"dc{i + 1}"] = Deconv2d(a, b, 5, 2, activation=torch.relu, **kw)
    layers["dc4"] = Deconv2d(64, c, 5, 2, activation=out_activation, **kw)
    return Sequential(layers)


class CnnModel(ModelPlugin):
    name = "cnn"
    batch_keys = ("image",)
    band_input = True

    @staticmethod
    def arguments() -> dict:
        return {
            "--latent_size": dict(type=int, default=200,
                                  help="Size of the latent bottleneck."),
        }

    def _build(self, image_shape, generator: torch.Generator) -> Sequential:
        c, h, w = image_shape
        latent = self.args.latent_size
        kw = dict(generator=generator, dtype=self.compute_dtype)
        eh, ew = -(-h // 16), -(-w // 16)
        return Sequential({
            "encoder": encoder(c, kw),
            "latent": Sequential({"flatten": Flatten(),
                                  "d1": Dense(32 * eh * ew, latent, **kw)}),
            "decoder": decoder(c, h, w, latent, kw, out_activation=torch.tanh),
        })

    def init_state(self, image_shape, seed: int) -> common.TrainState:
        """Fresh weights for images of shape (C, H, W) from ``seed``
        (:meth:`build_nets`); one optimizer over the whole network."""
        nets = self.build_nets(image_shape, seed)
        return common.new_train_state(nets, init_optimizer(self.args, nets),
                                      seed)

    @staticmethod
    def _forward(net, image, capture=None):
        """(reconstruction in [-1, 1], L1 loss) of a [0, 1] batch; under
        ``--spatial_parallel`` of this rank's band of it (the encoder runs
        on bands, ``Flatten`` gathers them, the decoder's ``Unflatten``
        cuts them again)."""
        x = 2.0 * (image - 0.5)
        with sp.bands() as state:
            d, _ = net(x, capture)
        d = state.rows(d, x.shape[2] * sp.size())[:, :, :, :x.shape[3]]
        return d, L.l1_loss(x, d)

    def train(self, ts: common.TrainState, stream):
        """One step on one batch from ``stream``. Returns ``(ts, metrics)``,
        metrics as 0-d tensors on the device; ``ts`` is updated in place."""
        params = list(ts.nets.parameters())
        _, loss = self._forward(ts.nets, next(stream)["image"])
        grads = torch.autograd.grad(loss, params)
        ts.opt.step(grads)
        ts.step += 1
        metrics = {"loss": loss.detach(),
                   "grad_norm": common.grad_norm(grads, ts.nets)}
        if getattr(self.args, "check_numerics", False):
            metrics["grad_finite"] = common.grad_finite_report("", ts.nets,
                                                               grads)
        return ts, metrics

    @torch.no_grad()
    def eval_losses(self, ts: common.TrainState, batch: dict) -> dict:
        return {"loss": self._forward(ts.nets, batch["image"])[1]}

    @torch.no_grad()
    def recon(self, ts: common.TrainState, batch: dict) -> torch.Tensor:
        """Reconstructions in [0, 1] (in the compute dtype), NCHW."""
        return (self._forward(ts.nets, batch["image"])[0] + 1.0) / 2.0

    def write_summaries(self, writer, step: int, ts: common.TrainState,
                        batch: dict) -> None:
        """Input and reconstruction montages (``cnn.py:164-169``)."""
        n = min(getattr(self.args, "examples", 64), batch["image"].shape[0])
        out = common.nhwc(self.recon(ts, batch)[:n]).float().cpu().numpy()
        x = common.nhwc(batch["image"][:n]).float().cpu().numpy()
        writer.montage("examples/inputs", np.clip(x, 0, 1), step)
        writer.montage("examples/outputs", np.clip(out, 0, 1), step)

    @torch.no_grad()
    def capture_activations(self, ts: common.TrainState, batch: dict) -> dict:
        """Per-layer output stats on 8 rows (``--summarize_activations``),
        named ``encoder/c1`` ... ``encoder``, ``latent/d1``, ...,
        ``decoder`` as hemx's nested capture names them."""
        acts = {}
        self._forward(ts.nets, batch["image"][:8], acts)
        return common.summarizable_stats(
            {k: common.nhwc(v) for k, v in acts.items()})

    def grad_report(self, ts: common.TrainState, batch: dict) -> dict:
        """Per-parameter gradient stats of the loss, without an update
        (``--summarize_gradients``)."""
        params = list(ts.nets.parameters())
        grads = torch.autograd.grad(
            self._forward(ts.nets, batch["image"])[1], params)
        return common.summarizable_stats(
            common.grads_by_path("", ts.nets, grads))
