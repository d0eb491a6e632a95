"""Model plugin base + registry (counterpart of ``hemx.models.plugin``).

A model is constructed as ``Model(args, device)``, then:

* ``init_state(image_shape, seed) -> TrainState``;
* ``train(train_state, stream) -> (train_state, metrics)`` — may pull
  several batches from ``stream`` (``batches_per_train_call()`` of them);
* ``eval_losses(train_state, batch) -> metrics`` (validation and test);
* ``write_summaries(writer, step, train_state, batch)``, and for
  ``--summarize_activations`` / ``--summarize_gradients``
  ``capture_activations`` / ``grad_report`` (stats per tensor).

Ported: the BASELINE models ``cnn``, ``vae``, ``gan``, ``wgan`` and
``iwgan``, and the thesis depth models ``paper_cgan``, ``paper_sampler``,
``paper_noise``, ``paper_baseline_sampler``, ``paper_standalone``,
``paper_baseline_standalone`` and ``sampler_gan``, and the thesis's second
generation ``improved_sampler``, ``mean_depth_estimator`` and
``experimental_sampler``, the rest of the conditional zoo ``pix2pix``,
``artist`` and ``info_gan``, and the no-op ``test`` plugin: every model of
hemx, each under hemx's name with hemx's ``arguments()``. The registry is an explicit table rather
than ``hemx``'s package scan.
"""

from __future__ import annotations

import importlib
from typing import Optional

import torch

from hemx_torch.parallel import tp
from hemx_torch.utils import tracing

# name -> "module:Class", imported on lookup
_REGISTRY = {"cnn": "hemx_torch.models.cnn:CnnModel",
             "vae": "hemx_torch.models.vae:VaeModel",
             "gan": "hemx_torch.models.gan:GanModel",
             "wgan": "hemx_torch.models.gan:WganModel",
             "iwgan": "hemx_torch.models.gan:IwganModel",
             "paper_cgan": "hemx_torch.models.paper_cgan:PaperCgan",
             "paper_sampler": "hemx_torch.models.paper_family:PaperSampler",
             "paper_noise": "hemx_torch.models.paper_family:PaperNoise",
             "paper_baseline_sampler":
                 "hemx_torch.models.paper_family:PaperBaselineSampler",
             "paper_standalone":
                 "hemx_torch.models.paper_family:PaperStandalone",
             "paper_baseline_standalone":
                 "hemx_torch.models.paper_family:PaperBaselineStandalone",
             "sampler_gan": "hemx_torch.models.sampler_gan:SamplerGan",
             "improved_sampler":
                 "hemx_torch.models.improved_sampler:ImprovedSampler",
             "mean_depth_estimator":
                 "hemx_torch.models.mean_depth_estimator:MeanDepthEstimator",
             "experimental_sampler":
                 "hemx_torch.models.experimental_sampler:ExperimentalSampler",
             "pix2pix": "hemx_torch.models.pix2pix:Pix2Pix",
             "artist": "hemx_torch.models.artist:Artist",
             "info_gan": "hemx_torch.models.info_gan:InfoGan",
             "test": "hemx_torch.models.fake:FakeTestModel"}


# --dtype -> the compute dtype of every conv, deconv and dense
COMPUTE_DTYPES = {"float32": None, "bfloat16": torch.bfloat16}


class ModelPlugin:
    name: str = ""

    #: Input-batch keys this model consumes, or None for all.
    batch_keys: Optional[tuple] = None

    #: Under ``--spatial_parallel`` the feeders hand this model its height
    #: band of each image leaf (it runs its networks on bands,
    #: ``hemx_torch.parallel.sp``); otherwise whole rows, the same on every
    #: rank of a data index, as hemx's ``_pin_dp`` reshards the
    #: conditional families' batches.
    band_input: bool = False

    @staticmethod
    def arguments() -> dict:
        return {}

    def __init_subclass__(cls, **kwargs):
        # every model's train call is one ``hemx_torch.call`` span
        super().__init_subclass__(**kwargs)
        if "train" in cls.__dict__:
            cls.train = tracing.call(cls.__dict__["train"])

    def __init__(self, args, device):
        self.args = args
        self.device = torch.device(device)
        self.compute_dtype = COMPUTE_DTYPES[getattr(args, "dtype", "float32")]

    def _build(self, image_shape, generator: torch.Generator):
        raise NotImplementedError

    def build_nets(self, image_shape, seed: int):
        """Fresh networks for images of shape (C, H, W), their weights
        drawn on the CPU from ``seed`` (so every device starts from the
        same weights), moved to the model's device; under
        ``--model_parallel`` each rank keeps its slice of every kernel
        (``hemx_torch.parallel.tp.shard_module``)."""
        gen = torch.Generator()
        gen.manual_seed(seed)
        nets = self._build(tuple(image_shape), gen).to(self.device)
        tp.shard_module(nets)
        return nets

    def input_shape(self, host_batch: dict) -> tuple:
        """(C, H, W) of the input the networks are built for: the
        ``image`` key of a host batch (NHWC)."""
        h, w, c = host_batch["image"].shape[1:]
        return (c, h, w)

    def init_state(self, image_shape, seed: int):
        raise NotImplementedError

    def train(self, train_state, stream):
        raise NotImplementedError

    def batches_per_train_call(self) -> int:
        return 1

    def write_summaries(self, writer, step: int, train_state, batch) -> None:
        """Images and scalars of a summary step; none by default, as in
        hemx."""

    def capture_activations(self, train_state, batch) -> Optional[dict]:
        """Per-layer activation stats (``--summarize_activations``); None
        (nothing written) where a model has none, as in hemx."""
        return None

    def grad_report(self, train_state, batch) -> Optional[dict]:
        """Per-parameter gradient stats (``--summarize_gradients``); None
        where a model has none."""
        return None


def get_model(name: str) -> Optional[type]:
    target = _REGISTRY.get(name)
    if target is None:
        return None
    module, cls = target.split(":")
    return getattr(importlib.import_module(module), cls)


def available_models() -> list[str]:
    return sorted(_REGISTRY)
