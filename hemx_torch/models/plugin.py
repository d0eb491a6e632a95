"""Model plugin base + registry (counterpart of ``hemx.models.plugin``).

A model is constructed as ``Model(args, device)``, then:

* ``init_state(image_shape, seed) -> TrainState``;
* ``train(train_state, stream) -> (train_state, metrics)`` — may pull
  several batches from ``stream`` (``batches_per_train_call()`` of them);
* ``eval_losses(train_state, batch) -> metrics`` (validation and test);
* ``write_summaries(writer, step, train_state, batch)``, and for
  ``--summarize_activations`` / ``--summarize_gradients``
  ``capture_activations`` / ``grad_report`` (stats per tensor).

Only ``iwgan`` is ported; the registry is an explicit table rather than
``hemx``'s package scan.
"""

from __future__ import annotations

import importlib
from typing import Optional

# name -> "module:Class", imported on lookup
_REGISTRY = {"iwgan": "hemx_torch.models.gan:IwganModel"}


class ModelPlugin:
    name: str = ""

    #: Input-batch keys this model consumes, or None for all.
    batch_keys: Optional[tuple] = None

    @staticmethod
    def arguments() -> dict:
        return {}

    def __init__(self, args, device):
        self.args = args
        self.device = device

    def init_state(self, image_shape, seed: int):
        raise NotImplementedError

    def train(self, train_state, stream):
        raise NotImplementedError

    def batches_per_train_call(self) -> int:
        return 1


def get_model(name: str) -> Optional[type]:
    target = _REGISTRY.get(name)
    if target is None:
        return None
    module, cls = target.split(":")
    return getattr(importlib.import_module(module), cls)


def available_models() -> list[str]:
    return sorted(_REGISTRY)
