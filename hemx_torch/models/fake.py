"""The ``test`` plugin (counterpart of ``hemx.models.fake``): a no-op model
that proves plugin discovery and that a plugin's flags (``--test_arg``)
reach the CLI. A call pulls one batch and reports ``loss`` 0; its train
state holds no networks."""

from __future__ import annotations

import torch
import torch.nn as nn

from hemx_torch.models import common
from hemx_torch.models.plugin import ModelPlugin


class FakeTestModel(ModelPlugin):
    name = "test"

    @staticmethod
    def arguments() -> dict:
        return {"--test_arg": dict(type=int, default=1,
                                   help="Proves plugin args reach the CLI.")}

    def init_state(self, image_shape, seed: int) -> common.TrainState:
        return common.new_train_state(nn.Module(), {}, seed)

    def train(self, ts: common.TrainState, stream):
        next(stream)
        return ts, {"loss": torch.zeros((), device=self.device)}

    def eval_losses(self, ts: common.TrainState, batch: dict) -> dict:
        return {"loss": torch.zeros((), device=self.device)}
