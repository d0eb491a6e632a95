"""Experimental sampler: the E1 generator and critic conditioned on a
trained mean-depth estimator (counterpart of
``hemx.models.experimental_sampler``; reference:
hem/models/experimental_sampler.py, driven by ``python -m
hemx_torch.experimental``).

* G's and D's input is ``[x, x_loc, y_loc, mean_estimate]``: the image in
  [-1, 1], the two location channels and the per-image mean-depth
  estimate broadcast to a constant channel; the target depth is cropped
  (16, 16, 32, 32).
* :meth:`ExperimentalSampler.set_estimator` composes it with a
  ``mean_depth_estimator`` and its train state: the estimate is its
  ``predict_mean`` on the batch, computed under ``torch.no_grad()``
  outside the sampler's step, so no gradient reaches the estimator.
  Uncomposed, the estimate is the mean of the batch's ``mean`` key, or of
  its depth when the batch has none (hemx's own fallback).
* Everything else is :class:`ImprovedSampler`'s (its ``--g_sparsity`` and
  ``--g_rmse`` included): a D step and a G step on the same batch.
"""

from __future__ import annotations

import torch

from hemx_torch.models.improved_sampler import (DISC_SPECS, GEN_SPECS,
                                                ImprovedSampler)
from hemx_torch.ops.images import crop_to_bounding_box


class ExperimentalSampler(ImprovedSampler):
    name = "experimental_sampler"

    @staticmethod
    def arguments() -> dict:
        return {
            "--g_sparsity": dict(action="store_true", default=False),
            "--g_rmse": dict(action="store_true", default=False),
            "--estimator_epochs": dict(type=int, default=30,
                                       help="Phase-1 estimator epochs of "
                                            "python -m hemx_torch."
                                            "experimental."),
        }

    def __init__(self, args, device, estimator=None):
        super().__init__(args, device)
        self.estimator = estimator
        self.estimator_ts = None

    def set_estimator(self, estimator, estimator_ts) -> None:
        self.estimator = estimator
        self.estimator_ts = estimator_ts

    def composed(self) -> bool:
        return self.estimator is not None and self.estimator_ts is not None

    def extras(self) -> tuple:
        return ("x_loc", "y_loc", "mean_estimate")

    @property
    def batch_keys(self) -> tuple:
        if self.composed():
            return ("image", "depth", "x_loc", "y_loc", "x_full", "y_full")
        return ("image", "depth", "x_loc", "y_loc", "mean")

    def gen_spec(self) -> dict:
        return GEN_SPECS["E1"]

    def disc_spec(self) -> dict:
        return DISC_SPECS["E1"]

    @torch.no_grad()
    def mean_channel(self, batch: dict) -> torch.Tensor:
        """(B, 1, 1, 1) mean-depth estimate, frozen for the sampler."""
        if self.composed():
            m = self.estimator.predict_mean(self.estimator_ts, batch)
            return m.reshape(-1, 1, 1, 1)
        key = "mean" if "mean" in batch else "depth"
        return torch.mean(batch[key], dim=(1, 2, 3), keepdim=True)

    def attach_mean(self, batch: dict) -> dict:
        if "mean_estimate" in batch:
            return batch
        return {**batch, "mean_estimate": self.mean_channel(batch)}

    def prepare(self, batch: dict) -> dict:
        batch = self.attach_mean(batch)
        x = 2.0 * (batch["image"] - 0.5)
        y = crop_to_bounding_box(2.0 * (batch["depth"] - 0.5), 16, 16, 32, 32)
        n, _, h, w = x.shape
        mean = batch["mean_estimate"].reshape(-1, 1, 1, 1).expand(n, 1, h, w)
        x = torch.cat([x, batch["x_loc"], batch["y_loc"], mean], dim=1)
        return {"g_input": x, "y": y, "d_x": x}

    def substeps(self, stream):
        """The estimate once per call, for both steps."""
        batch = self.attach_mean(next(stream))
        yield batch, self.d_step
        yield batch, self.g_step

    def write_summaries(self, writer, step, ts, batch, diag=None) -> None:
        super().write_summaries(writer, step, ts, self.attach_mean(batch),
                                diag)
