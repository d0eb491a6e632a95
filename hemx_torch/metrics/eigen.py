"""Eigen et al. (2014) monocular-depth metrics (counterpart of
``hemx.metrics.eigen``; reference: paper_metrics.py:12-35).

The reference's quirks are kept:

* ``abs_rel_diff`` and ``squared_rel_diff`` divide by the prediction
  ``y_hat``, not by the ground truth;
* ``scale_invariant_log_rmse`` is ``mean(d**2) - mean(d)**2`` with no
  square root;
* the threshold accuracies ``t1..t3`` count ``max(y/ŷ, ŷ/y) < 1.25**k``;
* :class:`EigenAccumulator` averages per batch and skips a non-finite
  batch value, so a NaN batch does not poison the split's mean.

Inputs are tensors (or arrays) of any shape; the metrics are computed in
the inputs' dtype on their device, float32 for numpy float32 inputs as in
hemx.
"""

from __future__ import annotations

import math

import torch


def eigen_metrics(y, y_hat, eps: float = 1e-8) -> dict:
    """{metric name: 0-d tensor} of one batch."""
    y, y_hat = torch.as_tensor(y), torch.as_tensor(y_hat)
    linear_rmse = torch.sqrt(torch.mean((y - y_hat) ** 2))
    d = torch.log(y + eps) - torch.log(y_hat + eps)
    log_rmse = torch.sqrt(torch.mean(d ** 2))
    abs_rel_diff = torch.mean(torch.abs(y - y_hat) / y_hat)
    squared_rel_diff = torch.mean((y - y_hat) ** 2 / y_hat)
    scale_invariant_log_rmse = torch.mean(d ** 2) - torch.mean(d) ** 2
    delta = torch.maximum(y / y_hat, y_hat / y)
    return {
        "linear_rmse": linear_rmse,
        "log_rmse": log_rmse,
        "abs_rel_diff": abs_rel_diff,
        "squared_rel_diff": squared_rel_diff,
        "scale_invariant_log_rmse": scale_invariant_log_rmse,
        "t1": torch.mean((delta < 1.25).float()),
        "t2": torch.mean((delta < 1.25 ** 2).float()),
        "t3": torch.mean((delta < 1.25 ** 3).float()),
    }


class EigenAccumulator:
    """Streaming mean of per-batch metrics over a split (the reference's
    running means, paper_metrics.py:115-163); a non-finite batch value is
    skipped and the mean taken over the batches left."""

    def __init__(self):
        self._sums: dict[str, float] = {}
        self._counts: dict[str, int] = {}

    def update(self, metrics: dict) -> None:
        for k, v in metrics.items():
            v = float(v)
            if not math.isfinite(v):
                continue
            self._sums[k] = self._sums.get(k, 0.0) + v
            self._counts[k] = self._counts.get(k, 0) + 1

    def result(self) -> dict:
        return {k: self._sums[k] / self._counts[k] for k in self._sums}
