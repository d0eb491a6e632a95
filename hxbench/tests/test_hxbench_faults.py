"""A run with the timed path broken underneath comes out not ``correct``
(the harness's look for a chip skipped, on the CPU at small sizes): once
for each fault a training cell can have. A sound run at the same size
comes out ``correct``, so each fault is what fails it."""

from __future__ import annotations

import time

import pytest
import torch

from hxbench import run
from hxbench.tests import tiny

CELLS = ["iwgan64-bs512-bf16", "pix2pix256-bs64-f32"]


def _correct(cell) -> bool:
    out = run.run_rank(cell, 1234567890123, 0.5, False, device="cpu",
                       t0=time.perf_counter())
    return out["correct"]


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name):
    assert _correct(tiny.cell(name))


def _unchanged(monkeypatch):
    from hemx_torch.train import optimizers
    monkeypatch.setattr(optimizers.Optimizer, "step",
                        lambda self, grads: None)


def _half_batch(monkeypatch):
    """Each batch's second half replaced by its first: the mean is taken
    over half the rows."""
    from hemx_torch.data import pipeline
    assemble = pipeline.DeviceDataPipeline._assemble

    def half(self, idx, parts):
        out = []
        for batch in assemble(self, idx, parts):
            n = next(iter(batch.values())).shape[0] // 2
            out.append({k: torch.cat([v[:n], v[:n]]) for k, v in
                        batch.items()})
        return out
    monkeypatch.setattr(pipeline.DeviceDataPipeline, "_assemble", half)


def _answer_altered(monkeypatch):
    """The generator's loss 5 % off where it is computed (and so its
    gradient, which Adam's update does not see): the IWGAN's losses are
    bf16 values, a step of up to 0.8 %, so its limit is 2 %."""
    from hemx_torch.ops import losses
    g_loss = losses.wgan_g_loss
    monkeypatch.setattr(losses, "wgan_g_loss", lambda d: 1.05 * g_loss(d))
    xent = losses.sigmoid_xent
    monkeypatch.setattr(losses, "sigmoid_xent",
                        lambda z, y: 1.05 * xent(z, y))


FAULTS = {"state_unchanged": _unchanged, "half_batch": _half_batch,
          "answer_altered": _answer_altered}


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_fault_is_not_correct(name, fault, monkeypatch):
    FAULTS[fault](monkeypatch)
    assert not _correct(tiny.cell(name))
