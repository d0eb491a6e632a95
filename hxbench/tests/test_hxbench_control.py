"""The control comes out not ``correct``: the reference put in the
program's place and computed one precision lower than the configuration
states (the IWGAN's bf16 products in float8 e4m3), or the program's own
lower-precision path switched on (pix2pix's float32 in bf16), against the
cell's own limits, at sizes a test holds. ``python -m hxbench.calibrate``
reads the same on the card at the cells' own sizes."""

from __future__ import annotations

import pytest
import torch

from hxbench import judge, session
from hxbench.reference import plain
from hxbench.tests import tiny

SEEDS = [11, 4000000007, 2 ** 33 + 5]


@pytest.mark.parametrize("seed", SEEDS)
def test_iwgan_float8_control(seed):
    cell = tiny.cell("iwgan64-bs512-bf16", dtype="bfloat16")
    cpu = torch.device("cpu")
    ref = judge.reference(cell, seed, cpu)
    control = judge.reference(cell, seed, cpu, round=plain.fp8_e4m3)
    assert not judge.verdict(judge.numbers(control, ref), cell["limits"])


@pytest.mark.parametrize("seed", SEEDS)
def test_pix2pix_bf16_control(seed):
    cell = tiny.cell("pix2pix256-bs64-f32")
    prog = session.Program(cell, seed, "cpu", override={"dtype": "bfloat16"})
    readings = prog.compared()
    prog.close()
    nums = judge.numbers(readings, judge.reference(cell, seed, prog.device))
    assert not judge.verdict(nums, cell["limits"]), nums


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run with -m cuda on the card)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_controls_at_the_cells_own_size(card):
    """On the card at the cells' own sizes: the float8 control of the
    IWGAN and pix2pix's own bf16 path fail their cells' limits."""
    from hxbench import spec
    cell = spec.cell("iwgan64-bs512-bf16")
    ref = judge.reference(cell, 77, card)
    control = judge.reference(cell, 77, card, round=plain.fp8_e4m3)
    assert not judge.verdict(judge.numbers(control, ref), cell["limits"])
    cell = spec.cell("pix2pix256-bs64-f32")
    prog = session.Program(cell, 78, "cuda", override={"dtype": "bfloat16"})
    readings = prog.compared()
    prog.close()
    nums = judge.numbers(readings, judge.reference(cell, 78, card))
    assert not judge.verdict(nums, cell["limits"]), nums
