"""A cell's path across cards, on the CPU: two gloo ranks at small sizes,
each holding the cached rows and running the reference at the global
batch. A sound run comes out ``correct``; one whose exchange between the
ranks is left out (the gradient all-reduce a no-op), whose batches are
half left out (the mean taken over the rest), or whose state stays
unchanged, does not."""

from __future__ import annotations

import json
import time

import pytest


def _worker(rank: int, port: int, fault: str, out: str) -> None:
    import torch
    torch.set_num_threads(1)
    from hxbench import run
    from hxbench.tests import tiny
    if fault == "no_exchange":
        from hemx_torch.parallel import dp
        dp.all_reduce_grads = lambda grads: None
    elif fault == "half_batch":
        from hemx_torch.data import pipeline
        assemble = pipeline.DeviceDataPipeline._assemble

        def half(self, idx, parts):
            out = []
            for batch in assemble(self, idx, parts):
                n = next(iter(batch.values())).shape[0] // 2
                out.append({k: torch.cat([v[:n], v[:n]])
                            for k, v in batch.items()})
            return out
        pipeline.DeviceDataPipeline._assemble = half
    elif fault == "state_unchanged":
        from hemx_torch.train import optimizers
        optimizers.Optimizer.step = lambda self, grads: None
    cell = tiny.cell("iwgan64-bs512-bf16", devices=2, batch=4)
    result = run.run_rank(cell, 98765432101, 0.5, False, device="cpu",
                          rank=rank, port=port, t0=time.perf_counter())
    if rank == 0:
        with open(out, "w") as f:
            json.dump(result, f)


@pytest.mark.parametrize("fault,correct", [("none", True),
                                           ("no_exchange", False),
                                           ("half_batch", False),
                                           ("state_unchanged", False)])
def test_two_ranks(fault, correct, tmp_path):
    import torch.multiprocessing as mp

    from hxbench import run
    out = str(tmp_path / "result.json")
    mp.spawn(_worker, args=(run._free_port(), fault, out), nprocs=2,
             join=True)
    with open(out) as f:
        result = json.load(f)
    assert result["correct"] is correct, result["checks"]
    assert result["device"]["count"] == 2
