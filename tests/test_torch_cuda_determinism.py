"""Repeatability of one training call on a CUDA device, the reason
``chip_smoke.py`` phase 17 (a) runs cuDNN's deterministic algorithms.

One process repeats the gan call of phase 17 (a) (``chip_smoke.DP_SMALL``:
32x32x3, batch 8, latent 16, momentum, ``--precision highest``) on
identical inputs: the start state, the gathered batches and the noise are
equal by hash from run to run. Under cuDNN's deterministic algorithms
every run ends in the same state bit for bit; under its default ones the
test prints how many runs end with an optimizer state (whose trace is the
raw gradient) outside phase 17 (a)'s tolerance of the most common one,
without asserting it. Needs the card; run it there with
``python -m pytest tests/test_torch_cuda_determinism.py -m cuda -s
--noconftest``.
"""

import hashlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

RUNS = 24
#: chip_smoke phase 17 (a)'s tolerance for the optimizer state
TOL = dict(rtol=2e-3, atol=2e-5)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the run compares cuDNN's "
                    "algorithms, which the CPU does not have)")
    return torch.device("cuda:0")


def _end_states(device, workdir, deterministic: bool, runs: int) -> list:
    """Each run's (hash of its inputs, the flattened end state)."""
    from chip_smoke import DP_SMALL
    from hemx_torch import cli
    from hemx_torch.convert import flatten_tree
    from hemx_torch.data import pipeline
    from hemx_torch.models import common
    from hemx_torch.train.checkpoint import CheckpointManager

    flags = {name: f for name, _, _, f in DP_SMALL}["gan"]
    gather, draw = pipeline.gather_u8_normalize, common.draw_noise
    seen = hashlib.sha1()

    def hashed(t):
        seen.update(t.detach().contiguous().cpu().numpy().tobytes())
        return t

    def gather_hashed(*a, **k):
        return hashed(gather(*a, **k))

    def draw_hashed(*a, **k):
        out = draw(*a, **k)
        for v in out.values():
            hashed(v)
        return out

    before = torch.backends.cudnn.deterministic
    pipeline.gather_u8_normalize = gather_hashed
    common.draw_noise = draw_hashed
    torch.backends.cudnn.deterministic = deterministic
    out = []
    try:
        for i in range(runs):
            seen = hashlib.sha1()
            d = str(workdir / f"{int(deterministic)}-{i}")
            cli.run(["--dataset", "synthetic", "--synthetic_u8",
                     "--synthetic_count", "32", "--synthetic_eval_count",
                     "16", "--synthetic_shape", "32", "32", "3", "--epochs",
                     "1", "--epoch_size", "1", "--precision", "highest",
                     "--device", str(device), "--seed", "3", "--batch_size",
                     "8", "--dir", d] + flags)
            m = CheckpointManager(d)
            start = flatten_tree(m.restore(dict(m.checkpoints())[0])[
                "train_state"])
            for k in sorted(start):
                seen.update(np.asarray(start[k]).tobytes())
            out.append((seen.hexdigest(), flatten_tree(
                m.restore()["train_state"])))
    finally:
        pipeline.gather_u8_normalize, common.draw_noise = gather, draw
        torch.backends.cudnn.deterministic = before
    return out


def _state_bytes(tree) -> bytes:
    return b"".join(np.asarray(tree[k]).tobytes() for k in sorted(tree))


@pytest.mark.cuda
def test_gan_call_repeats_bit_for_bit_under_deterministic_cudnn(
        cuda_device, tmp_path):
    default = _end_states(cuda_device, tmp_path, False, RUNS)
    exact = _end_states(cuda_device, tmp_path, True, RUNS)
    assert len({h for h, _ in default + exact}) == 1, "inputs differ"
    assert len({_state_bytes(t) for _, t in exact}) == 1

    def close(a, b):
        return all(np.allclose(np.asarray(v), np.asarray(b[k]), **TOL)
                   for k, v in a.items() if k[0] == "opt")

    states = [t for _, t in default]
    ref = max(states, key=lambda a: sum(close(a, b) for b in states))
    apart = [t for t in states if not close(t, ref)]
    worst = max((float(np.abs(np.asarray(v) - np.asarray(ref[k])).max())
                 for t in states for k, v in t.items()
                 if k[0] == "opt" and np.asarray(v).size), default=0.0)
    print(f"\n{torch.cuda.get_device_name(0)}: gan call, {RUNS} runs on "
          f"identical inputs under cuDNN's default algorithms: "
          f"{len(apart)} end with an optimizer state outside rtol "
          f"{TOL['rtol']} / atol {TOL['atol']} of the most common one "
          f"(largest difference {worst:.3g}); under its deterministic "
          f"ones all {RUNS} end in one state, bit for bit")
