"""``python -m hemx_torch.experimental`` held against hemx's
``experimental.py``: the mean-depth estimator's train step and the
experimental sampler composed with it.

Both entry points run, each in its own process (hemx at XLA backend level
0, its summary writes left out), on one tiny synthetic set: 8 train images of 64x64, batch 2, one call
per epoch, ``--estimator_epochs 1 --epochs 1``, sgd at lr 0.1 (so one
step moves each weight by a tenth of its gradient, which the parameters'
tolerance then holds; sgd also keeps no moments, which keeps the
estimator's checkpoints to its 280 MB of weights). hemx keeps every
checkpoint; each phase of the port resumes from hemx's checkpoint-0 of
it, so both start from hemx's initial weights. Held:

* the estimator's step: its first-call loss (rtol 5e-4 / atol 1e-5), its
  gradient norm and its parameters after the call (rtol 2e-3 / atol
  2e-5);
* the sampler's first-call ``d_real``, which reads D, the batch and the
  trained estimator's frozen estimate but no noise (rtol 5e-4 / atol
  1e-5); the sampler's lr forced to 1e-4 and the estimator's epoch spec
  passed on as a string, as hemx's.

The states are read from the runs' checkpoints (the estimator's ≈ 280
MB, the sampler's ≈ 160 MB each), deleted after the module.
"""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tests.test_torch_paper_cgan import (  # noqa: E402,F401
    LOSS_TOL, TOL, _hemx_float32, _two_torch_threads, assert_trees_close,
    flat, scalars)


FLAGS = ["--model", "experimental_sampler", "--dataset", "synthetic",
         "--synthetic_shape", "64", "64", "3", "--synthetic_u8",
         "--synthetic_count", "8", "--synthetic_eval_count", "2",
         "--batch_size", "2", "--epoch_size", "1", "--estimator_epochs", "1",
         "--epochs", "1", "--optimizer", "sgd", "--lr", "0.1", "--seed", "7"]
REPO = Path(__file__).resolve().parents[1]
# hemx's entry point on the CPU in its own process, every jax.jit its steps
# make at XLA backend level 0 (as xla_opt0 does: the jits made at import
# stay as they are), its summary writes left out (its montages and
# diagnostic programs are held by tests/test_torch_improved_sampler.py)
HEMX_MAIN = ("import sys, jax\n"
             "jax.config.update('jax_platforms', 'cpu')\n"
             "import experimental\n"
             "from hemx.models import experimental_sampler, "
             "mean_depth_estimator\n"
             "for cls in (experimental_sampler.ExperimentalSampler,\n"
             "            mean_depth_estimator.MeanDepthEstimator):\n"
             "    cls.write_summaries = lambda *a, **k: None\n"
             "jit = jax.jit\n"
             "jax.jit = lambda f, **kw: jit(f, compiler_options={\n"
             "    'xla_backend_optimization_level': 0}, **kw)\n"
             "sys.exit(experimental.main(sys.argv[1:]))\n")


def _losses(tags: dict) -> dict:
    return {k: v for k, v in tags.items() if k.startswith("losses/")}


def _run(argv):
    r = subprocess.run([sys.executable] + argv, cwd=REPO, capture_output=True,
                       text=True, timeout=600,
                       env={**os.environ, "PYTHONPATH": str(REPO)})
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-4000:]
    return r


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """hemx's ``experimental.py`` and ``python -m hemx_torch.experimental``,
    each in its own process. hemx keeps every checkpoint; the port starts
    each phase from hemx's checkpoint-0 of it (its loop resumes from a
    ``--dir`` that holds one), so both start from the same weights."""
    root = tmp_path_factory.mktemp("experimental")
    hemx_dir, port_dir = root / "hemx", root / "port"
    _run(["-c", HEMX_MAIN] + FLAGS + ["--n_devices", "1", "--max_to_keep",
                                      "0", "--dir", str(hemx_dir)])
    for phase in ("estimator", "sampler"):
        (port_dir / phase).mkdir(parents=True)
        shutil.copy(hemx_dir / phase / "checkpoint-0.msgpack",
                    port_dir / phase)
    r = _run(["-m", "hemx_torch.experimental"] + FLAGS + [
        "--max_to_keep", "1", "--device", "cpu", "--dir", str(port_dir)])
    yield {"root": root, "stdout": r.stdout,
           "scalars": {side: {m: scalars(root / side / m / "train")
                              for m in ("estimator", "sampler")}
                       for side in ("hemx", "port")}}
    shutil.rmtree(root)  # the full-width checkpoints


def _state(path):
    from hemx_torch.train.checkpoint import CheckpointManager
    return CheckpointManager(str(path.parent)).restore(str(path))["train_state"]


def test_experimental_estimator_matches_hemx(runs):
    root = runs["root"]
    got = _losses(runs["scalars"]["port"]["estimator"])
    want = _losses(runs["scalars"]["hemx"]["estimator"])
    assert set(got) == set(want)
    assert {"losses/m_loss", "losses/m_grad_norm"} <= set(want)
    np.testing.assert_allclose(got["losses/m_loss"], want["losses/m_loss"],
                               **LOSS_TOL)
    np.testing.assert_allclose(got["losses/m_grad_norm"],
                               want["losses/m_grad_norm"], **TOL)
    start = _state(root / "hemx/estimator/checkpoint-0.msgpack")["params"]
    want = _state(root / "hemx/estimator/checkpoint-1.msgpack")
    mine = _state(root / "port/estimator/checkpoint-1.msgpack")
    assert int(mine["step"]) == int(want["step"]) == 1
    assert sorted(flat(mine["opt"])) == sorted(flat(want["opt"]))
    # the step moved the weights, and to hemx's
    moved = flat(want["params"])
    assert any(np.abs(moved[k] - v).max() > 1e-4
               for k, v in flat(start).items())
    assert_trees_close(mine["params"], want["params"])


def test_experimental_sampler_first_call_matches_hemx(runs):
    got = _losses(runs["scalars"]["port"]["sampler"])
    want = _losses(runs["scalars"]["hemx"]["sampler"])
    assert set(got) == set(want)
    np.testing.assert_allclose(got["losses/d_real"], want["losses/d_real"],
                               **LOSS_TOL)
    summary = json.loads(runs["stdout"].strip().splitlines()[-1])
    assert summary["step"] == 1 and summary["epoch"] == 1
    assert "Resumed from" in runs["stdout"]  # hemx's checkpoint-0, each phase
    with open(runs["root"] / "port/sampler/options.json") as f:
        opts = json.load(f)
    assert opts["lr"] == 1e-4 and opts["dir"].endswith("/sampler")
    with open(runs["root"] / "port/estimator/options.json") as f:
        assert json.load(f)["epochs"] == "1"


def test_experimental_cli_refusals(capsys):
    from hemx_torch import experimental
    if not torch.cuda.is_available():  # cuda, the default, without a card
        assert experimental.main(FLAGS) == 1
        assert "no CUDA device" in capsys.readouterr().err
    assert experimental.main(["--model", "nope", "--device", "cpu"]) == 2
