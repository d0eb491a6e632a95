"""``--n_devices 2`` through the port's entry points on the CPU: two gloo
worker processes against one process at the global batch.

For each of five configurations -- iwgan (the GP norm), gan (BN, a real
then a fake pass), vae (sum-reduced losses), paper_standalone through
``paper_train`` (the rmse loss) and pix2pix at 32 px (``--dropout 0.5``,
BN in G and D: sliced keep masks) -- ``python -m hemx_torch.<entry>
--device cpu --n_devices 2 --batch_size 4`` trains one call, and so do
the same flags with ``--batch_size 8`` through the entry point's ``run``
in this process. Here the port
draws its own noise (for the global batch, each rank keeping its rows), so
the two runs see the same rows and the same draws. Checkpoint 1
(parameters, BN statistics, optimizer state), the reported losses in the
train and validate events, and the summary line must agree: losses rtol
5e-4 / atol 1e-5 (``grad_norm`` rtol 1e-3), the rest rtol 2e-3 / atol
2e-5, the one-device tests' tolerances. The VAE's state, ``grad_norm``
and validation losses (taken after the step) are held at rtol 2e-2 (the
state at atol 1e-2 besides): its summed losses make one sgd step at lr 1e-4 move
the encoder's weights by up to 0.83, and its float32 KL gradient at
``z_stddev`` near 0 is ill-conditioned, so the two runs' steps differ by
0.67-0.75 % (in float64 the ranks' gradients agree to 1e-13, see
``tests/test_torch_dp_gan.py``); averaging the summed losses in place of
summing them would halve the gradient, 50 % of the step. hemx at two devices is held against the same
calls, with its own draws, in ``tests/test_torch_dp_gan.py`` and
``tests/test_torch_dp_depth.py``.

Then the two-rank IWGAN's checkpoint resumes in one process at the global
batch (``--epochs +1``) to the one-process run's next state, hemx restores
it, and its ``options.json`` records ``n_devices`` 2.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tests.test_torch_dp_gan import LOSS_TOL, TOL, assert_close  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
COMMON = ["--dataset", "synthetic", "--synthetic_u8", "--synthetic_count",
          "16", "--synthetic_eval_count", "8", "--epochs", "1",
          "--epoch_size", "1", "--device", "cpu", "--seed", "3"]
SMALL = ["--synthetic_shape", "32", "32", "3", "--latent_size", "16"]
VAE_TOL = dict(rtol=2e-2, atol=1e-2)
MOMENTUM = ["--optimizer", "momentum", "--lr", "1e-3", "--momentum", "0.5"]
CONFIGS = {
    "iwgan": ("cli", ["--model", "iwgan", "--n_disc_train", "2"] + SMALL
              + MOMENTUM),
    "gan": ("cli", ["--model", "gan"] + SMALL + MOMENTUM),
    "vae": ("cli", ["--model", "vae", "--optimizer", "sgd", "--lr", "1e-4"]
            + SMALL),
    "paper_standalone": ("paper_train", [
        "--model", "paper_standalone", "--model_version", "mean_provided",
        "--synthetic_shape", "65", "65", "3"]),
    # sgd: Adam's first step, lr * g / (|g| + 1e-8), turns the rounding
    # noise in the ~0 gradient of a bias under BN into updates of +-lr
    "pix2pix": ("cli", ["@" + str(REPO / "examples" / "pix2pix" /
                                  "no_l1.config"),
                        "--synthetic_shape", "32", "32", "3",
                        "--optimizer", "sgd", "--lr", "1e-3"]),
}


def _argv(argv):
    """``argv`` with its config file first, so later flags override the
    file's."""
    return sorted(argv, key=lambda a: not a.startswith("@"))


def run(entry, argv, timeout=300):
    """``python -m hemx_torch.<entry>`` with ``argv``; the summary line.
    Each of its two workers takes one intra-op thread."""
    r = subprocess.run([sys.executable, "-m", f"hemx_torch.{entry}"]
                       + _argv(argv), cwd=REPO, capture_output=True,
                       text=True, timeout=timeout,
                       env={**os.environ, "PYTHONPATH": str(REPO),
                            "OMP_NUM_THREADS": "2"})
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-4000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


def run_here(entry, argv):
    """The entry point's run in this process; its summary line."""
    import importlib
    module = importlib.import_module(f"hemx_torch.{entry}")
    return module.run(_argv(argv))["summary"]


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def losses(workdir, phase):
    from hemx_torch.summaries.reader import get_all_events
    return {(tag, step): v for tag, rows in
            get_all_events(os.path.join(workdir, phase)).items()
            if tag.startswith("losses/") for _, step, v in rows}


def state(workdir, epoch=1):
    from hemx_torch.train.checkpoint import CheckpointManager
    m = CheckpointManager(str(workdir))
    return m.restore(dict(m.checkpoints())[epoch])["train_state"]


@pytest.fixture(scope="module")
def pairs(tmp_path_factory):
    """``pairs(name)``: the two-rank and the one-process run of a
    configuration (workdir, both summary lines), each made once."""
    made = {}

    def get(name):
        if name not in made:
            entry, flags = CONFIGS[name]
            tmp = tmp_path_factory.mktemp(f"dp_cli_{name}")
            two = run(entry, COMMON + flags + [
                "--batch_size", "4", "--n_devices", "2",
                "--dir", str(tmp / "two")])
            one = run_here(entry, COMMON + flags + [
                "--batch_size", "8", "--dir", str(tmp / "one")])
            made[name] = tmp, two, one
        return made[name]
    return get


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_two_ranks_match_one_process(pairs, name):
    tmp, two, one = pairs(name)
    assert two["processes"] == 2 and one["processes"] == 1
    assert two["global_batch"] == one["global_batch"] == 8
    assert two["step"] == one["step"] == 1
    assert two["grad_all_reduce"]["collectives"] >= 1
    a, b = state(tmp / "two"), state(tmp / "one")
    for part in ("params", "mstate", "opt"):
        assert_close(a[part], b[part], VAE_TOL if name == "vae" else TOL)
    for phase in ("train", "validate"):
        got, want = losses(tmp / "two", phase), losses(tmp / "one", phase)
        assert got.keys() == want.keys() and want
        for k in want:
            tol = LOSS_TOL
            if name == "vae" and (phase == "validate"
                                  or k[0] == "losses/grad_norm"):
                tol = dict(rtol=VAE_TOL["rtol"], atol=0)
            elif k[0] == "losses/grad_norm":
                tol = dict(rtol=1e-3, atol=0)
            np.testing.assert_allclose(got[k], want[k], err_msg=str(k), **tol)
    assert sorted(os.listdir(tmp / "two")) == sorted(os.listdir(tmp / "one"))


def test_options_record_n_devices(pairs):
    """``n_devices`` lands in ``options.json`` and ``options.config``, and
    ``load_options`` reads it back."""
    from hemx_torch.config import load_options
    tmp, _, _ = pairs("gan")
    assert load_options(str(tmp / "two" / "options.json"))["n_devices"] == 2
    assert load_options(str(tmp / "one" / "options.json"))["n_devices"] == 0
    with open(tmp / "two" / "options.config") as f:
        assert "n_devices 2\n" in f.read()


def test_two_rank_checkpoint_resumes_in_one_process_and_in_hemx(pairs):
    """The two-rank IWGAN's checkpoint: one process at the global batch
    carries it on as the one-process run carries its own, and hemx
    restores it into its own train state."""
    tmp, _, _ = pairs("iwgan")
    flags = CONFIGS["iwgan"][1] + ["--batch_size", "8", "--epochs", "+1"]
    for d in ("two", "one"):
        run_here("cli", COMMON + flags + ["--dir", str(tmp / d)])
    a, b = state(tmp / "two", 2), state(tmp / "one", 2)
    assert int(a["step"]) == int(b["step"]) == 2
    for part in ("params", "mstate", "opt"):
        assert_close(a[part], b[part], TOL)
    _hemx_restores(tmp / "two")


def _hemx_restores(workdir):
    import jax

    from hemx.models.plugin import get_model
    from hemx.parallel.mesh import make_mesh
    from hemx.train.checkpoint import CheckpointManager
    from tests.conftest import make_args
    args = make_args(model="iwgan", batch_size=8, latent_size=16,
                     n_disc_train=2, optimizer="momentum", lr=1e-3,
                     momentum=0.5)
    model = get_model("iwgan")(args, make_mesh(1))
    ts = model.init_state(jax.random.PRNGKey(3),
                          {"image": np.zeros((8, 32, 32, 3), np.float32)})
    m = CheckpointManager(str(workdir))
    wrapper = m.restore({"train_state": ts, "epoch": np.int64(0)},
                        m.latest())
    got = state(workdir, 2)
    assert int(wrapper["epoch"]) == 2
    for part in ("params", "mstate"):
        assert_close(jax.device_get(wrapper["train_state"])[part], got[part],
                     dict(rtol=0, atol=0))
