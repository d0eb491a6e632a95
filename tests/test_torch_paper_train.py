"""hemx_torch.paper_train (the port of the root paper_train.py).

* The dataset depth moments over train + validate equal paper_train.py's
  (``dataset_depth_moments``) exactly, for uint8 depth (widened before it
  is squared) at 65 px, where the (17, 17, 29, 29) crop applies, and for
  float depth at 32 px, where it does not; ``mean_image.png``,
  ``var_image.png`` and ``mean_image.npy`` are byte-equal to the files
  paper_train.py writes from them.
* ``python -m hemx_torch.paper_train --model paper_standalone ... --device
  cpu`` trains at a tiny size, writes the three files and the Eigen
  summaries against the mean image, and ``--epochs +1`` resumes from its
  checkpoint; an unknown model exits 2 and ``--device cuda`` without a
  card exits 1, as ``cli.py`` does.
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

from tests.conftest import make_args  # noqa: E402

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def _hemx_float32():
    """hemx's compute dtype and precision are process-wide: compare
    against, and leave behind, hemx's float32 defaults."""
    from hemx.ops import layers
    layers.set_compute_dtype(None)
    layers.set_default_precision("default")
    yield
    layers.set_compute_dtype(None)
    layers.set_default_precision("default")


def _hemx_files(directory, mean_img, var_img):
    """The three files as paper_train.py's main() writes them."""
    from hemx.summaries.montage import to_uint8
    from hemx.summaries.png import encode_png
    with open(os.path.join(directory, "mean_image.png"), "wb") as f:
        f.write(encode_png(to_uint8(mean_img)))
    with open(os.path.join(directory, "var_image.png"), "wb") as f:
        rng = var_img.max() - var_img.min()
        f.write(encode_png(to_uint8((var_img - var_img.min())
                                    / max(rng, 1e-12))))
    np.save(os.path.join(directory, "mean_image.npy"), mean_img)


@pytest.mark.parametrize("size,u8", [(65, True), (32, False)])
def test_depth_moments_and_files_match_paper_train(tmp_path, size, u8):
    import paper_train as H  # the repo root is on sys.path under pytest
    from hemx.data.synthetic import SyntheticDataset as HD
    from hemx_torch import paper_train as T
    from hemx_torch.data.synthetic import SyntheticDataset as TD
    args = make_args(synthetic_count=10, synthetic_eval_count=6,
                     synthetic_shape=[size, size, 3], synthetic_u8=u8,
                     batch_size=4)
    want = H.dataset_depth_moments(HD.get_datasets(args), args)
    got = T.dataset_depth_moments(TD.get_datasets(args), args)
    side = 29 if size >= 46 else size
    for g, w in zip(got, want):
        assert g.shape == w.shape == (side, side)
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    (tmp_path / "h").mkdir()
    (tmp_path / "t").mkdir()
    _hemx_files(tmp_path / "h", *want)
    T.write_moments(str(tmp_path / "t"), *got)
    for name in ("mean_image.png", "var_image.png", "mean_image.npy"):
        assert (tmp_path / "t" / name).read_bytes() == \
            (tmp_path / "h" / name).read_bytes(), name


def _run(args):
    return subprocess.run([sys.executable, "-m", "hemx_torch.paper_train"]
                          + args, cwd=REPO, capture_output=True, text=True,
                          timeout=300, env={**os.environ, "PYTHONPATH": str(REPO)})


TINY = ["--model", "paper_standalone", "--model_version", "mean_adjusted",
        "--dataset", "synthetic", "--synthetic_shape", "65", "65", "3",
        "--synthetic_u8", "--synthetic_count", "8", "--synthetic_eval_count",
        "4", "--batch_size", "2", "--epoch_size", "2", "--seed", "7",
        "--max_to_keep", "2", "--device", "cpu"]


def test_paper_train_cli_trains_and_resumes(tmp_path):
    from hemx_torch.summaries.reader import get_all_events
    r = _run(TINY + ["--epochs", "1", "--dir", str(tmp_path)])
    assert r.returncode == 0, r.stderr
    assert json.loads(r.stdout.strip().splitlines()[-1])["step"] == 2
    files = set(os.listdir(tmp_path))
    assert {"mean_image.png", "var_image.png", "mean_image.npy",
            "checkpoint-0.msgpack", "checkpoint-1.msgpack"} <= files
    assert np.load(tmp_path / "mean_image.npy").shape == (29, 29)
    tags = set(get_all_events(str(tmp_path / "train")))
    for prefix in ("metrics_y_hat/", "metrics_y_0/", "metrics_y_mean/",
                   "losses/rmse"):
        assert any(t.startswith(prefix) for t in tags), prefix
    r = _run(TINY + ["--epochs", "+1", "--dir", str(tmp_path)])
    assert r.returncode == 0, r.stderr
    summary = json.loads(r.stdout.strip().splitlines()[-1])
    assert summary["step"] == 4 and summary["epoch"] == 2
    assert "checkpoint-2.msgpack" in os.listdir(tmp_path)
    assert "checkpoint-0.msgpack" not in os.listdir(tmp_path)  # kept 2
    shutil.rmtree(tmp_path)  # full-width checkpoints, ≈ 120 MB each


def test_paper_train_unknown_model_exits_2(capsys):
    from hemx_torch import paper_train
    assert paper_train.main(["--model", "nope", "--dataset", "synthetic",
                             "--device", "cpu"]) == 2
    assert "paper_cgan" in capsys.readouterr().err


def test_paper_train_cuda_without_gpu_fails(capsys):
    """--device cuda (the default) without a card is refused before any
    data is made; nothing falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from hemx_torch import paper_train
    assert paper_train.main(["--model", "paper_cgan", "--dataset",
                             "synthetic"]) == 1
    assert "no CUDA device" in capsys.readouterr().err
