"""``python -m hemx_torch.paper_metrics`` and ``python -m
hemx_torch.paper_fullimage`` against the root ``paper_metrics.py`` and
``paper_fullimage.py`` on one run.

hemx's ``paper_train.py`` trains one tiny ``paper_cgan`` run
(mean_adjusted, 65 px synthetic uint8 set, batch 2, one call) whose
directory (hemx's options.json, with keys the port does not read, hemx's
checkpoints and mean image) is copied once per package. Each package's
tools run on their copy: ``paper_metrics`` with its defaults (checkpoint
50 absent, so the latest), ``paper_fullimage --scene_shape 96 96 3
--strides 8 4 --n_scenes 2 --chunk 64``. hemx runs at XLA backend level 0.

* ``metrics/eigen_metrics.json``: the same splits, variants (``y_hat``,
  ``y_0``, ``y_mean``) and metrics, each value at rtol 2e-3;
* the per-stride mean RMSE: the port's ``fullimage/rmse.json`` against the
  value hemx prints with four decimals, at rtol 2e-3 plus the print's
  5e-5;
* every PNG the tools write (``mean_depth.png``, each scene's stride and
  comparison images) within one grey level per pixel.

Also: ``load_options`` reads hemx's options.json as hemx's does, and a
missing card or run refuses cleanly.
"""

import contextlib
import io
import json
import re
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tests.test_torch_paper_cgan import (  # noqa: E402,F401
    _hemx_float32, _two_torch_threads, xla_opt0)

TRAIN = ["--model", "paper_cgan", "--model_version", "mean_adjusted",
         "--dataset", "synthetic", "--synthetic_shape", "65", "65", "3",
         "--synthetic_u8", "--synthetic_count", "4", "--synthetic_eval_count",
         "4", "--batch_size", "2", "--epoch_size", "1", "--epochs", "1",
         "--max_to_keep", "1", "--seed", "3", "--n_devices", "1"]
FULLIMAGE = ["--scene_shape", "96", "96", "3", "--strides", "8", "4",
             "--n_scenes", "2", "--chunk", "64"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    import paper_fullimage as HF  # the repo root's tools
    import paper_metrics as HM
    import paper_train as HT
    from hemx_torch import paper_fullimage as TF
    from hemx_torch import paper_metrics as TM
    root = tmp_path_factory.mktemp("eval_tools")
    run = root / "run"
    with xla_opt0(), contextlib.redirect_stdout(io.StringIO()):
        assert HT.main(TRAIN + ["--dir", str(run)]) == 0
    for side in ("hemx", "port"):
        shutil.copytree(run, root / side)
    out = io.StringIO()
    with xla_opt0(), contextlib.redirect_stdout(out):
        assert HM.main(["--dir", str(root / "hemx")]) == 0
        assert HF.main(["--dir", str(root / "hemx")] + FULLIMAGE) == 0
    hemx_rmse = {int(m.group(1)): float(m.group(2)) for m in re.finditer(
        r"stride (\d+): mean rmse ([0-9.]+)", out.getvalue())}
    port = root / "port"
    report = TM.run(["--dir", str(port), "--device", "cpu"])
    full = TF.run(["--dir", str(port), "--device", "cpu"] + FULLIMAGE)
    return {"root": root, "hemx_rmse": hemx_rmse, "report": report,
            "full": full}


def _json(path):
    with open(path) as f:
        return json.load(f)


def test_eigen_metrics_match_hemx(runs):
    got = _json(runs["root"] / "port" / "metrics" / "eigen_metrics.json")
    want = _json(runs["root"] / "hemx" / "metrics" / "eigen_metrics.json")
    assert got == runs["report"]
    assert set(got) == set(want) == {"train", "validate", "test"}
    for split, variants in want.items():
        assert set(got[split]) == set(variants) == {"y_hat", "y_0", "y_mean"}
        for variant, metrics in variants.items():
            assert set(got[split][variant]) == set(metrics)
            for k, v in metrics.items():
                np.testing.assert_allclose(got[split][variant][k], v,
                                           rtol=2e-3,
                                           err_msg=f"{split}/{variant}/{k}")


def test_fullimage_rmse_matches_hemx(runs):
    got = _json(runs["root"] / "port" / "fullimage" / "rmse.json")
    assert got == runs["full"]["rmse"]
    assert sorted(int(s) for s in got) == sorted(runs["hemx_rmse"]) == [4, 8]
    for stride, want in runs["hemx_rmse"].items():
        entry = got[str(stride)]
        assert len(entry["scenes"]) == 2
        np.testing.assert_allclose(entry["mean"], want, rtol=2e-3, atol=5e-5)
    # 2 scenes of 96x96: 4x4 windows at stride 8, 8x8 at stride 4
    assert runs["full"]["patches"] == 2 * (16 + 64)


def test_pngs_match_hemx_within_one_grey_level(runs):
    from hemx_torch.data.imageio import decode_image
    names = ["metrics/mean_depth.png"] + [
        f"fullimage/scene{s}_{kind}.png" for s in range(2)
        for kind in ("stride8", "stride4", "comparison")]
    for name in names:
        want = decode_image((runs["root"] / "hemx" / name).read_bytes(), 1)
        got = decode_image((runs["root"] / "port" / name).read_bytes(), 1)
        assert got.shape == want.shape, name
        diff = np.abs(got.astype(np.int16) - want.astype(np.int16)).max()
        assert diff <= 1, (name, diff)


def test_load_options_reads_hemx_options(runs):
    from hemx.config import load_options as hemx_load
    from hemx_torch.config import load_options
    path = runs["root"] / "hemx" / "options.json"
    opts = load_options(str(path))
    assert opts == hemx_load(str(path))
    assert opts["n_devices"] == 1 and opts["model"] == "paper_cgan"


def test_tools_refuse_cleanly(tmp_path, capsys):
    from hemx_torch import paper_fullimage, paper_metrics
    if not torch.cuda.is_available():  # cuda, the default, without a card
        assert paper_metrics.main(["--dir", str(tmp_path)]) == 1
        assert "no CUDA device" in capsys.readouterr().err
    with pytest.raises(FileNotFoundError):
        paper_fullimage.main(["--dir", str(tmp_path), "--device", "cpu"])
