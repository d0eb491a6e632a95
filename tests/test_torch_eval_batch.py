"""The evaluation tools score a run at hemx's global batch.

hemx's ``paper_metrics.py`` builds ``make_mesh(n_devices or 1)`` and
iterates each split at ``batch_size * devices`` rows, the remainder
dropped; the Eigen metrics are taken per batch and averaged, so the batch
decides both which rows are scored and the result. One tiny
``paper_standalone`` run is trained by the port (``python -m
hemx_torch.paper_train``, 8 train and 12 evaluation rows at batch 4), and
its ``options.json`` is then given ``n_devices 2``: hemx scores one batch
of 8 rows per split, a tool that ignores ``n_devices`` would score 2
batches of 4 (train) and 3 of 4 (validate, test). hemx's tool runs on the
tests' 8-device CPU mesh, the port's on the CPU in one process, each on a
copy of the run; their ``eigen_metrics.json`` agree at rtol 1e-4.

On a card (marked ``cuda``; no JAX is imported there) a run asking for
more devices than the host has is refused in hemx's words.
"""

import contextlib
import io
import json
import os
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")

TRAIN = ["--model", "paper_standalone", "--model_version", "mean_adjusted",
         "--dataset", "synthetic", "--synthetic_shape", "65", "65", "3",
         "--synthetic_u8", "--synthetic_count", "8", "--synthetic_eval_count",
         "12", "--batch_size", "4", "--epoch_size", "1", "--epochs", "1",
         "--seed", "5", "--device", "cpu"]


def _set_n_devices(run, n):
    path = run / "options.json"
    opts = json.loads(path.read_text())
    opts["n_devices"] = n
    path.write_text(json.dumps(opts))


@pytest.fixture(scope="module")
def scored(tmp_path_factory):
    import paper_metrics as HM  # the repo root's tool
    from hemx.ops import layers
    from hemx_torch import paper_train
    from hemx_torch import paper_metrics as TM
    from tests.test_torch_paper_cgan import xla_opt0
    root = tmp_path_factory.mktemp("eval_batch")
    run = root / "run"
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            paper_train.run(TRAIN + ["--dir", str(run)])
        _set_n_devices(run, 2)
        for side in ("hemx", "port"):
            shutil.copytree(run, root / side, copy_function=os.link)
        layers.set_compute_dtype(None)
        layers.set_default_precision("default")
        with xla_opt0(), contextlib.redirect_stdout(io.StringIO()):
            assert HM.main(["--dir", str(root / "hemx")]) == 0
        with contextlib.redirect_stdout(io.StringIO()):
            report = TM.run(["--dir", str(root / "port"), "--device", "cpu"])
    finally:
        torch.set_num_threads(before)
    read = lambda side: json.loads(
        (root / side / "metrics" / "eigen_metrics.json").read_text())
    return {"hemx": read("hemx"), "port": read("port"), "report": report,
            "root": root}


def test_paper_metrics_at_hemx_global_batch(scored):
    want, got = scored["hemx"], scored["port"]
    assert got == scored["report"]
    assert set(got) == set(want) == {"train", "validate", "test"}
    for split, variants in want.items():
        assert set(got[split]) == set(variants) == {"y_hat", "y_0", "y_mean"}
        for variant, metrics in variants.items():
            assert set(got[split][variant]) == set(metrics)
            for k, v in metrics.items():
                np.testing.assert_allclose(got[split][variant][k], v,
                                           rtol=1e-4,
                                           err_msg=f"{split}/{variant}/{k}")


def test_batch_decides_the_result(scored):
    """The sizes make the batch matter: at one device's batch the
    validation metrics differ from hemx's well beyond the tolerance."""
    from hemx_torch import paper_metrics as TM
    from hemx_torch.runs import global_batch, restore_run
    run = str(scored["root"] / "port")
    args, splits, model, ts, host_batch, _ = restore_run(run, "cpu")
    assert global_batch(args, "cpu") == 8 and host_batch["image"].shape[0] == 8
    args.n_devices = 1
    one = TM.evaluate_split(model, ts, splits["validate"], args, "cpu")
    want = scored["hemx"]["validate"]["y_hat"]["linear_rmse"]
    assert abs(one["y_hat"]["linear_rmse"] - want) > 1e-3 * abs(want)


def test_n_devices_zero_is_one_device(scored):
    from hemx_torch.runs import global_batch
    import types
    for n in (0, None, 1):
        assert global_batch(types.SimpleNamespace(batch_size=4, n_devices=n),
                            "cpu") == 4
    assert global_batch(types.SimpleNamespace(batch_size=4, n_devices=3),
                        "cpu") == 12


@pytest.mark.cuda
def test_too_many_devices_refused_on_cuda(tmp_path, capsys):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from hemx_torch import paper_metrics
    n = torch.cuda.device_count() + 1
    (tmp_path / "options.json").write_text(json.dumps(
        {"model": "paper_standalone", "batch_size": 4, "n_devices": n,
         "dataset": "synthetic"}))
    assert paper_metrics.main(["--dir", str(tmp_path)]) == 1
    assert (f"requested {n} devices but only {n - 1} available"
            in capsys.readouterr().err)
