"""hemx's ``model`` and ``spatial`` axes through the port's entry points.

* The CLI's run with ``--device cpu --n_devices 4 --model_parallel 2``
  (and ``--spatial_parallel 2``) in a group of four gloo processes (as
  under torchrun; ``cli.main``'s own spawn of the ranks runs below) trains
  the CNN and the IWGAN two epochs and ends finite, with the global batch
  ``batch_size * 2`` (hemx's ``batch_size * data_axis_size``), as hemx's
  loop tests do (``tests/test_models.py:626-651, 840-861``); the spatial
  IWGAN streams (``--no-device_data_cache``, the band cut on the host),
  the others read the device cache (the input kernel's band).
* The refusals, in hemx's words: both axes at once, an axis that does not
  divide the devices, an input height the spatial axis does not divide.
* A tensor-parallel run's checkpoints are hemx's tree with whole kernels:
  its baseline checkpoint has the bytes of a one-process run's, its
  trained one the same tree, shapes and size and values at the TP tests'
  tolerance, and each resumes the other's run (``--epochs +1``).
* The evaluation tools read a TP run at hemx's batch, ``batch_size *
  n_devices`` (hemx builds a data-only mesh there), in one process, and
  ``paper_train`` ignores both axes, as hemx's does.
* The input kernel's band on the CPU: its plain version reads rows
  ``[h0, h1)`` of each image, and the device cache of a model that runs on
  bands gathers each rank's band.
"""

import contextlib
import io
import json
import os
import shutil
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

TINY = ["--dataset", "synthetic", "--synthetic_u8", "--synthetic_count",
        "32", "--synthetic_eval_count", "8", "--synthetic_shape", "32", "32",
        "3", "--batch_size", "2", "--latent_size", "8", "--epoch_size", "2",
        "--device", "cpu", "--seed", "3", "--optimizer", "sgd"]


def _quiet(fn, *a):
    with contextlib.redirect_stdout(io.StringIO()) as out:
        code = fn(*a)
    return code, out.getvalue()


def _summary(out: str) -> dict:
    return json.loads(out.strip().splitlines()[-1])


AXIS_RUNS = [("cnn", "--model_parallel"), ("cnn", "--spatial_parallel"),
             ("iwgan", "--model_parallel"), ("iwgan", "--spatial_parallel")]
PAPER = ["--model", "paper_standalone", "--model_version", "mean_adjusted",
         "--dataset", "synthetic", "--synthetic_shape", "65", "65", "3",
         "--synthetic_u8", "--synthetic_count", "8", "--synthetic_eval_count",
         "12", "--batch_size", "2", "--epoch_size", "1", "--epochs", "1",
         "--seed", "5", "--device", "cpu"]


def _runs_worker(runs: list, out: str) -> None:
    """``cli.run`` of each argv in turn on this rank of a group (as under
    torchrun); rank 0 writes the summary lines to ``out``."""
    from hemx_torch import cli
    from hemx_torch.parallel import dp
    torch.set_num_threads(1)
    summaries = []
    for argv in runs:
        with contextlib.redirect_stdout(io.StringIO()):
            summaries.append(cli.run(argv)["summary"])
    if dp.is_primary():
        with open(out, "w") as f:
            json.dump(summaries, f)


@pytest.fixture(scope="module")
def group_runs(tmp_path_factory):
    """In one group of four gloo processes: the CNN and the IWGAN two
    epochs under each axis (the spatial IWGAN streaming), and
    paper_standalone one epoch under ``--model_parallel 2``. Returns
    (the run directories, rank 0's summary lines)."""
    from hemx_torch.parallel import mesh
    root = tmp_path_factory.mktemp("axis_runs")
    dirs = [root / f"{m}{a}" for m, a in AXIS_RUNS] + [root / "paper_tp"]
    runs = [TINY + ["--model", m, "--n_devices", "4", a, "2",
                    "--n_disc_train", "2", "--epochs", "2", "--epoch_size",
                    "1", "--dir", str(d)]
            + (["--no-device_data_cache"]
               if (m, a) == ("iwgan", "--spatial_parallel") else [])
            for (m, a), d in zip(AXIS_RUNS, dirs)]
    runs.append(PAPER + ["--n_devices", "4", "--model_parallel", "2",
                         "--dir", str(dirs[-1])])
    mesh.spawn(_runs_worker, 4, device="cpu",
               args=(runs, str(root / "summaries.json")))
    return dirs, json.loads((root / "summaries.json").read_text())


@pytest.mark.parametrize("i", range(len(AXIS_RUNS)),
                         ids=[f"{m}{a}" for m, a in AXIS_RUNS])
def test_two_epochs_under_each_axis(group_runs, i):
    from hemx_torch.train.checkpoint import CheckpointManager
    dirs, summaries = group_runs
    model, axis = AXIS_RUNS[i]
    s = summaries[i]
    assert s["processes"] == 4 and s["global_batch"] == 4 and s["step"] == 2
    kind = axis[2:].split("_")[0]
    assert s["axis"]["kind"] == kind and s["axis"]["size"] == 2
    assert s["axis"]["data"] == 2 and s["axis"]["collectives"] > 0
    mgr = CheckpointManager(str(dirs[i]))
    assert [e for e, _ in mgr.checkpoints()] == [0, 1, 2]
    state = mgr.restore()["train_state"]
    for leaf in _leaves(state["params"]):
        assert np.isfinite(leaf).all()


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield np.asarray(v)


def test_refusals_in_hemx_words(tmp_path, capfd):
    from hemx.parallel.mesh import make_mesh
    from hemx_torch import cli
    from tests.test_loop import _train as hemx_train
    with pytest.raises(ValueError) as both:
        make_mesh(0, model=2, spatial=2)
    with pytest.raises(ValueError) as three:
        make_mesh(3, model=2)
    with pytest.raises(ValueError) as height:
        hemx_train(tmp_path / "hemx", epochs=1, spatial_parallel=2,
                   synthetic_shape=[31, 31, 3])
    base = TINY + ["--dir", str(tmp_path / "port")]
    assert cli.main(base + ["--model_parallel", "2",
                            "--spatial_parallel", "2"]) == 1
    assert capfd.readouterr().err.strip() == f"ERROR: {both.value}"
    assert cli.main(base + ["--n_devices", "3", "--model_parallel", "2"]) == 1
    assert capfd.readouterr().err.strip() == f"ERROR: {three.value}"
    assert str(three.value) == "--model_parallel 2 does not divide 3 device(s)"
    # one device (the default --n_devices 0 on the CPU): "1 device(s)"
    assert cli.main(base + ["--spatial_parallel", "2"]) == 1
    assert capfd.readouterr().err.strip() == (
        "ERROR: --spatial_parallel 2 does not divide 1 device(s)")
    odd = [a if a != "32" else "31" for a in base]
    assert cli.main(odd + ["--n_devices", "2", "--spatial_parallel", "2"]) == 1
    assert str(height.value) in capfd.readouterr().err


@pytest.fixture(scope="module")
def tp_and_one(tmp_path_factory):
    """The CNN one epoch under ``--n_devices 2 --model_parallel 2`` (one
    data shard: the global batch is ``batch_size``) and in one process."""
    from hemx_torch import cli
    root = tmp_path_factory.mktemp("tp_ckpt")
    argv = TINY + ["--model", "cnn", "--epochs", "1"]
    tp_dir, one_dir = root / "tp", root / "one"
    assert _quiet(cli.main, argv + ["--n_devices", "2", "--model_parallel",
                                    "2", "--dir", str(tp_dir)])[0] == 0
    assert _quiet(cli.main, argv + ["--dir", str(one_dir)])[0] == 0
    return root, argv, tp_dir, one_dir


def test_tp_checkpoint_is_a_one_process_checkpoint(tp_and_one):
    from hemx_torch.train.checkpoint import CheckpointManager
    from tests.test_torch_tp import CNN_TOL, flat
    _, _, tp_dir, one_dir = tp_and_one
    base = [(d / "checkpoint-0.msgpack").read_bytes() for d in (tp_dir,
                                                                one_dir)]
    assert base[0] == base[1]
    trained = [d / "checkpoint-1.msgpack" for d in (tp_dir, one_dir)]
    assert os.path.getsize(trained[0]) == os.path.getsize(trained[1])
    got, want = (flat(CheckpointManager(str(p.parent)).restore(str(p)))
                 for p in trained)
    assert sorted(got) == sorted(want)
    for k in want:
        a, b = np.asarray(got[k]), np.asarray(want[k])
        assert a.shape == b.shape and a.dtype == b.dtype, k
        np.testing.assert_allclose(a, b, err_msg="/".join(k), **CNN_TOL)


def test_checkpoints_resume_across_the_axis(tp_and_one):
    """One process resumes the TP run; the TP ranks resume the one-process
    run; the two +1 epochs end at the same state."""
    from hemx_torch import cli
    from hemx_torch.train.checkpoint import CheckpointManager
    from tests.test_torch_tp import CNN_TOL, flat
    root, argv, tp_dir, one_dir = tp_and_one
    a, b = root / "one_from_tp", root / "tp_from_one"
    shutil.copytree(tp_dir, a)
    shutil.copytree(one_dir, b)
    more = argv[:]
    more[more.index("--epochs") + 1] = "+1"
    code, out = _quiet(cli.main, more + ["--dir", str(a)])
    assert code == 0 and _summary(out)["processes"] == 1
    code, out = _quiet(cli.main, more + ["--n_devices", "2",
                                         "--model_parallel", "2",
                                         "--dir", str(b)])
    assert code == 0
    got, want = (flat(CheckpointManager(str(d)).restore()) for d in (b, a))
    assert int(got[("epoch",)]) == int(want[("epoch",)]) == 2
    for k in want:
        np.testing.assert_allclose(np.asarray(got[k]), np.asarray(want[k]),
                                   err_msg="/".join(k), **CNN_TOL)


def test_tools_read_a_tp_run_at_hemx_batch(tp_and_one):
    """``visualize`` (and every tool through ``runs.restore_run``) loads
    the TP run's whole kernels in one process at ``batch_size *
    n_devices`` rows, as hemx's data-only mesh batches it."""
    from hemx_torch import runs, visualize
    from hemx_torch.parallel import tp
    _, _, tp_dir, _ = tp_and_one
    opts = json.loads((tp_dir / "options.json").read_text())
    assert opts["model_parallel"] == 2 and opts["n_devices"] == 2
    run = visualize.load_run(str(tp_dir), "cpu")
    assert run.batch["image"].shape[0] == 2 * 2
    assert not any(tp.sharded(p) for p in run.ts.nets.parameters())
    args, *_ = runs.restore_run(str(tp_dir), "cpu")
    assert runs.global_batch(args, "cpu") == 4


def test_paper_metrics_read_a_tp_run_at_hemx_batch(group_runs, tmp_path):
    """A depth model trained under ``--model_parallel 2`` through the CLI
    (hemx's ``train.py`` takes the axes for every model) is scored by
    ``paper_metrics`` at ``batch_size * n_devices``: the same scores as
    the same run's files read as a data-parallel run's."""
    from hemx_torch import paper_metrics as TM
    from hemx_torch import runs
    tp_dir = group_runs[0][-1]
    shutil.copytree(tp_dir, tmp_path / "tp")
    shutil.copytree(tp_dir, tmp_path / "dp")
    opts = json.loads((tmp_path / "dp" / "options.json").read_text())
    assert opts["model_parallel"] == 2 and opts["n_devices"] == 4
    assert runs.global_batch(types.SimpleNamespace(**opts), "cpu") == 8
    opts["model_parallel"] = 1
    (tmp_path / "dp" / "options.json").write_text(json.dumps(opts))
    scores = []
    for side in ("tp", "dp"):
        _quiet(TM.main, ["--dir", str(tmp_path / side), "--device", "cpu"])
        scores.append(json.loads((tmp_path / side / "metrics" /
                                  "eigen_metrics.json").read_text()))
    assert scores[0] == scores[1]


def test_paper_train_ignores_the_axes(tmp_path):
    from hemx_torch import paper_train
    argv = PAPER + ["--model_parallel", "2", "--dir", str(tmp_path)]
    code, out = _quiet(paper_train.main, argv)
    assert code == 0
    s = _summary(out)
    assert s["processes"] == 1 and "axis" not in s


def _band_feeder_worker(out: str):
    from hemx_torch.data.pipeline import DeviceDataPipeline, Pipeline
    from hemx_torch.data.synthetic import SyntheticDataset
    from hemx_torch.config import parse_args
    from hemx_torch.parallel import dp
    dp.set_axis("spatial", 2)
    args = parse_args(TINY + ["--model", "cnn", "--dir", out])
    split = SyntheticDataset.get_datasets(args)["train"]
    got = {}
    for name, cls in (("cache", DeviceDataPipeline), ("stream", Pipeline)):
        feeder = cls(split, 4, device="cpu", keys=("image",), bands=True,
                     group=2)
        got[name] = np.stack([b["image"].numpy()
                              for b in list(feeder.epoch(0))[:2]])
    np.testing.assert_array_equal(got["cache"], got["stream"])
    np.save(os.path.join(out, f"band-{dp.rank()}.npy"), got["cache"])


def test_band_of_the_input_kernel_and_the_feeders(tmp_path):
    """``gather_u8_normalize_ref`` with ``rows`` equals the whole gather's
    rows; the cache (the kernel's band) and the stream (the band cut on
    the host) give each rank of a spatial axis its data shard's rows and
    its band: rank r of (data=1, spatial=2) the rows [16r, 16r+16)."""
    from hemx_torch.data.pipeline import DeviceDataPipeline
    from hemx_torch.data.synthetic import SyntheticDataset
    from hemx_torch.config import parse_args
    from hemx_torch.ops.input_kernels import gather_u8_normalize_ref
    from hemx_torch.parallel import mesh
    ds = torch.from_numpy(np.random.default_rng(0).integers(
        0, 256, (6, 8, 5, 3), dtype=np.uint8))
    idx = torch.tensor([4, 0, 2])
    whole = gather_u8_normalize_ref(ds, idx, -1.0, 1.0)
    band = gather_u8_normalize_ref(ds, idx, -1.0, 1.0, rows=(2, 6))
    assert band.shape == (3, 3, 4, 5)
    torch.testing.assert_close(band, whole[:, :, 2:6], rtol=0, atol=0)
    with pytest.raises(ValueError, match="is not a band"):
        gather_u8_normalize_ref(ds, idx, rows=(6, 2))
    mesh.spawn(_band_feeder_worker, 2, device="cpu", args=(str(tmp_path),))
    split = SyntheticDataset.get_datasets(parse_args(
        TINY + ["--model", "cnn", "--dir", str(tmp_path)]))["train"]
    feeder = DeviceDataPipeline(split, 4, device="cpu", keys=("image",),
                                group=2)
    whole = np.stack([b["image"].numpy() for b in list(feeder.epoch(0))[:2]])
    for r in (0, 1):
        got = np.load(tmp_path / f"band-{r}.npy")
        np.testing.assert_array_equal(got, whole[:, :, :, 16 * r:16 * r + 16])
