"""hemx_torch's training loop held against hemx.train.loop, through the CLI
on the CPU.

* The same flags give the same checkpoints and the same summaries: every
  (tag, kind, step) of the train, validate and test events files equals
  hemx's (baseline at step 0, the ``--summary_freq`` cadence, epoch ends,
  validation every epoch, the test split at ``--test_epochs``, and the
  ``--summarize_*`` tags).
* ``--epochs +n`` resumes at the checkpointed step, and a run split by a
  resume writes the same last checkpoint, byte for byte, as one that was
  not (bf16 and hemx's default optimizer, rmsprop).
* options.json agrees with hemx's on the keys both have.
* ``--check_numerics`` exits nonzero on an injected NaN; ``--profile``
  writes a trace that holds the train call's spans; an already finished
  ``--epochs n`` trains nothing.
"""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tests.conftest import make_args  # noqa: E402

# 40 images of 16 px, batch 4, 2 critic steps: 10 batches per data epoch,
# epochs of 5 calls (15 batches), so the stream crosses data epochs
SHARED = dict(seed=5, batch_size=4, latent_size=8, n_disc_train=2,
              synthetic_count=40, synthetic_eval_count=8,
              synthetic_shape=[16, 16, 3], synthetic_u8=True, epochs="2",
              epoch_size=5, summary_freq=2, test_epochs=[2], examples=4,
              optimizer="rmsprop", summarize_activations=True,
              summarize_gradients=True, summarize_weights=True)


def _argv(d: dict) -> list:
    out = ["--model", "iwgan", "--dataset", "synthetic", "--device", "cpu"]
    for k, v in d.items():
        if v is True:
            out.append(f"--{k}")
        elif isinstance(v, list):
            out += [f"--{k}"] + [str(x) for x in v]
        else:
            out += [f"--{k}", str(v)]
    return out


@pytest.fixture(autouse=True, scope="module")
def _hemx_float32():
    """hemx's compute dtype and precision are process-wide: compare against,
    and leave behind, hemx's float32 defaults."""
    from hemx.ops import layers
    layers.set_compute_dtype(None)
    layers.set_default_precision("default")
    yield
    layers.set_compute_dtype(None)
    layers.set_default_precision("default")


def _events(workdir) -> dict:
    """{phase: {(tag, kind, step)}} of a workspace's events files."""
    from hemx.summaries.reader import event_files, iter_events
    out = {}
    for phase in ("train", "validate", "test"):
        seen = set()
        for path in event_files(os.path.join(workdir, phase)):
            for ev in iter_events(path):
                for v in ev["values"]:
                    kind = next(k for k in ("simple_value", "histo", "image")
                                if k in v)
                    seen.add((v["tag"], kind, ev["step"]))
        out[phase] = seen
    return out


def _ckpt_epochs(workdir) -> list:
    from hemx_torch.train.checkpoint import CheckpointManager
    return [e for e, _ in CheckpointManager(str(workdir)).checkpoints()]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The same flags through hemx.train and through the port's CLI."""
    import hemx
    from hemx.data.synthetic import SyntheticDataset
    from hemx.models.plugin import get_model
    from hemx.parallel.mesh import make_mesh
    from hemx_torch import cli
    hemx_dir = tmp_path_factory.mktemp("hemx_run")
    port_dir = tmp_path_factory.mktemp("port_run")
    args = make_args(model="iwgan", dir=str(hemx_dir), **SHARED)
    mesh = make_mesh(1)
    hemx.train(get_model("iwgan")(args, mesh),
               SyntheticDataset.get_datasets(args), args, mesh)
    result = cli.run(_argv({**SHARED, "dir": port_dir}))
    return hemx_dir, port_dir, result


def test_checkpoints_and_summaries_match_hemx(runs):
    hemx_dir, port_dir, result = runs
    assert _ckpt_epochs(port_dir) == _ckpt_epochs(hemx_dir) == [0, 1, 2]
    want, got = _events(hemx_dir), _events(port_dir)
    for phase in ("train", "validate", "test"):
        assert got[phase] == want[phase], phase
    assert result["train_state"].step == 10 and result["epoch"] == 2


def test_validation_and_test_events_written(runs):
    from hemx_torch.summaries.reader import get_tag_values
    _, port_dir, _ = runs
    for phase, steps in (("validate", [5, 10]), ("test", [10])):
        for tag in ("losses/g_loss", "losses/d_loss"):
            got = get_tag_values(str(port_dir / phase), tag)
            assert [s for s, _ in got] == steps
            assert all(np.isfinite(v) for _, v in got)
    train_steps = [s for s, _ in get_tag_values(str(port_dir / "train"),
                                                "losses/g_loss")]
    # cadence 5 // 2 = 2: calls 0, 2, 4 of each epoch, plus its end
    assert train_steps == [1, 3, 5, 6, 8, 10]


def test_options_json_matches_hemx(tmp_path):
    from hemx.config import init_working_dir as h_init, parse_args as h_parse
    from hemx_torch.config import init_working_dir, parse_args
    argv = _argv({**SHARED, "shuffle": True})
    argv.remove("--device")
    argv.remove("cpu")
    h = h_parse(argv + ["--dir", str(tmp_path / "h")])
    t = parse_args(argv + ["--dir", str(tmp_path / "t")])
    h_init(h)
    init_working_dir(t)
    with open(tmp_path / "h" / "options.json") as f:
        want = json.load(f)
    with open(tmp_path / "t" / "options.json") as f:
        got = json.load(f)
    shared = (set(want) & set(got)) - {"dir"}
    assert {"epochs", "optimizer", "summary_freq", "test_epochs", "seed",
            "synthetic_shape", "latent_size", "summarize_gradients"} <= shared
    assert {k: got[k] for k in shared} == {k: want[k] for k in shared}
    assert set(got) - set(want) == {"device"}
    assert os.path.exists(tmp_path / "t" / "options.config")


RESUME = dict(seed=2, batch_size=4, latent_size=8, n_disc_train=2,
              synthetic_count=12, synthetic_eval_count=4,
              synthetic_shape=[16, 16, 3], synthetic_u8=True, epoch_size=2,
              dtype="bfloat16")


def test_plus_n_resume_is_bit_exact(tmp_path):
    """One data epoch is one group of 3 batches and an epoch of 2 calls
    reads 2 whole data epochs, so with --no-shuffle the resumed stream
    starts where the uninterrupted one stands."""
    from hemx_torch import cli
    argv = _argv(RESUME) + ["--no-shuffle"]
    whole = cli.run(argv + ["--dir", str(tmp_path / "whole"), "--epochs", "2"])
    first = cli.run(argv + ["--dir", str(tmp_path / "split"), "--epochs", "1"])
    second = cli.run(argv + ["--dir", str(tmp_path / "split"),
                             "--epochs", "+1"])
    assert first["summary"]["step"] == 2 and first["epoch"] == 1
    assert second["resumed"]["step"] == 2 and second["resumed"]["epoch"] == 1
    assert second["summary"]["step"] == whole["summary"]["step"] == 4
    assert second["epoch"] == 2 and second["summary"]["calls"] == 2
    assert _ckpt_epochs(tmp_path / "split") == [0, 1, 2]
    for name in ("checkpoint-1.msgpack", "checkpoint-2.msgpack"):
        with open(tmp_path / "whole" / name, "rb") as a, \
                open(tmp_path / "split" / name, "rb") as b:
            assert a.read() == b.read(), name
    assert [h["d_loss"] for h in whole["history"][2:]] == \
        [h["d_loss"] for h in second["history"]]


def test_finished_run_trains_nothing(tmp_path):
    from hemx_torch import cli
    argv = _argv(RESUME) + ["--dir", str(tmp_path), "--epochs", "1"]
    cli.run(argv)
    again = cli.run(argv)
    assert again["summary"]["calls"] == 0 and again["summary"]["step"] == 2
    assert _ckpt_epochs(tmp_path) == [0, 1]


def test_check_numerics_exits_nonzero_on_nan(tmp_path, capsys):
    from hemx_torch import cli
    argv = _argv({**RESUME, "epochs": 1, "lr": "nan", "check_numerics": True})
    assert cli.main(argv + ["--dir", str(tmp_path)]) == 255
    assert "GRADIENT ERROR (NaN/Inf) on parameter(s): d/c1/b" in \
        capsys.readouterr().err
    assert _ckpt_epochs(tmp_path) == [0]


def test_profile_writes_a_trace(tmp_path):
    from hemx_torch import cli
    cli.run(_argv({**RESUME, "epochs": 1, "profile": True})
            + ["--dir", str(tmp_path)])
    trace = tmp_path / "profile" / "trace.json"
    assert trace.exists() and trace.stat().st_size > 0
    names = {e.get("name") for e in json.loads(trace.read_text())[
        "traceEvents"]}
    assert "hemx_torch.call" in names and "hemx_torch.backward" in names


# the single-network models: 16 images of 16 px, batch 4, epochs of 3
# calls, summaries twice per epoch with the per-layer stats
ZOO = dict(seed=4, batch_size=4, latent_size=8, synthetic_count=16,
           synthetic_eval_count=8, synthetic_shape=[16, 16, 3],
           synthetic_u8=True, epoch_size=3, summary_freq=2, examples=4,
           summarize_activations=True, summarize_gradients=True)


def _zoo_argv(name: str, d: dict) -> list:
    """The port's argv; the CNN's without ``--model`` (it is the
    default)."""
    argv = _argv(d)[2:]
    return argv if name == "cnn" else ["--model", name] + argv


@pytest.fixture(scope="module", params=["cnn", "vae"])
def zoo_runs(request, tmp_path_factory):
    """hemx.train and the port's CLI with the same flags: one epoch, then
    ``--epochs +1`` on the same ``--dir``."""
    import hemx
    from hemx.data.synthetic import SyntheticDataset
    from hemx.models.plugin import get_model
    from hemx.parallel.mesh import make_mesh
    from hemx_torch import cli
    name = request.param
    hemx_dir = tmp_path_factory.mktemp(f"hemx_{name}")
    port_dir = tmp_path_factory.mktemp(f"port_{name}")
    mesh = make_mesh(1)
    results = []
    for epochs in ("1", "+1"):
        args = make_args(model=name, dir=str(hemx_dir), epochs=epochs, **ZOO)
        hemx.train(get_model(name)(args, mesh),
                   SyntheticDataset.get_datasets(args), args, mesh)
        results.append(cli.run(_zoo_argv(name, {**ZOO, "epochs": epochs,
                                                "dir": port_dir})))
    return name, hemx_dir, port_dir, results


def test_zoo_resume_checkpoints_and_summaries_match_hemx(zoo_runs):
    name, hemx_dir, port_dir, (first, second) = zoo_runs
    assert first["args"].model == name
    assert first["summary"]["step"] == 3 and first["epoch"] == 1
    assert second["resumed"]["step"] == 3 and second["resumed"]["epoch"] == 1
    assert second["summary"]["step"] == 6 and second["epoch"] == 2
    assert _ckpt_epochs(port_dir) == _ckpt_epochs(hemx_dir) == [0, 1, 2]
    want, got = _events(hemx_dir), _events(port_dir)
    for phase in ("train", "validate"):
        assert got[phase] == want[phase], phase
    losses = {"cnn": ["loss", "grad_norm"],
              "vae": ["d_loss", "l_loss", "total_loss", "grad_norm"]}[name]
    assert {t for t, k, s in got["train"] if t.startswith("losses/")} == \
        {f"losses/{k}" for k in losses}
    from hemx_torch.summaries.reader import get_tag_values
    tag = "losses/" + losses[0]
    vals = get_tag_values(str(port_dir / "validate"), tag)
    assert [s for s, _ in vals] == [3, 6] and all(np.isfinite(v)
                                                  for _, v in vals)
