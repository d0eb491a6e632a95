"""hemx_torch's CLI and package boundary.

* The port never loads JAX: importing its modules in a fresh interpreter
  leaves ``jax`` (and ``hemx``, ``flax``, ``optax``, ``msgpack``,
  ``matplotlib``, ``paper_train``) out of sys.modules, and no source file
  imports them; nor PIL, which only a non-PNG image would load.
* ``python -m hemx_torch.cli ... --device cpu`` trains at a tiny size and
  reports ``step == epoch_size``; without ``--model`` it trains the CNN;
  ``--device cuda`` without a GPU fails; an unknown model exits 2; the
  port's models are hemx's, ``test`` plugin included.
* Every flag the port shares with hemx has hemx.config's name and default
  (the data flags included), and every ported model and dataset hemx's
  name and ``arguments()``; hemx's config files (``@FILE``, ``--config
  FILE``) resolve to hemx's values.
"""

import json
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")


@pytest.fixture(autouse=True, scope="module")
def _hemx_float32():
    """hemx's compute dtype and precision are process-wide, and bench.main()
    in an earlier test of this worker may have left them at bfloat16:
    compare against, and leave behind, hemx's float32 defaults."""
    from hemx.ops import layers
    layers.set_compute_dtype(None)
    layers.set_default_precision("default")


REPO = Path(__file__).resolve().parents[1]
TINY = ["--model", "iwgan", "--dataset", "synthetic", "--synthetic_u8",
        "--synthetic_count", "24", "--synthetic_shape", "16", "16", "3",
        "--batch_size", "4", "--latent_size", "8", "--n_disc_train", "2",
        "--optimizer", "adam", "--lr", "1e-4", "--beta1", "0.5",
        "--beta2", "0.9", "--epochs", "1", "--epoch_size", "3", "--seed", "1"]


def _run(args, timeout=120):
    return subprocess.run([sys.executable] + args, cwd=REPO,
                          capture_output=True, text=True, timeout=timeout,
                          env={**os.environ, "PYTHONPATH": str(REPO)})


def test_port_does_not_load_jax():
    code = ("import sys\n"
            "import hemx_torch.cli, hemx_torch.models.gan, hemx_torch.convert\n"
            "import hemx_torch.models.cnn, hemx_torch.models.vae\n"
            "import hemx_torch.data.synthetic, hemx_torch.train.loop\n"
            "import hemx_torch.config, hemx_torch.ops.input_kernels\n"
            "import hemx_torch.train.checkpoint, hemx_torch.summaries.reader\n"
            "import hemx_torch.data.plugin, hemx_torch.data.pipeline\n"
            "import hemx_torch.data.tfrecord, hemx_torch.data.imageio\n"
            "import hemx_torch.paper_train, hemx_torch.metrics.eigen\n"
            "import hemx_torch.models.paper_cgan, hemx_torch.models.sampler_gan\n"
            "import hemx_torch.models.paper_family, hemx_torch.ops.images\n"
            "import hemx_torch.models.improved_sampler\n"
            "import hemx_torch.models.mean_depth_estimator\n"
            "import hemx_torch.models.experimental_sampler\n"
            "import hemx_torch.experimental, hemx_torch.paper_metrics\n"
            "import hemx_torch.paper_fullimage\n"
            "import hemx_torch.models.pix2pix, hemx_torch.models.artist\n"
            "import hemx_torch.models.info_gan, hemx_torch.models.fake\n"
            "import hemx_torch.runs, hemx_torch.visualize, hemx_torch.events\n"
            "import hemx_torch.paper_visualize, hemx_torch.visualize_gui\n"
            "import hemx_torch.metrics.fid, hemx_torch.utils.misc\n"
            "from hemx_torch.data.plugin import available_datasets\n"
            "assert len(available_datasets()) == 7  # imports every plugin\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in\n"
            "       ('jax', 'jaxlib', 'flax', 'optax', 'msgpack', 'hemx',\n"
            "        'PIL', 'matplotlib', 'paper_train', 'experimental',\n"
            "        'paper_metrics', 'paper_fullimage', 'visualize', 'events',\n"
            "        'paper_visualize', 'visualize_gui')]\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    r = _run(["-c", code])
    assert r.returncode == 0, r.stdout + r.stderr


def test_sources_import_no_jax_or_hemx():
    """No source of the port, nor chip_smoke.py, imports JAX, flax, optax,
    msgpack, hemx or the root paper_train.py, experimental.py,
    paper_metrics.py, paper_fullimage.py, visualize.py, events.py,
    paper_visualize.py and visualize_gui.py; matplotlib only inside the
    functions that draw (never at a module's top level)."""
    pat = re.compile(
        r"^\s*(import|from)\s+(jax|jaxlib|flax|optax|msgpack|hemx"
        r"|paper_train|experimental|paper_metrics|paper_fullimage|visualize"
        r"|events|paper_visualize|visualize_gui)\b", re.M)
    top_level_mpl = re.compile(r"^(import|from)\s+matplotlib\b", re.M)
    for path in list((REPO / "hemx_torch").rglob("*.py")) + [
            REPO / "chip_smoke.py"]:
        text = path.read_text()
        assert not pat.search(text), path
        assert not top_level_mpl.search(text), path


def test_cli_trains_on_cpu(tmp_path):
    r = _run(["-m", "hemx_torch.cli"] + TINY + ["--device", "cpu",
                                                 "--dir", str(tmp_path)])
    assert r.returncode == 0, r.stderr
    summary = json.loads(r.stdout.strip().splitlines()[-1])
    assert summary["step"] == 3 and summary["calls"] == 3
    assert summary["device"] == "cpu"
    assert sorted(os.listdir(tmp_path)) == [
        "checkpoint-0.msgpack", "checkpoint-1.msgpack", "options.config",
        "options.json", "test", "train", "validate"]


def test_cli_cuda_without_gpu_fails():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    r = _run(["-m", "hemx_torch.cli"] + TINY + ["--device", "cuda"])
    assert r.returncode != 0
    assert "no CUDA device" in r.stderr


def test_cli_unknown_model_exits_2(capsys):
    """A model neither package has is refused, naming every ported one:
    hemx's whole zoo."""
    from hemx_torch import cli
    assert cli.main(["--model", "nope", "--dataset", "synthetic",
                     "--device", "cpu"]) == 2
    assert ("['artist', 'cnn', 'experimental_sampler', 'gan', "
            "'improved_sampler', 'info_gan', 'iwgan', 'mean_depth_estimator', "
            "'paper_baseline_sampler', 'paper_baseline_standalone', "
            "'paper_cgan', 'paper_noise', 'paper_sampler', 'paper_standalone', "
            "'pix2pix', 'sampler_gan', 'test', 'vae', 'wgan']"
            ) in capsys.readouterr().err


def test_available_models_are_hemx_models():
    from hemx.models.plugin import available_models as hemx_models
    from hemx_torch.models.plugin import available_models
    assert available_models() == hemx_models()


def test_test_plugin_trains_through_the_cli(tmp_path):
    """hemx's no-op ``test`` plugin: its ``--test_arg`` reaches the parsed
    options, a call pulls one batch and reports loss 0, and validation
    runs."""
    from hemx_torch import cli
    res = cli.run(["--model", "test", "--test_arg", "3", "--dataset",
                   "synthetic", "--synthetic_count", "8",
                   "--synthetic_eval_count", "4", "--synthetic_shape", "8",
                   "8", "3", "--batch_size", "2", "--epochs", "1",
                   "--device", "cpu", "--seed", "1", "--dir", str(tmp_path)])
    assert res["args"].test_arg == 3
    assert [h["loss"] for h in res["history"]] == [0.0] * 4
    assert res["train_state"].step == 0 and res["epoch"] == 1


def test_summary_counts_its_own_run(tmp_path, monkeypatch):
    """The run's input-kernel launches and gradient all-reduces are its
    own, not the process's: counts an earlier run left (set by hand here)
    do not show. On the CPU the kernel's plain version runs, so the run
    launches it no time."""
    from hemx_torch import cli
    from hemx_torch.ops import input_kernels as K
    from hemx_torch.parallel import dp
    monkeypatch.setitem(K.LAUNCHES, "gather_u8_normalize", 7)
    monkeypatch.setitem(dp.GRAD_REDUCTIONS, "collectives", 5)
    res = cli.run(["--model", "cnn", "--dataset", "synthetic",
                   "--synthetic_u8", "--synthetic_count", "8",
                   "--synthetic_shape", "8", "8", "3", "--batch_size", "4",
                   "--latent_size", "4", "--epochs", "1", "--device", "cpu",
                   "--seed", "1", "--dir", str(tmp_path)])
    assert res["summary"]["input_kernel_launches"] == {
        "gather_u8_normalize": 0}
    assert res["grad_all_reduce"] == {"collectives": 0, "bytes": 0}


def test_cli_default_model_is_cnn(tmp_path):
    """No ``--model``: the CNN autoencoder trains, as ``train.py`` does."""
    r = _run(["-m", "hemx_torch.cli", "--dataset", "synthetic",
              "--synthetic_u8", "--synthetic_count", "8",
              "--synthetic_shape", "16", "16", "3", "--batch_size", "4",
              "--latent_size", "8", "--epochs", "1", "--seed", "1",
              "--device", "cpu", "--dir", str(tmp_path)])
    assert r.returncode == 0, r.stderr
    assert json.loads(r.stdout.strip().splitlines()[-1])["step"] == 2
    with open(tmp_path / "options.json") as f:
        assert json.load(f)["model"] == "cnn"


def test_shared_flags_match_hemx_defaults():
    from hemx.config import build_base_parser as hemx_parser
    from hemx.data.plugin import get_dataset as hemx_dataset
    from hemx.models.plugin import get_model as hemx_model
    from hemx_torch.config import build_base_parser
    from hemx_torch.data.plugin import available_datasets, get_dataset
    from hemx_torch.models.plugin import available_models, get_model

    def defaults(parser):
        return {a.dest: (a.default, a.option_strings[0]) for a in parser._actions
                if a.dest != "help"}

    want = defaults(hemx_parser())
    got = defaults(build_base_parser())
    assert set(got) - set(want) == {"device"}
    assert {"dir", "max_to_keep", "test_epochs", "summary_freq", "examples",
            "check_numerics", "summarize_activations", "summarize_gradients",
            "summarize_weights", "profile", "momentum", "decay",
            "centered", "buffer_size", "resize", "grayscale", "cache_dir",
            "raw_dataset_dir", "dataset_dir", "n_threads"} <= set(got)
    for dest in set(got) - {"device"}:
        assert got[dest] == want[dest], dest
    pairs = []
    for name in available_datasets():
        assert get_dataset(name).name == hemx_dataset(name).name == name
        pairs.append((hemx_dataset(name), get_dataset(name)))
    assert {"--cifar_resize"} == set(get_dataset("cifar").arguments())
    assert set(get_dataset("nyuv2").arguments()) == set(
        hemx_dataset("nyuv2").arguments())
    for name in available_models():
        assert get_model(name).name == hemx_model(name).name == name
        pairs.append((hemx_model(name), get_model(name)))
    assert {"--vae_parity_loss", "--latent_size"} <= set(
        get_model("vae").arguments())
    for hemx_cls, port_cls in pairs:
        h_args = hemx_cls.arguments()
        for flag, spec in port_cls.arguments().items():
            for key in ("default", "type", "choices", "action"):
                assert spec.get(key) == h_args[flag].get(key), (flag, key)


def test_nyuv2_resize_flag_wins(tmp_path):
    """The base --resize parses for any dataset; nyuv2's own --resize
    replaces it (conflict_handler="resolve"), as in hemx
    (tests/test_data.py::TestResize::test_flag_parses_and_nyuv2_override_wins)."""
    from hemx_torch.config import parse_args
    a = parse_args(["--dataset", "synthetic", "--resize", "16", "16",
                    "--dir", str(tmp_path)])
    assert a.resize == [16, 16]
    a = parse_args(["--dataset", "nyuv2", "--resize", "20", "24",
                    "--random_crop", "8", "8", "--dir", str(tmp_path)])
    assert a.resize == [20, 24] and a.random_crop == [8, 8]


def test_cli_unported_dataset_exits_1(tmp_path):
    """coco with its raw directories present but no files in them (so
    nothing is downloaded): the conversion fails on the missing annotation
    file, and the port exits 1 with the message hemx raises."""
    from hemx.data.plugin import get_dataset_tensors
    from tests.conftest import make_args
    raw = tmp_path / "raw"
    for d in ("train2014", "val2014", "test2014", "annotations"):
        (raw / d).mkdir(parents=True)
    with pytest.raises(FileNotFoundError) as want:
        get_dataset_tensors(make_args(dataset="coco", raw_dataset_dir=str(raw),
                                      dataset_dir=str(tmp_path / "h")))
    r = _run(["-m", "hemx_torch.cli", "--dataset", "coco", "--device", "cpu",
              "--raw_dataset_dir", str(raw), "--dataset_dir",
              str(tmp_path / "p"), "--dir", str(tmp_path / "run")])
    assert r.returncode == 1
    assert str(want.value) in r.stderr
    assert "instances_train2014.json" in str(want.value)


HEMX_N_DEVICES_CONFIGS = ["gan", "wgan", "iwgan", "cnn", "vae",
                          "paper/cgan/baseline", "paper/cgan/wgan",
                          "paper/cgan/mean_adjusted", "paper/sampler/noise_x"]


@pytest.mark.parametrize("config", HEMX_N_DEVICES_CONFIGS)
def test_n_devices_configs_resolve_to_hemx_global_batch(config, tmp_path,
                                                        capsys):
    """hemx's configs that set ``n_devices`` parse without a warning to
    hemx's ``n_devices``, and the port trains them at hemx's global batch,
    ``batch_size * n_devices`` (1,024 for ``examples/gan.config``): in that
    many gloo processes on the CPU, and on CUDA only where the host has the
    GPUs (else hemx's refusal). The parent ran it at ``batch_size``."""
    from hemx.config import parse_args as hemx_parse
    from hemx_torch import cli
    from hemx_torch.config import parse_args
    path = str(REPO / "examples" / f"{config}.config")
    tail = ["--seed", "1", "--dir", str(tmp_path)]
    want = hemx_parse(["@" + path] + tail)
    capsys.readouterr()
    got = parse_args(["@" + path, "--device", "cpu"] + tail)
    assert "unknown and unused" not in capsys.readouterr().err
    assert got.n_devices == want.n_devices == 2
    assert cli.workers(got) == 2
    global_batch = got.batch_size * cli.workers(got)
    assert global_batch == want.batch_size * want.n_devices
    if config == "gan":
        assert global_batch == 1024
    got.device = "cuda"
    if torch.cuda.device_count() < 2:
        with pytest.raises(cli.CliError, match=(
                r"^requested 2 devices but only \d+ available$")):
            cli.workers(got)
    else:
        assert cli.workers(got) == 2


def test_mesh_refusals_use_hemx_texts():
    """More GPUs than the host has, and what hemx's ``make_mesh`` refuses
    of its ``model`` and ``spatial`` axes: both at once, and an axis that
    does not divide the devices (one device on the CPU without
    ``--n_devices``), refused in hemx's words, as errors, not warnings."""
    import re as _re

    from hemx.parallel.mesh import make_mesh
    from hemx_torch import cli
    from hemx_torch.config import parse_args
    with pytest.raises(ValueError) as hemx_many:
        make_mesh(9)
    with pytest.raises(ValueError) as hemx_both:
        make_mesh(0, model=2, spatial=2)
    n = torch.cuda.device_count()
    base = ["--dataset", "synthetic", "--dir", "unused", "--seed", "1"]
    with pytest.raises(cli.CliError) as e:
        cli.workers(parse_args(base + ["--n_devices", str(n + 1)]))
    assert str(e.value) == _re.sub(r"\d+ devices but only \d+",
                                   f"{n + 1} devices but only {n}",
                                   str(hemx_many.value))
    with pytest.raises(cli.CliError) as e:
        cli.workers(parse_args(base + ["--model_parallel", "2",
                                       "--spatial_parallel", "2"]))
    assert str(e.value) == str(hemx_both.value)
    for flag, axis in (("--model_parallel", "model"),
                       ("--spatial_parallel", "spatial")):
        with pytest.raises(ValueError) as hemx_three:
            make_mesh(3, **{axis: 2})
        with pytest.raises(cli.CliError) as e:
            cli.workers(parse_args(base + [flag, "2", "--n_devices", "3",
                                           "--device", "cpu"]))
        assert str(e.value) == str(hemx_three.value)
        with pytest.raises(cli.CliError,
                           match=f"^{flag} 2 does not divide 1 device"):
            cli.workers(parse_args(base + [flag, "2", "--device", "cpu"]))
    assert cli.main(base + ["--model_parallel", "4", "--device", "cpu"]) == 1
    # one process asked to run two without a group to join
    with pytest.raises(cli.CliError, match="runs 2 processes"):
        cli.build(base + ["--n_devices", "2", "--device", "cpu"])


@pytest.mark.parametrize("config", ["a1", "ff.rmse", "experimental",
                                    "meandepth.e1"])
def test_config_files_parse_as_hemx(config, tmp_path):
    """``@FILE`` and ``--config FILE`` read hemx's config files (``key
    value`` lines, ``#`` comments) to hemx's values, and flags after the
    file override it."""
    from hemx.config import parse_args as hemx_parse
    from hemx_torch.config import parse_args
    path = str(REPO / "examples" / "improved_sampler" / f"{config}.config")
    tail = ["--dataset", "synthetic", "--batch_size", "4", "--seed", "1",
            "--dir", str(tmp_path)]
    want = vars(hemx_parse(["@" + path] + tail))
    got = vars(parse_args(["--config", path] + tail))
    shared = (set(got) & set(want)) - {"_negatable"}
    assert {"model", "optimizer", "lr", "beta1", "epochs"} <= shared
    for k in shared:
        assert got[k] == want[k], k
    assert got["batch_size"] == 4


PIX2PIX_CONFIGS = sorted(
    str(p.relative_to(REPO / "examples")) for p in
    [REPO / "examples" / "pix2pix.config", REPO / "examples" / "artist.config",
     *(REPO / "examples" / "pix2pix").glob("*.config"),
     *(REPO / "examples" / "cgan_experiments").rglob("*.config")])


@pytest.mark.parametrize("config", PIX2PIX_CONFIGS)
def test_zoo_config_files_parse_as_hemx(config, tmp_path):
    """hemx's pix2pix, cgan_experiments and artist config files parse,
    their NYUv2 flags (``random_crop``, ``skip_invalid``) included, to
    hemx's values: ``--noise`` as a list, ``--lambda`` into ``l1_lambda``,
    the store-true flags."""
    from hemx.config import parse_args as hemx_parse
    from hemx_torch.config import parse_args
    path = str(REPO / "examples" / config)
    tail = ["--seed", "1", "--dir", str(tmp_path)]
    want = vars(hemx_parse(["@" + path] + tail))
    got = vars(parse_args(["@" + path] + tail))
    shared = (set(got) & set(want)) - {"_negatable"}
    assert {"model", "optimizer", "lr", "epochs", "batch_size",
            "dataset"} <= shared
    if want["model"] == "pix2pix":
        assert {"noise", "dropout", "batch_norm_gen", "batch_norm_disc",
                "n_disc_train", "add_l1", "l1_lambda"} <= shared
    for k in shared:
        assert got[k] == want[k], k
