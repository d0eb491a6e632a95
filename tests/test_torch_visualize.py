"""``python -m hemx_torch.visualize`` against the root ``visualize.py`` on
the same runs.

One tiny run per family is trained by the port (16 px uint8 synthetic
images, batch 2, ``examples 4``, as ``tests/test_tools.py`` trains hemx's):
cnn, gan (``n_disc_train 1``), paper_standalone (``mean_adjusted``, 65
px) here and vae in ``tests/test_torch_fid_reader.py`` (with the same
checks, so that each file stays short), one epoch each, and the ``test``
plugin, whose ``--all`` raises. hemx's tool gets its run as its
``load_run`` builds it, the weights the port's restored checkpoint in
hemx's tree (hemx restores the same file; its eager init, ≈ 6.4 s a
model, is skipped). On copies of each run dir:

* ``--all`` of both tools writes the same file set (or, for the ``test``
  plugin, raises the same exception; the port's paper_cgan raises hemx's
  TypeError, checked on an untrained model);
* ``weights-*.png``: equal pixel for pixel (the same checkpoint, the same
  rule on hemx-layout kernels);
* samples, timelapse, activations and bestfit from hemx's noise (its
  ``PRNGKey(0)`` z, the VAE's eps from the capture context's first split,
  the bestfit starts ``U(PRNGKey(idx))``) passed through the port's seams:
  decoded pixels within 2/255.

hemx runs in float32 at XLA's default optimization level (its bestfit
evaluates a jitted input gradient 320 times per layer: level 0 runs it
four times slower); its raising families compile nothing.
"""

import contextlib
import io
import os
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from tests.test_torch_paper_cgan import (  # noqa: E402,F401
    _hemx_float32, _two_torch_threads)

BASE = ["--dataset", "synthetic", "--synthetic_u8", "--synthetic_count",
        "16", "--synthetic_eval_count", "4", "--batch_size", "2",
        "--epoch_size", "1", "--epochs", "1", "--examples", "4", "--seed",
        "11", "--device", "cpu"]
PX16 = ["--synthetic_shape", "16", "16", "3"]
# one epoch: checkpoints 0 and 1, two timelapse frames
RUNS = {"cnn": PX16 + ["--latent_size", "16"],
        "vae": PX16 + ["--latent_size", "16"],
        "gan": PX16 + ["--latent_size", "16", "--n_disc_train", "1"],
        "paper_standalone": ["--model_version", "mean_adjusted",
                             "--synthetic_shape", "65", "65", "3",
                             "--max_to_keep", "1"]}
# Where the bestfit ascent runs through BN over a one-image batch or a
# saturated output, it is chaotic: the two packages' input gradients agree
# to 4e-6 at the first step and part step by step (measured: the CNN's
# default layer ``decoder``, a tanh output with a 1e-8 gradient, agrees to
# 2e-6 for four steps, then f32 rounding puts an activation kink on
# different sides, a 1.4 % jump; the VAE's ``c1``, the decoder's, grows
# from 4e-6 to 2 % by step 5, as does its encoder's ``c3`` for half its
# filters). Those images are checked for their presence (hemx's tool is
# not run for them: the name is its first captured layer's), and the
# ascent's first step (its gradient, update, decay and blur) against
# hemx's for every family; the GAN's whole ascent on its default ``c1``
# is compared by its pixels.
CHAOTIC = {("cnn", "bestfit-decoder.png"), ("vae", "bestfit-c1.png")}
TOL = 2  # grey levels out of 255


def _train(root, name, extra):
    from hemx_torch import cli
    run = root / name
    with contextlib.redirect_stdout(io.StringIO()):
        cli.run(["--model", name, "--dir", str(run)] + BASE + extra)
    return run


def _files(run):
    out = run / "visualize"
    return sorted(os.listdir(out)) if out.is_dir() else []


def _hemx_noise(name, hrun):
    """hemx's draws: samples' and the timelapse's z, the VAE's eps for the
    batch and for one bestfit image, the bestfit starts."""
    args, batch = hrun[0], hrun[5]
    shape = np.asarray(batch["image"]).shape
    noise = {"starts": np.stack([np.asarray(jax.random.uniform(
        jax.random.PRNGKey(i), (1,) + shape[1:]))[0] * 0.2 + 0.4
        for i in range(16)])}
    if name in ("gan", "vae"):
        latent = args.latent_size
        noise["z"] = np.asarray(jax.random.normal(
            jax.random.PRNGKey(0), (args.examples, latent)))
        noise["z16"] = np.asarray(jax.random.normal(
            jax.random.PRNGKey(0), (min(16, args.examples), latent)))
    if name == "vae":
        key = jax.random.split(jax.random.PRNGKey(0))[1]
        noise["eps"] = np.asarray(jax.random.normal(key, (shape[0], latent)))
        noise["eps1"] = np.asarray(jax.random.normal(key, (1, latent)))
    return noise


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tmp_path_factory.mktemp("visualize")


def _hemx_run(run_dir, port_ts):
    """hemx's ``visualize.load_run`` tuple for ``run_dir`` without its
    eager weight init (≈ 6.4 s a model on this CPU): the model built as
    ``init_state`` builds it, the train state the port's restored
    checkpoint in hemx's tree (the tree hemx restores from the same
    file)."""
    import types
    import hemx
    from hemx.config import load_options
    from hemx.models.plugin import get_model
    from hemx.parallel.mesh import make_mesh
    from hemx.train.checkpoint import CheckpointManager
    from hemx_torch.convert import train_state_to_jax
    args = types.SimpleNamespace(**load_options(
        os.path.join(run_dir, "options.json")))
    args.dir = run_dir
    mesh = make_mesh(1)
    splits = hemx.get_dataset_tensors(args)
    model = get_model(args.model)(args, mesh)
    batch = next(splits["train"].iter_epoch(args.batch_size, shuffle=False))
    shape = np.asarray(batch["image"]).shape
    if args.model == "paper_standalone":
        model._net = model._build()
    elif args.model == "cnn":
        model._net = model._build(shape)
    else:  # gan, vae
        model._image_shape = shape[1:]
        model._nets = model._build(shape)
    model._compile()
    ts = jax.tree_util.tree_map(jnp.asarray, train_state_to_jax(port_ts))
    return args, mesh, splits, model, ts, batch, CheckpointManager(run_dir)


def compare_family(root, name: str) -> dict:
    """Train the port's run of ``name``; then hemx's ``--all``, the port's
    ``--all`` and the port's functions with hemx's noise, each on its own
    copy of the run. hemx's bestfit is not run where the ascent is chaotic
    (``CHAOTIC``): its file name, the first of hemx's captured layers by
    name, is taken from them."""
    import visualize as HV  # the repo root's tool
    from hemx_torch import visualize as TV
    trained = _train(root, name, RUNS[name])
    chaotic = any(n == name for n, _ in CHAOTIC)
    dirs = {}
    for side in ("hemx", "port_all", "port"):
        dirs[side] = root / f"{name}_{side}"
        shutil.copytree(trained, dirs[side], copy_function=os.link)
    with contextlib.redirect_stdout(io.StringIO()):
        run = TV.load_run(str(dirs["port"]), "cpu")
        run.ts.nets.eval()
        hrun = _hemx_run(str(dirs["hemx"]), run.ts)
        hout = str(dirs["hemx"] / "visualize")
        for fn in (HV.visualize_samples, HV.visualize_timelapse,
                   HV.visualize_activations, HV.visualize_weights,
                   HV.visualize_bestfit, HV.visualize_loss):
            if fn is not HV.visualize_bestfit or not chaotic:
                fn(hrun, hout)  # what hemx's --all runs
        hemx_layers = sorted(HV._capture_layers(*hrun[3:6], hrun[1],
                                                hrun[2]))
        noise = _hemx_noise(name, hrun)
        assert TV.main(["--dir", str(dirs["port_all"]), "--all",
                        "--device", "cpu"]) == 0
        out = str(dirs["port"] / "visualize")
        z = torch.from_numpy(noise["z"]) if "z" in noise else None
        z16 = torch.from_numpy(noise["z16"]) if "z16" in noise else None
        eps = ({"eps": torch.from_numpy(noise["eps"])} if "eps" in noise
               else None)
        eps1 = ({"eps": torch.from_numpy(noise["eps1"])} if "eps1" in noise
                else None)
        starts = torch.from_numpy(noise["starts"]).permute(0, 3, 1, 2)
        TV.visualize_samples(run, out, z=z)
        TV.visualize_timelapse(run, out, z=z16)
        TV.visualize_activations(run, out, noise=eps)
        TV.visualize_weights(run, out)
        if not chaotic:
            TV.visualize_bestfit(run, out, starts=starts, noise=eps1)
        TV.visualize_loss(run, out)
    hemx_files = _files(dirs["hemx"])
    if chaotic:
        hemx_files = sorted(hemx_files + [
            f"bestfit-{hemx_layers[0].replace('/', '_')}.png"])
    return {"name": name, "dirs": dirs, "hemx_run": hrun, "run": run,
            "starts": starts, "eps1": eps1, "hemx_files": hemx_files,
            "hemx_layers": hemx_layers}


# the VAE's comparison runs in tests/test_torch_fid_reader.py, which
# balances the two files' time
@pytest.fixture(scope="module", params=["cnn", "gan", "paper_standalone"])
def family(request, root):
    return compare_family(root, request.param)


def _png(path):
    from hemx_torch.data.imageio import decode_image
    with open(path, "rb") as f:
        return decode_image(f.read(), 0).astype(np.int16)


EXPECTED = {"cnn": {"samples.png", "timelapse-0000.png", "timelapse-0001.png",
                    "activations-encoder_c1.png", "activations-decoder.png",
                    "weights-encoder_c1_w.png", "weights-decoder_dc4_w.png",
                    "bestfit-decoder.png", "loss.pdf"},
            "vae": {"samples.png", "timelapse-0001.png", "activations-c1.png",
                    "weights-encoder_c1_w.png", "bestfit-c1.png"},
            "gan": {"samples.png", "timelapse-0001.png", "activations-c3.png",
                    "weights-discriminator_c1_w.png",
                    "weights-generator_dc2_w.png", "bestfit-c1.png"},
            "paper_standalone": {"weights-e1_w.png", "loss.pdf"}}


def check_file_set(family):
    name, dirs = family["name"], family["dirs"]
    want = family["hemx_files"]
    assert EXPECTED[name] <= set(want)
    assert _files(dirs["port_all"]) == want
    chaotic = {f for n, f in CHAOTIC if n == name}
    assert set(_files(dirs["port"])) | chaotic == set(want)


def check_weight_grids(family):
    name, dirs = family["name"], family["dirs"]
    names = [f for f in _files(dirs["hemx"]) if f.startswith("weights-")]
    assert names
    for f in names:
        np.testing.assert_array_equal(_png(dirs["port"] / "visualize" / f),
                                      _png(dirs["hemx"] / "visualize" / f),
                                      err_msg=f)


def check_images(family):
    name, dirs = family["name"], family["dirs"]
    names = [f for f in _files(dirs["hemx"]) if f.endswith(".png")
             and not f.startswith("weights-")
             and (name, f) not in CHAOTIC]
    if name == "paper_standalone":
        assert names == []  # the depth nets capture nothing
    for f in names:
        got = _png(dirs["port"] / "visualize" / f)
        want = _png(dirs["hemx"] / "visualize" / f)
        assert got.shape == want.shape, f
        assert np.abs(got - want).max() <= TOL, (f, np.abs(got - want).max())


def test_all_raises_where_hemx_raises(root):
    """The ``test`` plugin: hemx's ``--all`` and the port's raise KeyError
    in the weights step, having written nothing. paper_cgan, whose critic
    takes an (image, depth) pair: the port's visualized forward raises
    hemx's TypeError (the module docstring's table, held against hemx's
    tool on a run of each model; not trained here, for time)."""
    import visualize as HV
    from hemx_torch import visualize as TV
    from hemx_torch.config import parse_args
    from hemx_torch.models.paper_cgan import PaperCgan
    run = _train(root, "test", PX16)
    shutil.copytree(run, root / "test_hemx", copy_function=os.link)
    for main, flags, d in ((TV.main, ["--device", "cpu"], run),
                           (HV.main, [], root / "test_hemx")):
        with contextlib.redirect_stdout(io.StringIO()):
            with pytest.raises(KeyError, match="params"):
                main(["--dir", str(d), "--all"] + flags)
        assert _files(d) == []
    model = PaperCgan(parse_args(["--model", "paper_cgan", "--model_version",
                                  "mean_adjusted", "--dataset", "synthetic"]),
                      "cpu")
    ts = model.init_state((3, 65, 65), 3)
    with pytest.raises(TypeError, match="image, depth"):
        TV.captured_forward(model, ts, torch.rand(2, 3, 65, 65))


def test_blur_is_hemx_blur():
    """The separable 5-tap blur, per channel, against hemx's on a seeded
    3-channel image (f32)."""
    import visualize as HV
    from hemx_torch.visualize import _gaussian_blur
    x = np.random.default_rng(0).random((2, 9, 11, 3), np.float32)
    want = np.asarray(HV._gaussian_blur(jnp.asarray(x)))
    got = _gaussian_blur(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               rtol=1e-5, atol=1e-6)


def check_bestfit_first_step(family):
    """The default layer's ascent, first step, filter by filter: hemx's
    loop body (``visualize.py``: the jitted input gradient,
    ``g / (rms + 1e-8)``, ``x += 0.1 g``, ``x *= 1 - 1e-4``, the blur at
    step 0) against the port's one-step ascent from the same starts. The
    standalone generator captures no layer in either package."""
    import visualize as HV
    from hemx.core import Ctx
    from hemx_torch import visualize as TV
    hrun, run = family["hemx_run"], family["run"]
    model, ts = hrun[3], hrun[4]
    layers = TV.capture_layers(run)
    assert family["hemx_layers"] == sorted(layers)
    if family["name"] == "paper_standalone":
        assert layers == {}
        return
    layer = family["hemx_layers"][0]
    n = min(4, int(layers[layer].shape[1]))

    def act_mean(x, idx):
        ctx = Ctx(training=False, rng=jax.random.PRNGKey(0), capture=True)
        HV._apply_captured(model, ts, x, ctx)
        return jnp.mean(jnp.take(ctx.intermediates[layer], idx, axis=-1))

    grad = jax.jit(jax.grad(act_mean))
    starts = family["starts"]
    got = TV.bestfit_images(run, layer, n, starts, family["eps1"], steps=1)
    for idx in range(n):
        x = jnp.asarray(starts[idx:idx + 1].permute(0, 2, 3, 1).numpy())
        g = grad(x, jnp.asarray(idx))
        g = g / (jnp.sqrt(jnp.mean(g ** 2)) + 1e-8)
        want = HV._gaussian_blur((x + 0.1 * g) * (1.0 - 1e-4))
        np.testing.assert_allclose(got[idx].permute(0, 2, 3, 1).numpy(),
                                   np.asarray(want), rtol=1e-5, atol=1e-5,
                                   err_msg=f"{family['name']} filter {idx}")


def test_all_writes_hemx_file_set(family):
    check_file_set(family)


def test_weight_grids_equal(family):
    check_weight_grids(family)


def test_images_within_two_grey_levels(family):
    check_images(family)


def test_bestfit_first_step_equals_hemx(family):
    check_bestfit_first_step(family)
