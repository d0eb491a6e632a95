"""The CNN autoencoder of hemx_torch held against hemx's CnnModel.

* One train call from the same JAX-initialized weights and batch gives the
  same ``loss`` and ``grad_norm`` (rtol 5e-4 / atol 1e-5) and parameters
  (rtol 2e-3 / atol 2e-5 after sgd), as tests/test_torch_iwgan.py.
* Eval, reconstructions, the per-layer activation and gradient stats (with
  hemx's nested names) and the summary tags equal hemx's.
* A hemx CNN checkpoint (rmsprop, after one call) restores into the port
  bit for bit, and a port checkpoint restores through hemx's
  ``CheckpointManager.restore(template)`` with no leaf missing or extra;
  ``opt`` is the one optimizer's optax state, with no ``{"g", "d"}`` level.
  One more call from each restored state gives the same result.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from flax import serialization  # noqa: E402

from tests.conftest import make_args  # noqa: E402
from tests.test_torch_checkpoint import _assert_bit_equal, _spec  # noqa: E402
from tests.test_torch_iwgan import _assert_trees_close, _nchw  # noqa: E402

B, LATENT, HW = 4, 16, 32
LOSS_TOL = dict(rtol=5e-4, atol=1e-5)
PARAM_TOL = dict(rtol=2e-3, atol=2e-5)


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


class TagWriter:
    """Records (kind, tag, shape) of every summary written."""

    def __init__(self):
        self.seen = []

    def _add(self, kind, tag, value):
        self.seen.append((kind, tag, np.shape(value)))

    def montage(self, tag, images, step):
        self._add("montage", tag, images)

    def histogram(self, tag, values, step):
        self._add("histogram", tag, values)

    def scalar(self, tag, value, step):
        self._add("scalar", tag, value)


def hemx_model(name, **overrides):
    """hemx's model, its state after init and the batches of two calls."""
    from hemx.models.plugin import get_model
    from hemx.parallel.mesh import make_mesh
    args = make_args(model=name, batch_size=B, latent_size=LATENT,
                     synthetic_shape=[HW, HW, 3], **overrides)
    mesh = make_mesh(1)
    rng = np.random.default_rng(9)
    batches = [rng.random((B, HW, HW, 3), dtype=np.float32) for _ in range(2)]
    model = get_model(name)(args, mesh)
    ts = model.init_state(jax.random.PRNGKey(args.seed), {"image": batches[0]})
    return args, mesh, model, ts, batches


def port_state(name, args, start):
    """The port's model, with hemx's start weights and BN state."""
    from hemx_torch import convert
    from hemx_torch.models.plugin import get_model
    model = get_model(name)(args, "cpu")
    ts = model.init_state((3, HW, HW), args.seed)
    convert.load_from_jax(ts.nets, start["params"], start["mstate"])
    return model, ts


def checkpoint_run(name, tmp_path_factory, **overrides):
    """hemx's model after one train call, saved as checkpoint-1 by hemx's
    CheckpointManager, and hemx's result of a second call."""
    from hemx.parallel.dp import shard_batch
    from hemx.train.checkpoint import CheckpointManager
    args, mesh, model, ts, batches = hemx_model(name, optimizer="rmsprop",
                                                **overrides)
    ts, _ = model.train(ts, iter([shard_batch({"image": batches[0]}, mesh)]))
    d = tmp_path_factory.mktemp(f"hemx_{name}_ckpt")
    wrapper = {"train_state": ts, "epoch": np.int64(1)}
    CheckpointManager(str(d)).save(wrapper, 1)
    tree = serialization.to_state_dict(jax.device_get(wrapper))
    ts2, metrics = model.train(
        ts, iter([shard_batch({"image": batches[1]}, mesh)]))
    return dict(args=args, dir=d, tree=tree, template=wrapper,
                batch=batches[1], after=jax.device_get(ts2),
                metrics={k: np.asarray(v) for k, v in
                         jax.device_get(metrics).items()})


def assert_hemx_checkpoint_restores(name, run):
    """hemx's file -> the port, bit for bit; ``opt`` has no g/d level."""
    from hemx_torch import convert
    from hemx_torch.models.plugin import get_model
    from hemx_torch.train.checkpoint import CheckpointManager
    ts = get_model(name)(run["args"], "cpu").init_state((3, HW, HW), 0)
    opt = run["tree"]["train_state"]["opt"]
    assert set(opt) == {"0", "1", "2"}  # rmsprop's chain, no {"g", "d"}
    assert convert.load_checkpoint(
        ts, CheckpointManager(str(run["dir"])).restore()) == 1
    assert ts.step == 1
    _assert_bit_equal(convert.to_checkpoint(ts, 1), run["tree"])


def assert_port_checkpoint_restores_into_hemx(name, run, tmp_path):
    from hemx.train.checkpoint import CheckpointManager as HemxManager
    from hemx_torch import convert
    from hemx_torch.models.plugin import get_model
    from hemx_torch.train.checkpoint import CheckpointManager
    ts = get_model(name)(run["args"], "cpu").init_state((3, HW, HW), 0)
    convert.load_checkpoint(ts, run["tree"])
    path = CheckpointManager(str(tmp_path)).save(convert.to_checkpoint(ts, 1),
                                                 1)
    with open(path, "rb") as f:
        raw = serialization.msgpack_restore(f.read())
    assert _spec(raw) == _spec(serialization.to_state_dict(
        jax.device_get(run["template"])))
    restored = HemxManager(str(tmp_path)).restore(run["template"])
    _assert_bit_equal(serialization.to_state_dict(restored), run["tree"])
    with open(run["dir"] / "checkpoint-1.msgpack", "rb") as f:
        assert f.read() == open(path, "rb").read()


def restored_port_state(name, run):
    from hemx_torch import convert
    from hemx_torch.models.plugin import get_model
    from hemx_torch.train.checkpoint import CheckpointManager
    model = get_model(name)(run["args"], "cpu")
    ts = model.init_state((3, HW, HW), 0)
    convert.load_checkpoint(ts, CheckpointManager(str(run["dir"])).restore())
    return model, ts


@pytest.fixture(scope="module")
def call():
    """hemx's start state, its eval loss, reconstructions, activation and
    gradient stats and summary tags, and its state after one sgd call."""
    from hemx.parallel.dp import shard_batch
    args, mesh, model, ts, batches = hemx_model("cnn", optimizer="sgd",
                                                lr=1e-3)
    start = jax.device_get(ts)
    batch = shard_batch({"image": batches[0]}, mesh)
    writer = TagWriter()
    model.write_summaries(writer, 0, ts, batch)
    out = dict(args=args, batches=batches, start=start, writer=writer,
               eval=float(model.eval_losses(ts, batch)["loss"]),
               recon=np.asarray(model._jit_recon(ts, batch)),
               acts=jax.device_get(model.capture_activations(ts, batch)),
               grads=jax.device_get(model.grad_report(ts, batch)))
    new_ts, metrics = model.train(ts, iter([batch]))
    out.update(after=jax.device_get(new_ts),
               metrics={k: float(v) for k, v in
                        jax.device_get(metrics).items()})
    return out


def _port(call, **overrides):
    return port_state("cnn", make_args(**{**vars(call["args"]), **overrides}),
                      call["start"])


def test_train_call_matches_hemx(call):
    from hemx_torch import convert
    model, ts = _port(call)
    ts, metrics = model.train(ts, iter([{"image": _nchw(call["batches"][0])}]))
    assert set(metrics) == set(call["metrics"]) == {"loss", "grad_norm"}
    for k in metrics:
        np.testing.assert_allclose(float(metrics[k]), call["metrics"][k],
                                   err_msg=k, **LOSS_TOL)
    assert ts.step == int(call["after"]["step"]) == 1
    params, _ = convert.to_jax(ts.nets)
    _assert_trees_close(params, call["after"]["params"], **PARAM_TOL)


def test_parameter_tree_is_nested_like_hemx(call):
    """{"encoder": {c1..c6}, "latent": {"flatten": {}, "d1"}, "decoder":
    {...}}, empty subtrees included, in params and in every optimizer
    moment tree."""
    from hemx_torch import convert
    _, ts = _port(call, optimizer="rmsprop")
    params, mstate = convert.to_jax(ts.nets)
    assert _spec(params) == _spec(call["start"]["params"])
    assert _spec(mstate) == _spec(call["start"]["mstate"])
    assert params["latent"]["flatten"] == {}
    nu = convert.opt_state_to_jax(ts.opt)["0"]["nu"]
    assert _spec(nu) == _spec(call["start"]["params"])


def test_eval_and_recon_match_hemx(call):
    model, ts = _port(call)
    batch = {"image": _nchw(call["batches"][0])}
    np.testing.assert_allclose(float(model.eval_losses(ts, batch)["loss"]),
                               call["eval"], **LOSS_TOL)
    recon = model.recon(ts, batch).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(recon, call["recon"], rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("kind", ["acts", "grads"])
def test_layer_stats_match_hemx(call, kind):
    """--summarize_activations / --summarize_gradients: hemx's names
    (``encoder/c1``, ``latent``, ``decoder/dc4/w``, ...) and values."""
    model, ts = _port(call)
    batch = {"image": _nchw(call["batches"][0])}
    got = (model.capture_activations if kind == "acts"
           else model.grad_report)(ts, batch)
    want = call[kind]
    assert sorted(got) == sorted(want)
    for name, s in want.items():
        for k in ("mean", "zero_fraction"):
            np.testing.assert_allclose(float(got[name][k]), float(s[k]),
                                       rtol=1e-3, atol=1e-6,
                                       err_msg=f"{name} {k}")


def test_summary_tags_match_hemx(call):
    model, ts = _port(call)
    writer = TagWriter()
    model.write_summaries(writer, 0, ts, {"image": _nchw(call["batches"][0])})
    assert writer.seen == call["writer"].seen
    assert {t for _, t, _ in writer.seen} == {"examples/inputs",
                                              "examples/outputs"}


def test_check_numerics_names_have_no_prefix(call):
    from hemx.models.common import grad_finite_report
    model, ts = _port(call, check_numerics=True)
    _, metrics = model.train(ts, iter([{"image": _nchw(call["batches"][0])}]))
    want = set(grad_finite_report(call["start"]["params"]))
    assert set(metrics["grad_finite"]) == want
    assert "encoder/c1/w" in want


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    return checkpoint_run("cnn", tmp_path_factory)


def test_hemx_checkpoint_restores_into_port_exactly(ckpt):
    assert_hemx_checkpoint_restores("cnn", ckpt)


def test_port_checkpoint_restores_into_hemx_exactly(ckpt, tmp_path):
    assert_port_checkpoint_restores_into_hemx("cnn", ckpt, tmp_path)


def test_train_call_after_restore_matches_hemx(ckpt):
    from hemx_torch import convert
    model, ts = restored_port_state("cnn", ckpt)
    ts, metrics = model.train(ts, iter([{"image": _nchw(ckpt["batch"])}]))
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(metrics[k]),
                                   float(ckpt["metrics"][k]), err_msg=k,
                                   **LOSS_TOL)
    assert ts.step == int(ckpt["after"]["step"]) == 2
    params, _ = convert.to_jax(ts.nets)
    _assert_trees_close(params, ckpt["after"]["params"], **PARAM_TOL)
    # the key read from hemx's checkpoint is kept as read
    np.testing.assert_array_equal(ts.rng, ckpt["after"]["rng"])


def test_decoder_output_is_cropped_to_the_input():
    """28 px, not a multiple of 16: the decoder makes 32 px and the
    reconstruction and the loss use its top-left 28 x 28
    (hemx/models/cnn.py:79-83)."""
    from hemx_torch.models.cnn import CnnModel
    model = CnnModel(make_args(model="cnn", latent_size=8), "cpu")
    ts = model.init_state((3, 28, 28), 0)
    x = torch.rand(2, 3, 28, 28, generator=torch.Generator().manual_seed(0))
    recon = model.recon(ts, {"image": x})
    with torch.no_grad():
        full, _ = ts.nets(2.0 * (x - 0.5))
    assert recon.shape == x.shape and full.shape[-2:] == (32, 32)
    assert torch.equal(recon, (full[:, :, :28, :28] + 1.0) / 2.0)
    assert torch.isfinite(model.eval_losses(ts, {"image": x})["loss"])
