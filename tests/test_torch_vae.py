"""The VAE of hemx_torch held against hemx's VaeModel.

* One train call from the same JAX-initialized weights, batch and ``eps``
  (hemx's draw, ``normal(split(fold_in(key, step))[1])``, handed to the
  port through the noise seam), with and without ``--vae_parity_loss``:
  ``d_loss``/``l_loss``/``total_loss``/``grad_norm`` rtol 1e-4 (the losses
  are sums over B*H*W*C, of order 1e4 here), parameters and the encoder's
  BN stats rtol 2e-3 / atol 2e-5 after sgd.
* Eval gives hemx's losses and leaves the BN stats unchanged.
* Checkpoints cross both ways bit for bit (rmsprop, one optimizer's optax
  state as ``opt``), and one more call from each restored state agrees.
* In bf16 the loss dtypes equal hemx's (``l_loss`` bf16, the others f32).
* Activation stats carry hemx's flat names, later nets overwriting earlier
  ones (the decoder's ``c1`` replaces the encoder's); the summary tags
  equal hemx's.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from tests.conftest import make_args  # noqa: E402
from tests.test_torch_cnn import (B, HW, LATENT, PARAM_TOL, TagWriter,  # noqa: E402
                                  assert_hemx_checkpoint_restores,
                                  assert_port_checkpoint_restores_into_hemx,
                                  checkpoint_run, hemx_model, port_state,
                                  restored_port_state)
from tests.test_torch_iwgan import _assert_trees_close, _nchw  # noqa: E402

LOSSES = ("d_loss", "l_loss", "total_loss")
TOL = dict(rtol=1e-4, atol=0)


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


def jax_eps(key, step, b=B, latent=LATENT):
    """hemx's eps: ``Ctx(rng=fold_in(key, step)).next_rng()`` is the second
    half of its split (hemx/core.py:52-56, hemx/models/vae.py:92,140)."""
    k = jax.random.split(jax.random.fold_in(jax.numpy.asarray(key), step))[1]
    return {"eps": torch.from_numpy(np.array(jax.random.normal(k, (b, latent))))}


@pytest.fixture(scope="module", params=[False, True], ids=["total", "parity"])
def call(request):
    """hemx's start state, eval losses, layer stats and summary tags, and
    its state and metrics after one sgd call."""
    from hemx.parallel.dp import shard_batch
    args, mesh, model, ts, batches = hemx_model(
        "vae", optimizer="sgd", lr=1e-4, vae_parity_loss=request.param)
    start = jax.device_get(ts)
    batch = shard_batch({"image": batches[0]}, mesh)
    writer = TagWriter()
    model.write_summaries(writer, 0, ts, batch)
    out = dict(args=args, batches=batches, start=start, writer=writer,
               eval={k: float(v) for k, v in
                     jax.device_get(model.eval_losses(ts, batch)).items()},
               acts=jax.device_get(model.capture_activations(ts, batch)),
               grads=jax.device_get(model.grad_report(ts, batch)))
    new_ts, metrics = model.train(ts, iter([batch]))
    out.update(after=jax.device_get(new_ts),
               metrics={k: float(v) for k, v in
                        jax.device_get(metrics).items()})
    return out


def _port(call, **overrides):
    return port_state("vae", make_args(**{**vars(call["args"]), **overrides}),
                      call["start"])


def test_train_call_matches_hemx(call):
    from hemx_torch import convert
    model, ts = _port(call)
    ts, metrics = model.train(ts, iter([{"image": _nchw(call["batches"][0])}]),
                              noise=[jax_eps(ts.rng, 0)])
    assert set(metrics) == set(call["metrics"]) == {*LOSSES, "grad_norm"}
    for k in metrics:
        np.testing.assert_allclose(float(metrics[k]), call["metrics"][k],
                                   err_msg=k, **TOL)
    assert ts.step == int(call["after"]["step"]) == 1
    params, mstate = convert.to_jax(ts.nets)
    _assert_trees_close(params, call["after"]["params"], **PARAM_TOL)
    _assert_trees_close(mstate, call["after"]["mstate"], **PARAM_TOL)
    assert convert.flatten_tree(mstate["encoder"])  # every conv has BN


def test_parity_loss_optimizes_the_reconstruction_only(call):
    """The step's gradient is that of d_loss under --vae_parity_loss, of
    total_loss otherwise: the KL term moves the z heads only without it."""
    from hemx_torch import convert
    parity = call["args"].vae_parity_loss
    model, ts = _port(call, vae_parity_loss=not parity)
    model.train(ts, iter([{"image": _nchw(call["batches"][0])}]),
                noise=[jax_eps(ts.rng, 0)])
    params, _ = convert.to_jax(ts.nets)
    got = np.asarray(params["z_stddev"]["d2"]["w"])
    want = np.asarray(call["after"]["params"]["z_stddev"]["d2"]["w"])
    assert np.abs(got - want).max() > 1e-6


def test_eval_matches_hemx_and_keeps_bn_stats(call):
    from hemx_torch import convert
    model, ts = _port(call)
    got = model.eval_losses(ts, {"image": _nchw(call["batches"][0])},
                            noise=jax_eps(ts.rng, 0))
    for k in LOSSES:
        np.testing.assert_allclose(float(got[k]), call["eval"][k], err_msg=k,
                                   **TOL)
    _, mstate = convert.to_jax(ts.nets)
    _assert_trees_close(mstate, call["start"]["mstate"], 0, 0)


@pytest.mark.parametrize("kind", ["acts", "grads"])
def test_layer_stat_names_match_hemx(call, kind):
    """hemx's names and sample sizes; encoder-only activations (c3..c6,
    which eps does not reach) by value too."""
    model, ts = _port(call)
    batch = {"image": _nchw(call["batches"][0])}
    got = (model.capture_activations if kind == "acts"
           else model.grad_report)(ts, batch)
    want = call[kind]
    assert sorted(got) == sorted(want)
    for name, s in want.items():
        assert got[name]["sample"].numel() == np.size(s["sample"]), name
    if kind == "acts":
        for name in ("c3", "c4", "c5", "c6", "flatten"):
            np.testing.assert_allclose(float(got[name]["mean"]),
                                       float(want[name]["mean"]),
                                       rtol=1e-3, atol=1e-6, err_msg=name)


def test_summary_tags_match_hemx(call):
    model, ts = _port(call)
    writer = TagWriter()
    model.write_summaries(writer, 0, ts, {"image": _nchw(call["batches"][0])})
    assert writer.seen == call["writer"].seen
    assert [t for _, t, _ in writer.seen] == [
        "examples/inputs", "examples/real_decoded", "examples/fake_decoded"]


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    return checkpoint_run("vae", tmp_path_factory)


def test_hemx_checkpoint_restores_into_port_exactly(ckpt):
    assert_hemx_checkpoint_restores("vae", ckpt)


def test_port_checkpoint_restores_into_hemx_exactly(ckpt, tmp_path):
    assert_port_checkpoint_restores_into_hemx("vae", ckpt, tmp_path)


def test_train_call_after_restore_matches_hemx(ckpt):
    from hemx_torch import convert
    model, ts = restored_port_state("vae", ckpt)
    ts, metrics = model.train(ts, iter([{"image": _nchw(ckpt["batch"])}]),
                              noise=[jax_eps(ts.rng, ts.step)])
    for k in (*LOSSES, "grad_norm"):
        np.testing.assert_allclose(float(metrics[k]),
                                   float(ckpt["metrics"][k]), err_msg=k,
                                   **TOL)
    assert ts.step == int(ckpt["after"]["step"]) == 2
    params, mstate = convert.to_jax(ts.nets)
    _assert_trees_close(params, ckpt["after"]["params"], **PARAM_TOL)
    _assert_trees_close(mstate, ckpt["after"]["mstate"], **PARAM_TOL)


@pytest.fixture
def hemx_bf16():
    from hemx.ops import layers
    layers.set_compute_dtype("bfloat16")
    yield
    layers.set_compute_dtype(None)


def test_bf16_call_loss_dtypes_match_hemx(hemx_bf16):
    from hemx.parallel.dp import shard_batch
    args, mesh, model, ts, batches = hemx_model("vae", optimizer="sgd",
                                                lr=1e-4, dtype="bfloat16")
    start = jax.device_get(ts)
    _, want = model.train(ts, iter([shard_batch({"image": batches[0]}, mesh)]))
    want = {k: np.asarray(v) for k, v in jax.device_get(want).items()}
    port, pts = port_state("vae", args, start)
    _, got = port.train(pts, iter([{"image": _nchw(batches[0])}]),
                        noise=[jax_eps(pts.rng, 0)])
    assert str(want["l_loss"].dtype) == "bfloat16"
    for k in LOSSES:
        assert str(got[k].dtype).replace("torch.", "") == \
            str(want[k].dtype), k
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=3e-2,
                                   err_msg=k)
