"""mean_depth_estimator and the uncomposed experimental_sampler held
against hemx.

* The estimator (E2 at its published widths) on a batch whose
  ``x_full`` / ``y_full`` are 53x70 beside 64x64 image / depth: it is built
  for and fed the full-frame keys (SAME stride-2 convs pad asymmetrically
  on the odd sizes, 53 -> 27 -> 14 -> 7 -> 4 -> 2 -> 1 by 70 -> 35 -> 18
  -> 9 -> 5 -> 3 -> 2; the flatten before ``l7`` is NHWC): eval_losses
  (rtol 5e-4 / atol 1e-5) and predict_mean (rtol 2e-3 / atol 1e-4)
  against hemx's at XLA backend level 0. Its train step is held in the
  entry point's first phase below.
* The uncomposed sampler's mean channel: the mean of the batch's ``mean``
  key, else of its depth, as hemx's own fallback computes it.
* ``python -m hemx_torch.experimental`` and the composed sampler's train
  call are held in tests/test_torch_experimental.py.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from tests.conftest import make_args  # noqa: E402
from tests.test_torch_paper_cgan import (  # noqa: E402,F401
    LOSS_TOL, PRED_TOL, _hemx_float32, _two_torch_threads, flat, nchw,
    port_batch, xla_opt0)

ADAM = dict(optimizer="adam", lr=1e-3, beta1=0.5, beta2=0.999)


@pytest.fixture(scope="module")
def est_ref():
    from hemx.models.plugin import get_model
    from hemx.parallel.dp import shard_batch
    from hemx.parallel.mesh import make_mesh
    args = make_args(model="mean_depth_estimator", batch_size=4, m_arch="E2",
                     synthetic_shape=[64, 64, 3], **ADAM)
    rng = np.random.default_rng(5)
    batch = {"image": rng.random((4, 64, 64, 3), dtype=np.float32),
             "depth": rng.random((4, 64, 64, 1), dtype=np.float32),
             "x_full": rng.random((4, 53, 70, 3), dtype=np.float32),
             "y_full": rng.random((4, 53, 70, 1), dtype=np.float32)}
    mesh = make_mesh(1)
    with xla_opt0():
        model = get_model("mean_depth_estimator")(args, mesh)
        ts = model.init_state(jax.random.PRNGKey(args.seed), batch)
        b = shard_batch(batch, mesh)
        return {"args": args, "batch": batch, "start": jax.device_get(ts),
                "evals": {k: float(v) for k, v in
                          jax.device_get(model.eval_losses(ts, b)).items()},
                "predict": np.asarray(model.predict_mean(ts, b))}


def _port_estimator(ref):
    from hemx_torch import convert
    from hemx_torch.models.plugin import get_model
    model = get_model("mean_depth_estimator")(ref["args"], "cpu")
    ts = model.init_state(model.input_shape(ref["batch"]), ref["args"].seed)
    convert.load_from_jax(ts.nets, ref["start"]["params"],
                          ref["start"]["mstate"])
    return model, ts


def test_estimator_builds_for_the_full_frame(est_ref):
    from hemx_torch import convert
    model, ts = _port_estimator(est_ref)
    assert model.input_shape(est_ref["batch"]) == (3, 53, 70)
    params, _ = convert.to_jax(ts.nets)
    assert params["l7"]["w"].shape == (1 * 2 * 2048, 2048)
    assert {k: v.shape for k, v in flat(params).items()} == \
        {k: v.shape for k, v in flat(est_ref["start"]["params"]).items()}


def test_estimator_eval_and_predict_match_hemx(est_ref):
    model, ts = _port_estimator(est_ref)
    b = port_batch(est_ref["batch"])
    evals = model.eval_losses(ts, b)
    assert set(evals) == set(est_ref["evals"])
    np.testing.assert_allclose(float(evals["m_loss"]),
                               est_ref["evals"]["m_loss"], **LOSS_TOL)
    m = model.predict_mean(ts, b)
    assert tuple(m.shape) == (4, 1)
    np.testing.assert_allclose(m.numpy(), est_ref["predict"], **PRED_TOL)
    # without the full-frame keys it reads image / depth, as hemx's _x_y
    from hemx.models.mean_depth_estimator import _x_y
    from hemx_torch.models.mean_depth_estimator import x_y
    small = {k: est_ref["batch"][k] for k in ("image", "depth")}
    assert [a.shape for a in x_y(port_batch(small))] == \
        [nchw(a).shape for a in _x_y(small)]


@pytest.mark.parametrize("keys", [("image", "depth", "mean"),
                                  ("image", "depth")])
def test_uncomposed_mean_channel_matches_hemx(keys):
    from hemx.models.experimental_sampler import ExperimentalSampler as H
    from hemx.parallel.mesh import make_mesh
    from hemx_torch.models.experimental_sampler import ExperimentalSampler
    args = make_args(model="experimental_sampler", g_sparsity=False,
                     g_rmse=False, estimator_epochs=30, batch_size=3)
    rng = np.random.default_rng(2)
    batch = {k: rng.random((3, 8, 8, 3 if k == "image" else 1),
                           dtype=np.float32) for k in keys}
    want = np.asarray(H(args, make_mesh(1))._mean_channel(
        {k: jax.numpy.asarray(v) for k, v in batch.items()}))
    port = ExperimentalSampler(args, "cpu")
    assert not port.composed() and "mean" in port.batch_keys
    got = port.mean_channel(port_batch(batch))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               rtol=1e-6)
    def flags(cls):  # names, types, defaults (help texts differ)
        return {k: {f: v for f, v in spec.items() if f != "help"}
                for k, spec in cls.arguments().items()}
    assert flags(ExperimentalSampler) == flags(H)
