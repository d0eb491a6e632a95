"""The bf16 compute policy of hemx_torch held against hemx under
``set_compute_dtype("bfloat16")``.

* Per layer (dense, conv and deconv, each with and without BN): the output
  dtype equals hemx's (bf16, or f32 where BN's f32 ``beta`` promotes it)
  and the values, the new BN moving stats and their dtypes agree within
  1e-2 of the largest |value| (two bf16 roundings of the same f32-accumulated
  sums may land an ulp apart, 2**-8 relative).
* One IWGAN train call from the same weights, batches and noise: losses
  rtol 3e-2, parameters and G's BN stats after sgd(1e-3) rtol 2e-3 /
  atol 1e-4 (the update is lr * grad, and bf16 gradients agree to about
  1e-2 relative, so parameter differences stay near 1e-5).

hemx keeps its compute dtype in a process global; the module fixture sets
it to bf16 and restores hemx's float32 default when the module ends, so no
later test in this worker computes in bf16.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from tests.conftest import make_args  # noqa: E402
from tests.test_torch_iwgan import _jax_noise, _nchw  # noqa: E402

B, LATENT, N_D, HW = 4, 16, 2, 32


@pytest.fixture(autouse=True, scope="module")
def hemx_bf16():
    from hemx.ops import layers
    layers.set_default_precision("default")
    layers.set_compute_dtype("bfloat16")
    yield
    layers.set_compute_dtype(None)
    layers.set_default_precision("default")


def _cases():
    from hemx.ops import layers as HL
    from hemx_torch.ops import layers as TL
    bf16 = torch.bfloat16
    return {
        "dense_bn_relu": (
            lambda: HL.dense(24, use_batch_norm=True, activation=jax.nn.relu),
            lambda c, g: TL.Dense(c, 24, use_batch_norm=True,
                                  activation=torch.relu, generator=g,
                                  dtype=bf16), (6, 20)),
        "dense_plain": (
            lambda: HL.dense(3),
            lambda c, g: TL.Dense(c, 3, generator=g, dtype=bf16), (6, 40)),
        "conv_bn": (
            lambda: HL.conv2d(8, 5, 2, use_batch_norm=True),
            lambda c, g: TL.Conv2d(c, 8, 5, 2, use_batch_norm=True,
                                   generator=g, dtype=bf16), (3, 16, 16, 3)),
        "conv_lrelu": (
            lambda: HL.conv2d(6, 5, 2, activation=_hemx_lrelu),
            lambda c, g: TL.Conv2d(c, 6, 5, 2, activation=_port_lrelu,
                                   generator=g, dtype=bf16), (2, 16, 16, 4)),
        "deconv_bn_relu": (
            lambda: HL.deconv2d(4, 5, 2, use_batch_norm=True,
                                activation=jax.nn.relu),
            lambda c, g: TL.Deconv2d(c, 4, 5, 2, use_batch_norm=True,
                                     activation=torch.relu, generator=g,
                                     dtype=bf16), (3, 8, 8, 8)),
        "deconv_tanh": (
            lambda: HL.deconv2d(3, 5, 2, activation=jnp.tanh),
            lambda c, g: TL.Deconv2d(c, 3, 5, 2, activation=torch.tanh,
                                     generator=g, dtype=bf16), (2, 8, 8, 6)),
    }


def _hemx_lrelu(x):
    from hemx.ops.activations import lrelu
    return lrelu(x)


def _port_lrelu(x):
    from hemx_torch.ops.activations import lrelu
    return lrelu(x)


def _dtype_name(t):
    return str(t.dtype).replace("torch.", "")


def _close_to_max(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-2 * np.abs(want).max())


CASE_NAMES = ["conv_bn", "conv_lrelu", "deconv_bn_relu", "deconv_tanh",
              "dense_bn_relu", "dense_plain"]


@pytest.mark.parametrize("case", CASE_NAMES)
def test_layer_dtype_and_values_match_hemx(case):
    from hemx.core import Ctx
    from hemx_torch import convert
    from hemx_torch.ops import layers as TL
    make_h, make_t, shape = _cases()[case]
    x = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    layer = make_h()
    params, state, _ = layer.init(jax.random.PRNGKey(1), shape)
    y, new_state = layer.apply(params, state, jnp.asarray(x),
                               Ctx(training=True))
    net = make_t(shape[-1], torch.Generator().manual_seed(0))
    convert.load_from_jax(net, jax.device_get(params), jax.device_get(state))
    xt = torch.from_numpy(x)
    if xt.dim() == 4:
        xt = xt.permute(0, 3, 1, 2)
    with torch.no_grad():
        yt, stats = net(xt)
    assert _dtype_name(yt) == str(y.dtype)
    yt = yt.permute(0, 2, 3, 1) if yt.dim() == 4 else yt
    _close_to_max(yt.float().numpy(), np.asarray(y, np.float32))
    TL.commit_moving_stats(net, stats)
    _, got_state = convert.to_jax(net)
    want = convert.flatten_tree(jax.device_get(new_state))
    got = convert.flatten_tree(got_state)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == np.asarray(want[k]).dtype == np.float32
        _close_to_max(got[k], want[k])


@pytest.fixture(scope="module")
def hemx_call():
    """One hemx IWGAN train call in bf16 (sgd 1e-3) and its start state."""
    from hemx.models.plugin import get_model
    from hemx.parallel.dp import shard_batch
    from hemx.parallel.mesh import make_mesh
    args = make_args(model="iwgan", batch_size=B, latent_size=LATENT,
                     n_disc_train=N_D, optimizer="sgd", lr=1e-3,
                     dtype="bfloat16", synthetic_shape=[HW, HW, 3])
    mesh = make_mesh(1)
    rng = np.random.default_rng(7)
    batches = [rng.random((B, HW, HW, 3), dtype=np.float32)
               for _ in range(N_D + 1)]
    model = get_model("iwgan")(args, mesh)
    ts = model.init_state(jax.random.PRNGKey(0), {"image": batches[0]})
    start = jax.device_get(ts)
    stream = iter([shard_batch({"image": b}, mesh) for b in batches])
    new_ts, metrics = model.train(ts, stream)
    return args, batches, start, jax.device_get(new_ts), \
        {k: np.asarray(v) for k, v in jax.device_get(metrics).items()}


def test_iwgan_train_call_bf16_matches_hemx(hemx_call):
    from hemx_torch import convert
    from hemx_torch.models.gan import IwganModel
    args, batches, start, want_ts, want_m = hemx_call
    model = IwganModel(args, "cpu")
    ts = model.init_state((3, HW, HW), args.seed)
    convert.load_from_jax(ts.nets, start["params"], start["mstate"])
    noise = _jax_noise(args.seed, 0, N_D, B, LATENT)
    ts, metrics = model.train(ts, iter([{"image": _nchw(b)} for b in batches]),
                              noise=noise)
    for k in ("g_loss", "d_loss"):
        # hemx's d_loss is f32 (Wasserstein bf16 + 10 * GP f32), g_loss bf16
        assert _dtype_name(metrics[k]) == str(want_m[k].dtype)
        np.testing.assert_allclose(float(metrics[k]), float(want_m[k]),
                                   rtol=3e-2, err_msg=k)
    params, mstate = convert.to_jax(ts.nets)
    for got, want in ((params, want_ts["params"]),
                      (mstate["generator"], want_ts["mstate"]["generator"])):
        g, w = convert.flatten_tree(got), convert.flatten_tree(want)
        assert sorted(g) == sorted(w)
        for k in w:
            assert g[k].dtype == np.float32
            np.testing.assert_allclose(g[k], np.asarray(w[k]), rtol=2e-3,
                                       atol=1e-4, err_msg="/".join(k))


def test_generator_and_critic_output_dtypes(hemx_call):
    """G's image and D's scores are bf16 (their last layers have no BN);
    master weights and BN stats stay f32."""
    from hemx_torch.models.gan import IwganModel
    args = hemx_call[0]
    model = IwganModel(args, "cpu")
    ts = model.init_state((3, HW, HW), 0)
    z = torch.randn(B, LATENT, generator=torch.Generator().manual_seed(0))
    g, _ = ts.nets["generator"](z)
    assert g.dtype == torch.bfloat16
    scores, _ = ts.nets["discriminator"](torch.cat([torch.rand_like(
        g, dtype=torch.float32), g]))
    assert scores.dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in ts.nets.parameters())
    assert all(b.dtype == torch.float32 for b in ts.nets.buffers())
