"""hemx_torch layers held against hemx.ops.layers on the same inputs and
weights (JAX-initialized, loaded through hemx_torch.convert).

Each case compares the forward value, the new BN moving stats, and the
gradients with respect to the input and every weight of sum(y * ct) for a
fixed random cotangent ct, at rtol 1e-5 / atol 1e-5 (float32 on the CPU;
the two frameworks sum in different orders; the one exception, the
analytically-zero gradient of a bias followed by BN, is explained where it
is checked). The padding, transposed-conv
crop, biased-variance and NHWC-order hazards each change values, not
shapes, so every comparison is of values.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from hemx.core import Ctx  # noqa: E402
from hemx.ops import layers as HL  # noqa: E402
from hemx_torch import convert  # noqa: E402
from hemx_torch.ops import layers as TL  # noqa: E402
from hemx_torch.ops.activations import lrelu as t_lrelu  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _hemx_float32():
    """hemx's compute dtype and precision are process-wide, and bench.main()
    in an earlier test of this worker may have left them at bfloat16:
    compare against, and leave behind, hemx's float32 defaults."""
    HL.set_compute_dtype(None)
    HL.set_default_precision("default")


TOL = dict(rtol=1e-5, atol=1e-5)


def _hemx_lrelu(x):
    from hemx.ops.activations import lrelu
    return lrelu(x)


# name -> (hemx layer, torch layer ctor(in_ch, generator), input NHWC shape)
CASES = {
    "dense_bn_relu": (
        lambda: HL.dense(24, use_batch_norm=True, activation=jax.nn.relu),
        lambda c, g: TL.Dense(c, 24, use_batch_norm=True,
                              activation=torch.relu, generator=g),
        (6, 20)),
    "dense_plain": (
        lambda: HL.dense(1),
        lambda c, g: TL.Dense(c, 1, generator=g),
        (6, 40)),
    **{f"conv_s2_{hw}px_bn_lrelu": (
        lambda: HL.conv2d(8, 5, 2, use_batch_norm=True, activation=_hemx_lrelu),
        lambda c, g: TL.Conv2d(c, 8, 5, 2, use_batch_norm=True,
                               activation=t_lrelu, generator=g),
        (3, hw, hw, 3)) for hw in (32, 16, 8)},
    "conv_s2_lrelu_no_bn": (
        lambda: HL.conv2d(6, 5, 2, activation=_hemx_lrelu),
        lambda c, g: TL.Conv2d(c, 6, 5, 2, activation=t_lrelu, generator=g),
        (2, 16, 16, 4)),
    **{f"deconv_s2_{hw}px_bn_relu": (
        lambda: HL.deconv2d(4, 5, 2, use_batch_norm=True,
                            activation=jax.nn.relu),
        lambda c, g: TL.Deconv2d(c, 4, 5, 2, use_batch_norm=True,
                                 activation=torch.relu, generator=g),
        (3, hw, hw, 8)) for hw in (4, 8)},
    "deconv_s2_tanh_no_bn": (
        lambda: HL.deconv2d(3, 5, 2, activation=jnp.tanh),
        lambda c, g: TL.Deconv2d(c, 3, 5, 2, activation=torch.tanh,
                                 generator=g),
        (2, 16, 16, 6)),
}


def _to_torch_input(x):
    t = torch.from_numpy(x.copy())
    return t.permute(0, 3, 1, 2) if t.dim() == 4 else t


def _from_torch(t):
    t = t.detach()
    return (t.permute(0, 2, 3, 1) if t.dim() == 4 else t).numpy()


@pytest.mark.parametrize("case", sorted(CASES))
def test_layer_matches_hemx(case):
    make_h, make_t, shape = CASES[case]
    rng = np.random.default_rng(0)
    x = rng.standard_normal(shape).astype(np.float32)
    layer = make_h()
    params, state, out_shape = layer.init(jax.random.PRNGKey(1), shape)
    # cotangent at scale 0.1 keeps the weight gradients O(1), so the
    # float32 summation noise stays under atol 1e-5
    ct = (0.1 * rng.standard_normal(out_shape)).astype(np.float32)

    def loss(p, xx):
        y, s = layer.apply(p, state, xx, Ctx(training=True))
        return jnp.sum(y * ct), (y, s)

    (_, (y, new_state)), (gp, gx) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(params, jnp.asarray(x))

    net = make_t(shape[-1], torch.Generator().manual_seed(0))
    convert.load_from_jax(net, jax.device_get(params), jax.device_get(state))
    xt = _to_torch_input(x).requires_grad_(True)
    yt, stats = net(xt)
    (yt * _to_torch_input(ct)).sum().backward()

    np.testing.assert_allclose(_from_torch(yt), np.asarray(y), **TOL)
    np.testing.assert_allclose(_from_torch(xt.grad), np.asarray(gx), **TOL)
    want_g = convert.flatten_tree(jax.device_get(gp))
    got_g = {tuple(n.split(".")): convert.tensor_to_jax(net, n, p.grad)
             for n, p in net.named_parameters()}
    assert sorted(got_g) == sorted(want_g)
    for k in want_g:
        if k == ("b",) and stats:
            # a bias followed by BN has an analytic gradient of exactly 0 (BN
            # subtracts the batch mean); both sides return cancellation noise
            # of ~eps * sum|terms|, so check that both are zero to 2e-4
            assert np.abs(got_g[k]).max() <= 2e-4
            assert np.abs(want_g[k]).max() <= 2e-4
            continue
        np.testing.assert_allclose(got_g[k], want_g[k], err_msg=str(k), **TOL)
    # new moving stats, committed the way the generator step commits them
    TL.commit_moving_stats(net, stats)
    _, got_state = convert.to_jax(net)
    want_state = convert.flatten_tree(jax.device_get(new_state))
    got_state = convert.flatten_tree(got_state)
    assert sorted(got_state) == sorted(want_state)
    for k in want_state:
        np.testing.assert_allclose(got_state[k], want_state[k],
                                   err_msg=str(k), **TOL)


@pytest.mark.parametrize("shape", [(8, 5), (4, 6, 6, 3)])
def test_batch_norm_moving_stats(shape):
    """Decay 0.999, eps 1e-3, batch statistics, BIASED moving variance, and
    the buffers untouched until the caller commits."""
    rng = np.random.default_rng(2)
    x = (3.0 * rng.standard_normal(shape) + 1.5).astype(np.float32)
    bn = HL.batch_norm()
    params, state, _ = bn.init(jax.random.PRNGKey(0), shape)
    y, new_state = bn.apply(params, state, jnp.asarray(x), Ctx(training=True))
    tbn = TL.BatchNorm(shape[-1])
    yt, (mean, var) = tbn(_to_torch_input(x))
    np.testing.assert_allclose(_from_torch(yt), np.asarray(y), **TOL)
    np.testing.assert_allclose(mean.numpy(), np.asarray(new_state["mean"]), **TOL)
    np.testing.assert_allclose(var.numpy(), np.asarray(new_state["var"]), **TOL)
    axes = tuple(range(len(shape) - 1))
    biased = 0.999 * 1.0 + 0.001 * x.var(axis=axes)
    np.testing.assert_allclose(var.numpy(), biased, rtol=1e-5)
    assert torch.equal(tbn.var, torch.ones(shape[-1]))
    assert torch.equal(tbn.mean, torch.zeros(shape[-1]))


def test_flatten_and_unflatten_follow_nhwc_order():
    from hemx.models.common import unflatten as h_unflatten
    from hemx_torch.models.common import Unflatten
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 3, 5, 4)).astype(np.float32)
    want, _ = HL.flatten().apply({}, {}, jnp.asarray(x), Ctx())
    got, _ = TL.Flatten()(_to_torch_input(x))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    flat = rng.standard_normal((2, 4 * 4 * 6)).astype(np.float32)
    want, _ = h_unflatten(4, 4, 6).apply({}, {}, jnp.asarray(flat), Ctx())
    got, _ = Unflatten(4, 4, 6)(torch.from_numpy(flat))
    np.testing.assert_array_equal(_from_torch(got), np.asarray(want))
    assert got.is_contiguous(memory_format=torch.channels_last)


@pytest.mark.parametrize("in_dim,k,s", [(64, 5, 2), (32, 5, 2), (7, 5, 2),
                                        (9, 3, 1)])
def test_same_padding_is_xla_same(in_dim, k, s):
    """Output size and (lo, hi) split match XLA's SAME: lo = total // 2."""
    lo, hi = TL.same_padding(in_dim, k, s)
    out = (in_dim + lo + hi - k) // s + 1
    assert out == -(-in_dim // s)
    assert lo == (lo + hi) // 2


@pytest.mark.parametrize("shape", [(), (7,), (20, 24), (5, 5, 3, 8),
                                   (5, 5, 8, 16)])
def test_xavier_uniform_fans_and_limit(shape):
    """TF's fan rules (biases included: a 1-D shape has fan_in == fan_out ==
    its size), draws inside +-sqrt(6/(fan_in+fan_out)), reproducible from
    the torch.Generator."""
    import math
    from hemx.ops.initializers import _fans as hemx_fans
    from hemx_torch.ops.initializers import _fans, xavier_uniform
    assert _fans(shape) == hemx_fans(shape)
    limit = math.sqrt(6.0 / sum(_fans(shape)))
    a = xavier_uniform(shape, generator=torch.Generator().manual_seed(3))
    b = xavier_uniform(shape, generator=torch.Generator().manual_seed(3))
    assert a.shape == shape and a.dtype == torch.float32
    assert torch.equal(a, b)
    assert a.abs().max().item() <= limit
