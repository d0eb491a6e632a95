"""The small ops of the depth slice held against hemx on the same inputs:
VALID convs and deconvs (the 5 -> 14 deconv one past its full transpose,
its gradient and its bias-only row), the stride-1 SAME deconv and the
1x1 stride-2 SAME conv on a 1x1 map, sigmoid_xent, rmse,
rmse_scale_invariant, the crops, colorize (against matplotlib's jet),
eigen_metrics and its accumulator, the normal initializer, optax's
rmsprop and adam at their defaults, and EventsWriter.moments.

Tolerances: float32 values and gradients rtol 1e-5 / atol 1e-5 (as
tests/test_torch_layers.py), a conv's or deconv's arrays within 1e-5 of
their largest magnitude (its weight gradient sums 2x31x31 products);
optimizer updates rtol 1e-6 (as
tests/test_torch_optimizers.py); crops, colorize and the moments' images
exactly.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def _hemx_float32():
    """hemx's compute dtype and precision are process-wide: compare
    against, and leave behind, hemx's float32 defaults."""
    from hemx.ops import layers
    layers.set_compute_dtype(None)
    layers.set_default_precision("default")
    yield
    layers.set_compute_dtype(None)
    layers.set_default_precision("default")


def _t(a):
    """NHWC numpy -> NCHW tensor."""
    return torch.from_numpy(np.array(a, np.float32)).permute(0, 3, 1, 2)


def _n(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


# (kind, input NHWC, kernel k, cin, cout, stride, padding, out size or None)
OPS = {
    "conv_valid_65_to_31": ("conv", (2, 65, 65, 3), 5, 3, 8, 2, "VALID", None),
    "conv_valid_5_to_1": ("conv", (2, 5, 5, 6), 5, 6, 4, 2, "VALID", None),
    "conv_same_1x1_s2_on_1x1": ("conv", (3, 1, 1, 6), 1, 6, 5, 2, "SAME",
                                None),
    "conv_same_5x5_s1_on_1x1": ("conv", (3, 1, 1, 6), 5, 6, 5, 1, "SAME",
                                None),
    "deconv_valid_1_to_5": ("deconv", (2, 1, 1, 6), 5, 6, 4, 2, "VALID", 5),
    "deconv_valid_5_to_14": ("deconv", (2, 5, 5, 6), 5, 6, 4, 2, "VALID", 14),
    "deconv_valid_5_to_13": ("deconv", (2, 5, 5, 6), 5, 6, 4, 2, "VALID", 13),
    "deconv_valid_14_to_31": ("deconv", (2, 14, 14, 4), 5, 4, 3, 2, "VALID",
                              31),
    "deconv_same_s1_14": ("deconv", (2, 14, 14, 5), 5, 5, 5, 1, "SAME", 14),
}


@pytest.mark.parametrize("case", sorted(OPS))
def test_conv_deconv_match_hemx(case):
    """Values and gradients (input and kernel) of sum(y * ct)."""
    from hemx.ops.layers import conv2d_op as h_conv, deconv2d_op as h_deconv
    from hemx_torch.ops.layers import conv2d_op, deconv2d_op
    kind, shape, k, cin, cout, s, pad, out = OPS[case]
    rng = np.random.default_rng(0)
    x = rng.standard_normal(shape).astype(np.float32)
    wshape = (k, k, cin, cout) if kind == "conv" else (k, k, cout, cin)
    w = (0.2 * rng.standard_normal(wshape)).astype(np.float32)

    def h(xx, ww):
        if kind == "conv":
            return h_conv(xx, ww, s, pad)
        return h_deconv(xx, ww, (out, out), s, pad)
    y = h(jnp.asarray(x), jnp.asarray(w))
    ct = rng.standard_normal(y.shape).astype(np.float32)
    gx, gw = jax.grad(lambda a, b: jnp.sum(h(a, b) * ct), (0, 1))(
        jnp.asarray(x), jnp.asarray(w))

    xt = _t(x).requires_grad_(True)
    wt = torch.from_numpy(w).permute(3, 2, 0, 1).contiguous().requires_grad_(
        True)
    yt = (conv2d_op(xt, wt, s, pad) if kind == "conv"
          else deconv2d_op(xt, wt, (out, out), s, pad))
    (yt * _t(ct)).sum().backward()
    for got, want in ((_n(yt), y), (_n(xt.grad), gx),
                      (wt.grad.permute(2, 3, 1, 0).numpy(), gw)):
        want = np.asarray(want)
        # sums of up to 2x31x31 products: each array within 1e-5 of its
        # largest magnitude
        assert got.shape == want.shape
        assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def test_deconv_extra_row_holds_the_bias_only():
    """5 -> 14: the transpose fills 13 rows and columns; the 14th of each
    is zero before the bias, so after ``+ b`` it is b, and no gradient
    reaches the input from it."""
    from hemx_torch.models.depth_nets import DepthNet
    from hemx_torch.ops.initializers import xavier_uniform
    net = DepthNet(xavier_uniform, torch.Generator().manual_seed(0), None)
    net.add_deconv("d", 5, 6, 4)
    net.done()
    x = torch.randn(2, 6, 5, 5, requires_grad=True)
    y = net.deconv("d", x, 14, 2, "VALID", None, False, {})
    assert y.shape == (2, 4, 14, 14)
    b = net.d_b.detach().view(1, 4, 1)
    torch.testing.assert_close(y[:, :, 13, :].detach(), b.expand(2, 4, 14),
                               rtol=0, atol=0)
    torch.testing.assert_close(y[:, :, :, 13].detach(), b.expand(2, 4, 14),
                               rtol=0, atol=0)
    y[:, :, 13, :].sum().backward()
    assert x.grad.abs().max().item() == 0.0


def test_deconv_refuses_sizes_outside_tf_range():
    from hemx_torch.ops.layers import deconv2d_op
    x = torch.zeros(1, 2, 5, 5)
    w = torch.zeros(2, 3, 5, 5)
    for out, pad in ((12, "VALID"), (15, "VALID"), (11, "SAME")):
        with pytest.raises(ValueError, match="legal"):
            deconv2d_op(x, w, (out, out), 2, pad)


def test_sigmoid_xent_rmse_match_hemx():
    from hemx.ops import losses as H
    from hemx_torch.ops import losses as T
    rng = np.random.default_rng(1)
    z = np.concatenate([rng.standard_normal(50) * 8,
                        [0.0, 80.0, -80.0]]).astype(np.float32)
    for label in (0.0, 1.0):
        lab = np.full_like(z, label)
        want = np.asarray(H.sigmoid_xent(jnp.asarray(z), jnp.asarray(lab)))
        gw = np.asarray(jax.grad(lambda a: jnp.sum(H.sigmoid_xent(
            a, jnp.asarray(lab))))(jnp.asarray(z)))
        zt = torch.from_numpy(z).requires_grad_(True)
        got = T.sigmoid_xent(zt, torch.from_numpy(lab))
        got.sum().backward()
        np.testing.assert_allclose(got.detach().numpy(), want, **TOL)
        np.testing.assert_allclose(zt.grad.numpy(), gw, **TOL)
        assert np.isfinite(got.detach().numpy()).all()
    a = rng.random((3, 29, 29, 1)).astype(np.float32)
    b = rng.random((3, 29, 29, 1)).astype(np.float32)
    for name in ("rmse", "rmse_scale_invariant"):
        want = float(getattr(H, name)(jnp.asarray(a), jnp.asarray(b)))
        got = float(getattr(T, name)(torch.from_numpy(a), torch.from_numpy(b)))
        np.testing.assert_allclose(got, want, **TOL)


def test_crops_and_rescale_match_hemx():
    from hemx.ops import images as H
    from hemx_torch.ops import images as T
    x = np.random.default_rng(2).random((2, 65, 65, 1)).astype(np.float32)
    got = _n(T.center_crop(_t(x), 0.4769))
    assert got.shape == (2, 31, 31, 1)  # round(65 * 0.4769) = 31
    np.testing.assert_array_equal(got, np.asarray(H.center_crop(x, 0.4769)))
    np.testing.assert_array_equal(
        _n(T.crop_to_bounding_box(_t(x), 17, 17, 29, 29)),
        np.asarray(H.crop_to_bounding_box(x, 17, 17, 29, 29)))
    np.testing.assert_allclose(T.rescale(x, (0, 1), (-1, 1)),
                               np.asarray(H.rescale(x, (0, 1), (-1, 1))),
                               **TOL)


def test_colorize_matches_matplotlib_jet():
    """The port's table equals matplotlib's jet at every entry, including
    how 1.0, values out of [0, 1] and NaN pick theirs; colorize equals
    hemx's (which calls matplotlib) exactly."""
    import matplotlib
    from hemx.ops.images import colorize as h_colorize
    from hemx_torch.ops.images import colorize, jet
    x = np.concatenate([np.linspace(-0.2, 1.2, 20001),
                        [0.0, 1.0, np.nan, np.nextafter(1.0, 0.0),
                         255 / 256, 1 / 256]])
    np.testing.assert_array_equal(jet(x), matplotlib.colormaps["jet"](x)[
        ..., :3])
    imgs = np.random.default_rng(3).random((3, 9, 7, 1)).astype(np.float32)
    imgs[1] = 0.25  # a flat image: normalized by the 1e-12 floor
    np.testing.assert_array_equal(colorize(imgs), h_colorize(imgs))
    np.testing.assert_array_equal(colorize(imgs[0]), h_colorize(imgs[0]))
    assert colorize(imgs).dtype == np.float32


def test_eigen_metrics_and_accumulator_match_hemx():
    from hemx.metrics import eigen as H
    from hemx_torch.metrics import eigen as T
    rng = np.random.default_rng(4)
    y = rng.uniform(0.05, 1.0, (3, 29, 29, 1)).astype(np.float32)
    y_hat = rng.uniform(0.05, 1.0, (3, 29, 29, 1)).astype(np.float32)
    want = {k: float(v) for k, v in H.eigen_metrics(y, y_hat).items()}
    got = {k: float(v) for k, v in T.eigen_metrics(y, y_hat).items()}
    assert set(got) == set(want) == {
        "linear_rmse", "log_rmse", "abs_rel_diff", "squared_rel_diff",
        "scale_invariant_log_rmse", "t1", "t2", "t3"}
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, rtol=1e-5,
                                   atol=1e-6)
    # the quirks: relative errors over y_hat; the scale-invariant error has
    # no square root
    d = np.log(y.astype(np.float64) + 1e-8) - np.log(y_hat + 1e-8)
    np.testing.assert_allclose(got["abs_rel_diff"],
                               np.mean(np.abs(y - y_hat) / y_hat), rtol=1e-5)
    np.testing.assert_allclose(got["scale_invariant_log_rmse"],
                               np.mean(d ** 2) - np.mean(d) ** 2, rtol=1e-4)
    acc_h, acc_t = H.EigenAccumulator(), T.EigenAccumulator()
    for batch in ({"a": 1.0, "b": 2.0}, {"a": float("nan"), "b": 4.0},
                  {"a": 3.0, "b": float("inf")}):
        acc_h.update(batch)
        acc_t.update({k: torch.tensor(v) for k, v in batch.items()})
    assert acc_t.result() == acc_h.result() == {"a": 2.0, "b": 3.0}


def test_normal_initializer_draws_stddev_normal():
    from hemx_torch.ops.initializers import normal
    g = torch.Generator().manual_seed(0)
    w = normal(0.02)((5, 5, 64, 128), generator=g)
    assert w.shape == (5, 5, 64, 128) and w.dtype == torch.float32
    assert abs(w.std().item() - 0.02) < 5e-4 and abs(w.mean().item()) < 5e-4


@pytest.mark.parametrize("name", ["rmsprop", "adam"])
def test_optax_default_transforms_match_optax(name):
    """optax.rmsprop(lr) (accumulator from zeros, eps 1e-8 inside the sqrt,
    an identity third slot) and optax.adam(lr): three updates and the
    states' names and values."""
    import optax
    from flax.serialization import to_state_dict
    from hemx_torch.train import optimizers as O
    lr = 1e-3
    tx = optax.rmsprop(lr) if name == "rmsprop" else optax.adam(lr)
    mine = O.rmsprop(lr) if name == "rmsprop" else O.adam(lr)
    rng = np.random.default_rng(5)
    p = {"w": rng.standard_normal((4, 3)).astype(np.float32)}
    state = tx.init({k: jnp.asarray(v) for k, v in p.items()})
    tp = {k: torch.from_numpy(v.copy()) for k, v in p.items()}
    tstate = mine.init(tp)
    for _ in range(3):
        g = {"w": rng.standard_normal((4, 3)).astype(np.float32)}
        u, state = tx.update({k: jnp.asarray(v) for k, v in g.items()}, state)
        tu, tstate = mine.update({k: torch.from_numpy(v) for k, v in g.items()},
                                 tstate, tp)
        np.testing.assert_allclose(tu["w"].numpy(), np.asarray(u["w"]),
                                   rtol=1e-6, atol=1e-9)
    want = to_state_dict(state)
    assert sorted(want) == sorted(tstate)
    for slot in want:
        assert sorted(want[slot]) == sorted(tstate[slot]), slot


def test_events_moments_match_hemx(tmp_path):
    """EventsWriter.moments writes hemx's mean and variance scalars and
    its colorized variance image, read back from both files."""
    from hemx.summaries.events import EventsWriter as HW
    from hemx.summaries.reader import event_files, iter_events
    from hemx_torch.summaries.events import EventsWriter as TW
    batch = np.random.default_rng(6).random((5, 8, 6, 3)).astype(np.float32)
    for writer, d in ((HW, "h"), (TW, "t")):
        w = writer(str(tmp_path / d))
        w.moments("depth", batch, 7)
        w.moments("flat", batch[..., 0].reshape(5, -1), 8)
        w.close()

    def values(d):
        out = {}
        for path in event_files(str(tmp_path / d)):
            for ev in iter_events(path):
                for v in ev["values"]:
                    out[(ev["step"], v["tag"])] = v.get("simple_value",
                                                        v.get("image"))
        return out
    want, got = values("h"), values("t")
    assert sorted(got) == sorted(want) == [
        (7, "depth/mean"), (7, "depth/variance"),
        (7, "depth/variance_image"), (8, "flat/mean"), (8, "flat/variance")]
    assert got == want


def test_bf16_policy_of_the_depth_nets_matches_hemx():
    """Under --dtype bfloat16 every conv and deconv of the depth nets casts
    at hemx's points (hemx/ops/layers.py:78-83): a layer without BN
    outputs bf16, with BN f32; so the BN U-Net's output is f32 and the
    BN-free late critic's bf16, as hemx's, and their values agree within
    bf16 rounding carried through the net: 5e-2 of the output's scale (the
    two frameworks sum each product in its own order before rounding it to
    bf16; measured 1.2 % for the BN U-Net)."""
    from hemx.core import Ctx
    from hemx.models import depth_nets as HD
    from hemx.ops import layers as HL
    from hemx_torch import convert
    from hemx_torch.models import depth_nets as TD
    rng = np.random.default_rng(7)
    x = rng.random((2, 65, 65, 3), dtype=np.float32)
    d = rng.random((2, 31, 31, 1), dtype=np.float32)
    pairs = [(HD.valid_unet(use_batch_norm=True, final_activation=None,
                            final_filter=1),
              lambda g: TD.ValidUnet((3, 65, 65), use_batch_norm=True,
                                     final_activation=None, final_filter=1,
                                     generator=g, dtype=torch.bfloat16),
              jnp.asarray(x), _t(x), torch.float32),
             (HD.two_path_disc(variant="late"),
              lambda g: TD.TwoPathDisc((3, 65, 65), variant="late",
                                       generator=g, dtype=torch.bfloat16),
              (jnp.asarray(x), jnp.asarray(d)), (_t(x), _t(d)),
              torch.bfloat16)]
    HL.set_compute_dtype("bfloat16")
    try:
        for layer, make, h_in, t_in, dtype in pairs:
            params, state, _ = layer.init(jax.random.PRNGKey(0),
                                          (2, 65, 65, 3))
            want, _ = layer.apply(params, state, h_in, Ctx(training=True))
            net = make(torch.Generator().manual_seed(0))
            convert.load_from_jax(net, jax.device_get(params),
                                  jax.device_get(state))
            got, _ = net(t_in)
            assert str(got.dtype).split(".")[-1] == str(want.dtype)
            assert got.dtype == dtype
            diff = np.abs(_n(got.float()) - np.asarray(want, np.float32))
            assert diff.max() <= 5e-2 * np.abs(np.asarray(want)).max()
    finally:
        HL.set_compute_dtype(None)
