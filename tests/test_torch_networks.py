"""pix2pix's networks of hemx_torch.models.networks held against
hemx.models.networks.

* The U-Net and the PatchGAN on narrowed widths (``base`` 4, at most 32
  channels; PatchGAN channels 4-32) at 16-32 px, float64 on both sides,
  hemx jitted at XLA backend level 0 (``tests/test_torch_paper_cgan.py``
  says why): each noise site alone and all three, dropout 0.5 with the
  keep masks hemx's key chain draws (transposed from NHWC, not redrawn),
  each BN flag, batch 1 (BN over a 1x1 map of one row), and the PatchGAN
  at 30 px, where sizes halve rounding up. Output, new BN stats and the
  gradients of sum(y * ct) with respect to the input and every parameter
  agree within 1e-10 of each array's largest magnitude; the biases feeding
  BN are held near 0 on both sides instead.
* The 4x4 stride-2 SAME conv and deconv (new to the port) at the U-Net's
  ends: 2 -> 1 pads (1, 1), 1 -> 2 crops as ``deconv2d_op`` does.
* A 65 px input is refused by both packages with hemx's message; at the
  published widths (256 px) the port's trees equal hemx's leaf by leaf.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from hemx.models import networks as HN  # noqa: E402
from hemx_torch import convert  # noqa: E402
from hemx_torch.models import networks as TN  # noqa: E402
from tests.test_torch_depth_nets import (  # noqa: E402,F401
    _compare, _hemx_float32, _nchw, _x64)
from tests.test_torch_paper_cgan import (  # noqa: E402,F401
    XLA_OPT0, _two_torch_threads, g_noise)

TOL = 1e-10
NARROW = dict(base=4, max_filters=32)

# name -> (size, batch, unet keyword arguments)
UNETS = {
    "noise_input": (16, 2, dict(noise=("input",))),
    "noise_latent": (16, 2, dict(noise=("latent",))),
    "noise_end": (16, 2, dict(noise=("end",))),
    "noise_all_32px": (32, 2, dict(noise=("input", "latent", "end"))),
    "dropout_0.5": (32, 2, dict(dropout_keep=0.5)),
    "dropout_noise_bn_gen": (32, 3, dict(dropout_keep=0.5, bn_gen=True,
                                         noise=("input", "latent", "end"))),
    "bn_gen": (16, 2, dict(bn_gen=True)),
    "batch1_bn_gen_noise_input": (16, 1, dict(bn_gen=True,
                                              noise=("input",))),
}

# name -> (size, batch, bn_disc)
PATCHGANS = {"32px_bn": (32, 2, True), "30px": (30, 2, False),
             "30px_bn": (30, 3, True)}


def _init(layer, key, shape):
    """``layer.init`` as one jitted program (eager, every parameter's
    shape compiles its own ops)."""
    out = []

    def init(k):
        params, state, out_shape = layer.init(k, shape)
        out.append(out_shape)
        return params, state
    params, state = jax.jit(init, compiler_options=XLA_OPT0)(key)
    return params, state, out[0]


@pytest.mark.parametrize("case", sorted(UNETS))
def test_unet_matches_hemx(case):
    hw, b, kw = UNETS[case]
    x = np.random.default_rng(0).random((b, hw, hw, 3), dtype=np.float32)
    layer = HN.unet(1, **NARROW, **kw)
    params, state, out_shape = _init(layer, jax.random.PRNGKey(1), x.shape)
    net = TN.UNet((3, hw, hw), **NARROW, **kw,
                  generator=torch.Generator().manual_seed(0))
    ctx_rng = jax.random.PRNGKey(7)
    draws = g_noise(net, ctx_rng, b, hw)  # hemx's chain, float64 here
    assert list(draws) == list(net.noise_draws(b, hw, hw))
    if kw.get("dropout_keep"):
        assert [k for k in draws if k.startswith("keep")] == [
            "keep_d1", "keep_d2", "keep_d3"]
    _compare(layer, params, state, (jnp.asarray(x, jnp.float64),), ctx_rng,
             net, [_nchw(x)], {"kw": {"noise": draws}}, out_shape, tol=TOL,
             compiler_options=XLA_OPT0)


@pytest.mark.parametrize("case", sorted(PATCHGANS))
def test_patchgan_matches_hemx(case):
    hw, b, bn = PATCHGANS[case]
    x = np.random.default_rng(1).random((b, hw, hw, 4), dtype=np.float32)
    layer = HN.patchgan((4, 8, 16, 32), bn_disc=bn)
    params, state, out_shape = _init(layer, jax.random.PRNGKey(2), x.shape)
    net = TN.PatchGAN((4, hw, hw), (4, 8, 16, 32), bn_disc=bn,
                      generator=torch.Generator().manual_seed(0))
    _compare(layer, params, state, (jnp.asarray(x, jnp.float64),),
             jax.random.PRNGKey(0), net, [_nchw(x)], {}, out_shape, tol=TOL,
             compiler_options=XLA_OPT0)


def test_unet_draws_and_dropout_semantics():
    """The draws in hemx's order with the site shapes, d1's input 1,024
    channels under ``latent`` at 256 px, and the masks reaching the
    forward (their values are held against hemx above)."""
    g = torch.Generator().manual_seed(0)
    net = TN.UNet((3, 32, 32), **NARROW, noise=("end", "input", "latent"),
                  dropout_keep=0.25, generator=g)
    draws = net.noise_draws(2, 32, 32)
    assert list(draws) == ["z_input", "z_latent", "keep_d1", "keep_d2",
                           "keep_d3", "z_end"]
    assert draws["z_input"].shape == (2, 1, 32, 32)
    assert draws["z_latent"].shape == (2, 32, 1, 1)
    assert draws["z_end"].shape == (2, 1, 16, 16)
    assert [draws[f"keep_d{i}"].shape for i in (1, 2, 3)] == [
        (2, 32, 2, 2), (2, 16, 4, 4), (2, 8, 8, 8)]
    assert all(draws[f"keep_d{i}"].p == 0.25 for i in (1, 2, 3))
    full = TN.UNet((3, 256, 256), noise=("latent",), generator=g)
    assert full.n_down == 8 and full.d1_w.shape == (1024, 512, 4, 4)
    from hemx_torch.models.conditional import draw_noise
    x = torch.rand(2, 3, 32, 32, generator=g)
    nz = draw_noise(net, g, x)
    assert all(nz[k].dtype == torch.bool for k in nz if k.startswith("keep"))
    y1, _ = net(x, nz)
    dropped = {**nz, **{k: torch.zeros_like(v) for k, v in nz.items()
                        if k.startswith("keep")}}
    y0, _ = net(x, dropped)
    assert not torch.equal(y0, y1)
    with pytest.raises(ValueError, match="keep_d2"):
        net(x, {k: v for k, v in nz.items() if k != "keep_d2"})
    net.eval()  # hemx's Ctx(training=False): no masks drawn or applied
    assert not any(k.startswith("keep") for k in net.noise_draws(2, 32, 32))


@pytest.mark.parametrize("size,out", [(2, 1), (15, 8), (1, 2), (8, 16)])
def test_4x4_stride2_same_conv_and_deconv_match_hemx(size, out):
    """2 -> 1 (and an odd 15 -> 8) conv, 1 -> 2 (and 8 -> 16) deconv, at
    kernel 4, stride 2, SAME, as the U-Net's ends run them."""
    from hemx.ops import layers as HL
    from hemx_torch.ops import layers as TL
    if out < size:
        assert TL.same_padding(2, 4, 2) == (1, 1)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, size, size, 3))
    if out < size:
        w = rng.standard_normal((4, 4, 3, 5))
        want = HL.conv2d_op(jnp.asarray(x), jnp.asarray(w), 2, "SAME")
        got = TL.conv2d_op(_nchw(x), torch.from_numpy(w).permute(3, 2, 0, 1),
                           2, "SAME")
    else:
        w = rng.standard_normal((4, 4, 5, 3))  # [H, W, out, in]
        want = HL.deconv2d_op(jnp.asarray(x), jnp.asarray(w), (out, out), 2,
                              "SAME")
        got = TL.deconv2d_op(_nchw(x),
                             torch.from_numpy(w).permute(3, 2, 0, 1),
                             (out, out), 2, "SAME")
    assert tuple(got.shape) == (2, 5, out, out)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(),
                               np.asarray(want), rtol=1e-12, atol=1e-12)


def test_65px_refused_as_hemx_refuses_it():
    msg = "unet requires power-of-2 size, got 65"
    with pytest.raises(AssertionError, match=msg):
        HN.unet(1).init(jax.random.PRNGKey(0), (1, 65, 65, 3))
    with pytest.raises(ValueError, match=msg):
        TN.UNet((3, 65, 65), generator=torch.Generator())
    with pytest.raises(ValueError, match="square inputs, got 64x32"):
        TN.unet_stages(64, 32)


def _shapes(tree):
    return {k: tuple(v.shape) for k, v in convert.flatten_tree(tree).items()}


@pytest.mark.parametrize("bn", [False, True])
def test_full_width_trees_match_hemx(bn):
    """At 256 px and the published widths: the U-Net with every noise site
    and the PatchGAN on the 4-channel pair have hemx's parameter and state
    trees, leaf by leaf in shape."""
    g = torch.Generator().manual_seed(0)
    kw = dict(noise=("input", "latent", "end"), dropout_keep=0.5)
    pairs = [(HN.unet(1, bn_gen=bn, **kw), (1, 256, 256, 3),
              TN.UNet((3, 256, 256), bn_gen=bn, **kw, generator=g)),
             (HN.patchgan(bn_disc=bn), (1, 256, 256, 4),
              TN.PatchGAN((4, 256, 256), bn_disc=bn, generator=g))]
    for layer, shape, net in pairs:
        params, state = jax.eval_shape(
            lambda k: layer.init(k, shape)[:2], jax.random.PRNGKey(0))
        got_p, got_s = convert.to_jax(net)
        assert _shapes(got_p) == _shapes(params)
        assert _shapes(got_s) == _shapes(state)
