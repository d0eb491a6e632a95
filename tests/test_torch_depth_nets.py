"""The depth nets of hemx_torch (hemx_torch/models/depth_nets.py) held
against hemx.models.depth_nets (valid_unet, two_path_disc) and
hemx.models.paper_family.noise_site_generator on the same inputs, weights
(JAX-initialized, loaded through hemx_torch.convert) and noise (drawn by
hemx's Ctx key chain, passed NCHW), at batch 2, in float64 on both sides.

Each case compares the output, the new BN moving stats and the gradients
of sum(y * ct) for a fixed cotangent with respect to the inputs and every
parameter, each array within 1e-9 of its largest magnitude (``_close``):
the two implementations compute the same function to float64 rounding.
float64 because these nets are ill-conditioned in float32 once BN is in
them (a bias feeding BN has an exactly-zero gradient, and BN at 1x1 over a
few rows cancels most of its input gradient): at batch 4 the float32
input gradient of the BN U-Nets differs from the float64 one by up to
0.7 % of its scale, in hemx and in the port alike, so a float32
comparison would measure rounding, not the port. The float32 paths (the
casts, the models' train calls) are held to hemx in float32 by the model
tests.

The reference runs eagerly: jitted on the CPU, XLA's backend optimizer
miscompiles the gradient of the BN nets (ROADMAP section 3).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from hemx.core import Ctx  # noqa: E402
from hemx.models import depth_nets as HD  # noqa: E402
from hemx.models import paper_family as HF  # noqa: E402
from hemx.ops import initializers as HI  # noqa: E402
from hemx_torch import convert  # noqa: E402
from hemx_torch.models import depth_nets as TD  # noqa: E402
from hemx_torch.ops import initializers as TI  # noqa: E402
from tests.test_torch_paper_cgan import _two_torch_threads  # noqa: E402,F401

B = 2


@pytest.fixture(autouse=True)
def _x64():
    """JAX in float64 for the test, as it was after."""
    before = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", before)


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


def _nchw(a):
    """NHWC numpy -> a contiguous NCHW float64 tensor."""
    return torch.from_numpy(np.array(a, np.float64)).permute(
        0, 3, 1, 2).contiguous()


def _f64(tree):
    return jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), tree)


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


# name -> (hemx layer, port ctor(in_shape, generator), input size)
GENS = {
    "unet_paper_mean_at_e1_61px": (
        lambda: HD.valid_unet(mean_at_e1=True, final_activation=None,
                              final_filter=1, final_crop=29),
        lambda s, g: TD.ValidUnet(s, mean_at_e1=True, final_activation=None,
                                  final_filter=1, final_crop=29, generator=g),
        61),
    "unet_large_bn_noise_tanh": (
        lambda: HD.valid_unet(noise_channel=True, garch="large",
                              use_batch_norm=True),
        lambda s, g: TD.ValidUnet(s, noise_channel=True, garch="large",
                                  use_batch_norm=True, generator=g),
        65),
}

DISCS = {
    "paper_extra_channels": (
        lambda: HD.two_path_disc(variant="paper", depth_extra_channels=1,
                                 rgb_extra_channels=1),
        lambda s, g: TD.TwoPathDisc(s, variant="paper", depth_extra_channels=1,
                                    rgb_extra_channels=1, generator=g),
        (4, 2, 29)),
    "late_bn": (
        lambda: HD.two_path_disc(variant="late", use_batch_norm=True),
        lambda s, g: TD.TwoPathDisc(s, variant="late", use_batch_norm=True,
                                    generator=g),
        (3, 1, 31)),
}


def _close(got, want, what="", tol=1e-9):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, what
    err = np.abs(got - want).max() if want.size else 0.0
    assert err <= tol * np.abs(want).max() + 1e-12, (what, err,
                                                     np.abs(want).max())


def _bn_biases(net) -> set:
    """Parameter names of the biases that feed a BN."""
    return {f"{n[:-3]}_b" for n, _ in net.named_children()
            if n.endswith("_bn")}


def _compare(hemx_layer, params, state, h_inputs, ctx_rng, net, t_inputs,
             t_kwargs, out_shape, tol=1e-9, compiler_options=None):
    rng = np.random.default_rng(3)
    ct = 0.1 * rng.standard_normal(out_shape)
    params, state = _f64(params), _f64(state)

    def loss(p, xs):
        y, s = hemx_layer.apply(p, state, xs if len(xs) > 1 else xs[0],
                                Ctx(training=True, rng=ctx_rng))
        return jnp.sum(y * ct), (y, s)

    grad = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)
    if compiler_options is not None:  # one program instead of eager ops
        grad = jax.jit(grad, compiler_options=compiler_options)
    (_, (y, new_state)), (gp, gx) = grad(params, h_inputs)

    # hemx's float32 draws are exact in float32, so the load loses nothing;
    # PyTorch's CPU float64 convolutions take contiguous tensors
    convert.load_from_jax(net, jax.device_get(params), jax.device_get(state))
    net.double().to(memory_format=torch.contiguous_format)
    xs = [t.clone().requires_grad_(True) for t in t_inputs]
    yt, stats = net(xs[0] if len(xs) == 1 and not t_kwargs.get("pair")
                    else tuple(xs), **t_kwargs.get("kw", {}))
    (yt * _nchw(ct)).sum().backward()

    _close(_nhwc(yt), y, "output", tol)
    for xt, g in zip(xs, gx):
        _close(_nhwc(xt.grad), g, "input gradient", tol)
    want = convert.flatten_tree(jax.device_get(gp))
    got = {tuple(n.split(".")): convert.tensor_to_jax(net, n, p.grad)
           for n, p in net.named_parameters()}
    assert sorted(got) == sorted(want)
    scale = max(np.abs(v).max() for v in want.values())
    skip = _bn_biases(net)
    for k in want:
        if k[0] in skip:
            assert np.abs(got[k]).max() <= 1e-3 * scale, k
            assert np.abs(want[k]).max() <= 1e-3 * scale, k
            continue
        _close(got[k], want[k], k, tol)
    from hemx_torch.ops.layers import commit_moving_stats
    commit_moving_stats(net, stats)
    _, got_state = convert.to_jax(net)
    got_s = convert.flatten_tree(got_state)
    want_s = convert.flatten_tree(jax.device_get(new_state))
    assert sorted(got_s) == sorted(want_s)
    for k in want_s:
        _close(got_s[k], want_s[k], k, tol)


@pytest.mark.parametrize("case", sorted(GENS))
def test_generator_matches_hemx(case):
    make_h, make_t, hw = GENS[case]
    rng = np.random.default_rng(0)
    x = rng.random((B, hw, hw, 3), dtype=np.float32)
    layer = make_h()
    params, state, out_shape = layer.init(jax.random.PRNGKey(1), x.shape)
    net = make_t((3, hw, hw), torch.Generator().manual_seed(0))
    assert state["_"].shape == () and "_" in dict(net.named_buffers())
    ctx_rng = jax.random.PRNGKey(7)
    kw = {}
    draw = net.noise_draws(B, hw, hw).get("z")
    if draw is not None:
        n, c, h, w = draw.shape
        z = jax.random.uniform(jax.random.split(ctx_rng)[1], (n, h, w, c),
                               minval=draw.lo, maxval=draw.hi)
        kw["noise"] = _nchw(np.asarray(z))
    h_inputs, t_inputs = (jnp.asarray(x, jnp.float64),), [_nchw(x)]
    if "mean_at_e1" in case:
        y_bar = rng.random((B, 1, 1, 1))
        h_inputs += (jnp.asarray(y_bar),)
        kw["y_bar"] = torch.from_numpy(y_bar)
        # y_bar's gradient is not compared (it is a keyword here)
        h_inputs = (h_inputs[0], jax.lax.stop_gradient(h_inputs[1]))
    _compare(layer, params, state, h_inputs, ctx_rng, net, t_inputs,
             {"kw": kw}, out_shape)


@pytest.mark.parametrize("case", sorted(DISCS))
def test_discriminator_matches_hemx(case):
    make_h, make_t, (c_rgb, c_depth, d_hw) = DISCS[case]
    rng = np.random.default_rng(1)
    x = rng.random((B, 65, 65, c_rgb), dtype=np.float32)
    d = rng.random((B, d_hw, d_hw, c_depth), dtype=np.float32)
    layer = make_h()
    params, state, out_shape = layer.init(jax.random.PRNGKey(2),
                                          (B, 65, 65, 3))
    net = make_t((3, 65, 65), torch.Generator().manual_seed(0))
    _compare(layer, params, state,
             (jnp.asarray(x, jnp.float64), jnp.asarray(d, jnp.float64)),
             jax.random.PRNGKey(0), net, [_nchw(x), _nchw(d)], {"pair": True},
             out_shape)


def test_fresh_port_nets_have_hemx_trees():
    """Parameter and state trees (flat names, BN subtrees, the '_' scalar,
    kernel layouts) of freshly built port nets equal hemx's, leaf by leaf
    in shape."""
    g = torch.Generator().manual_seed(0)
    pairs = [(HD.valid_unet(garch="large", use_batch_norm=True,
                            mean_at_e1=True),
              TD.ValidUnet((3, 65, 65), garch="large", use_batch_norm=True,
                           mean_at_e1=True, generator=g)),
             (HF.noise_site_generator("e4-512", True),
              TD.NoiseSiteGenerator((3, 65, 65), noise_layer="e4-512",
                                    e_bn=True, generator=g))]
    for make_h, make_t, _ in DISCS.values():
        pairs.append((make_h(), make_t((3, 65, 65), g)))
    for layer, net in pairs:
        params, state, _ = layer.init(jax.random.PRNGKey(0), (B, 65, 65, 3))
        for got, want in zip(convert.to_jax(net), (params, state)):
            assert ({k: v.shape for k, v in convert.flatten_tree(got).items()}
                    == {k: tuple(v.shape) for k, v in
                        convert.flatten_tree(jax.device_get(want)).items()})


def test_nets_refuse_missing_noise_and_bad_options():
    g = torch.Generator().manual_seed(0)
    net = TD.ValidUnet((3, 65, 65), noise_channel=True, generator=g)
    with pytest.raises(ValueError, match="noise of shape"):
        net(torch.zeros(1, 3, 65, 65))
    with pytest.raises(ValueError, match="garch"):
        TD.ValidUnet((3, 65, 65), garch="huge", generator=g)
    with pytest.raises(ValueError, match="variant"):
        TD.TwoPathDisc((3, 65, 65), variant="mid", generator=g)
    with pytest.raises(ValueError, match="noise_layer"):
        TD.NoiseSiteGenerator((3, 65, 65), noise_layer="d1", generator=g)
