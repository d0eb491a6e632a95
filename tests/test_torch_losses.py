"""hemx_torch's losses and IWGAN gradient penalty against hemx.ops.losses.

The penalty is compared in both norm modes (the reference's whole-batch
norm and the per-sample norm), for its value and for its gradient with
respect to the critic's weights (the double backward), on a small critic
(one 5x5 stride-2 conv + lrelu, NHWC flatten, dense -> 1) with the same
JAX-initialized weights. Tolerance rtol 1e-5 / atol 1e-6: float32 on the
CPU, sums in different orders.

The losses of the BASELINE models (L1, L2, Bernoulli reconstruction, KL,
the GAN log losses) are compared by value and gradient on the same
arrays, and at saturation: a sigmoid output of exactly 0 or 1 must give
the reference's eps-guarded, finite value.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from hemx.core import Ctx, sequential  # noqa: E402
from hemx.ops import layers as HL  # noqa: E402
from hemx.ops import losses as HLoss  # noqa: E402
from hemx.ops.activations import lrelu as h_lrelu  # noqa: E402
from hemx_torch import convert  # noqa: E402
from hemx_torch.ops import layers as TL  # noqa: E402
from hemx_torch.ops import losses as TLoss  # noqa: E402
from hemx_torch.ops.activations import lrelu as t_lrelu  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _hemx_float32():
    """hemx's compute dtype and precision are process-wide, and bench.main()
    in an earlier test of this worker may have left them at bfloat16:
    compare against, and leave behind, hemx's float32 defaults."""
    HL.set_compute_dtype(None)
    HL.set_default_precision("default")


TOL = dict(rtol=1e-5, atol=1e-6)
B, HW = 4, 8


def _nchw(x):
    return torch.from_numpy(x.copy()).permute(0, 3, 1, 2)


def _critics():
    h = sequential(HL.conv2d(4, 5, 2, activation=h_lrelu, name="c1"),
                   HL.flatten(), HL.dense(1, name="fc2"))
    params, state, _ = h.init(jax.random.PRNGKey(0), (B, HW, HW, 3))
    g = torch.Generator().manual_seed(0)
    t = TL.Sequential({"c1": TL.Conv2d(3, 4, 5, 2, activation=t_lrelu,
                                       generator=g),
                       "flatten": TL.Flatten(),
                       "fc2": TL.Dense(4 * 4 * 4, 1, generator=g)})
    convert.load_from_jax(t, jax.device_get(params), {})
    return h, params, state, t


@pytest.mark.parametrize("per_sample", [False, True])
def test_gradient_penalty_matches_hemx(per_sample):
    rng = np.random.default_rng(0)
    xr = rng.uniform(-1, 1, (B, HW, HW, 3)).astype(np.float32)
    xf = rng.uniform(-1, 1, (B, HW, HW, 3)).astype(np.float32)
    alpha = rng.uniform(0, 1, (B, 1)).astype(np.float32)
    h, params, state, t = _critics()

    def gp_fn(p):
        def d_apply(imgs):
            return h.apply(p, state, imgs, Ctx(training=True))[0].reshape(-1)
        return HLoss.gradient_penalty(d_apply, jnp.asarray(xr), jnp.asarray(xf),
                                      jnp.asarray(alpha), per_sample=per_sample)

    want, want_g = jax.jit(jax.value_and_grad(gp_fn))(params)
    got = TLoss.gradient_penalty(lambda z: t(z)[0].reshape(-1), _nchw(xr),
                                 _nchw(xf), torch.from_numpy(alpha),
                                 per_sample=per_sample)
    names = [n for n, _ in t.named_parameters()]
    # biases reach the penalty only through lrelu's piecewise-constant
    # slope: no autograd path, zero gradient (as JAX reports)
    grads = torch.autograd.grad(got, list(t.parameters()), allow_unused=True,
                                materialize_grads=True)
    np.testing.assert_allclose(got.item(), float(want), **TOL)
    want_g = convert.flatten_tree(jax.device_get(want_g))
    for n, g in zip(names, grads):
        np.testing.assert_allclose(convert.tensor_to_jax(t, n, g),
                                   want_g[tuple(n.split("."))], err_msg=n, **TOL)


def test_gradient_penalty_norm_modes_differ():
    """Whole-batch and per-sample norms are different functions (the
    reference's quirk is kept as the default, not silently fixed)."""
    rng = np.random.default_rng(1)
    xr = _nchw(rng.uniform(-1, 1, (B, HW, HW, 3)).astype(np.float32))
    xf = _nchw(rng.uniform(-1, 1, (B, HW, HW, 3)).astype(np.float32))
    alpha = torch.rand((B, 1), generator=torch.Generator().manual_seed(0))
    _, _, _, t = _critics()
    d = lambda z: t(z)[0].reshape(-1)  # noqa: E731
    whole = TLoss.gradient_penalty(d, xr, xf, alpha).detach()
    per = TLoss.gradient_penalty(d, xr, xf, alpha, per_sample=True).detach()
    assert abs(whole.item() - per.item()) > 1e-4


def test_wgan_losses_match_hemx():
    rng = np.random.default_rng(2)
    real = rng.standard_normal(8).astype(np.float32)
    fake = rng.standard_normal(8).astype(np.float32)
    np.testing.assert_allclose(
        float(TLoss.wgan_g_loss(torch.from_numpy(fake))),
        float(HLoss.wgan_g_loss(jnp.asarray(fake))), rtol=1e-6)
    np.testing.assert_allclose(
        float(TLoss.wgan_d_loss(torch.from_numpy(real), torch.from_numpy(fake))),
        float(HLoss.wgan_d_loss(jnp.asarray(real), jnp.asarray(fake))),
        rtol=1e-6)


def _pair(rng, shape, kind):
    if kind == "prob":  # a sigmoid output in (0, 1)
        return rng.uniform(0.01, 0.99, shape).astype(np.float32)
    return rng.standard_normal(shape).astype(np.float32)


# name -> argument kinds (hemx.ops.losses and hemx_torch.ops.losses)
NEW_LOSSES = {"l1_loss": ("real", "real"), "l2_loss": ("real", "real"),
              "bernoulli_recon_loss": ("prob", "prob"),
              "kl_gaussian_loss": ("real", "real"),
              "gan_g_loss": ("prob",), "gan_d_loss": ("prob", "prob")}


@pytest.mark.parametrize("name", sorted(NEW_LOSSES))
def test_model_losses_match_hemx(name):
    """Value and gradient of each loss on the same arrays (sum-reduced ones
    at rtol 1e-5 of their size)."""
    rng = np.random.default_rng(3)
    args = [_pair(rng, (4, 5, 6, 3), k) for k in NEW_LOSSES[name]]
    want, want_g = jax.value_and_grad(getattr(HLoss, name), argnums=tuple(
        range(len(args))))(*[jnp.asarray(a) for a in args])
    ts = [torch.from_numpy(a).requires_grad_(True) for a in args]
    got = getattr(TLoss, name)(*ts)
    got_g = torch.autograd.grad(got, ts)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5, atol=1e-6)
    for g, w in zip(got_g, want_g):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


def test_bernoulli_recon_loss_finite_at_saturation():
    """x_hat of exactly 1.0 under x == 1 and of 0.0 under x == 0 gives the
    reference's guarded value, with a finite gradient
    (tests/test_ops.py::test_vae_recon_loss_finite_at_saturation)."""
    x = torch.tensor([[1.0, 0.0, 0.5]])
    x_hat = torch.tensor([[1.0, 0.0, 0.5]], requires_grad=True)
    val = TLoss.bernoulli_recon_loss(x, x_hat)
    grad, = torch.autograd.grad(val, x_hat)
    assert np.isfinite(val.item()) and torch.isfinite(grad).all()
    want = -np.sum([np.log(1e-8 + 1.0), np.log(1e-8 + 1.0),
                    np.log(1e-8 + 0.5) * 0.5 + np.log(1e-8 + 0.5) * 0.5])
    assert val.item() == pytest.approx(want, rel=1e-5)
    np.testing.assert_allclose(
        val.item(), float(HLoss.bernoulli_recon_loss(
            jnp.asarray(x.numpy()), jnp.asarray(x_hat.detach().numpy()))),
        rtol=1e-6)


def test_gan_d_loss_finite_at_saturation():
    """d_fake of exactly 1.0 gives -log(eps), not -log(0) = inf
    (tests/test_ops.py::test_gan_d_loss_finite_at_saturation)."""
    d_real = torch.tensor([0.5, 1.0])
    d_fake = torch.tensor([1.0, 0.0])
    val = TLoss.gan_d_loss(d_real, d_fake)
    want = np.mean([-np.log(0.5 + 1e-8) - np.log(1e-8),
                    -np.log(1.0 + 1e-8) - np.log(1.0 + 1e-8)])
    assert np.isfinite(val.item())
    assert val.item() == pytest.approx(want, rel=1e-5)
    np.testing.assert_allclose(
        val.item(), float(HLoss.gan_d_loss(jnp.asarray(d_real.numpy()),
                                           jnp.asarray(d_fake.numpy()))),
        rtol=1e-6)
    assert np.isfinite(TLoss.gan_g_loss(torch.tensor([0.0, 1.0])).item())


def test_selu_matches_hemx():
    """hemx's constants, and a finite gradient where expm1 would overflow
    in the branch ``where`` does not take (x >~ 88.7)."""
    from hemx.ops.activations import selu as h_selu
    from hemx_torch.ops.activations import selu
    x = np.array([-1000.0, -20.0, -1.5, -1e-3, 0.0, 1e-3, 2.0, 88.0, 89.0,
                  1000.0], np.float32)
    want_y = np.asarray(h_selu(jnp.asarray(x)))
    want_g = np.asarray(jax.grad(lambda a: jnp.sum(h_selu(a)))(jnp.asarray(x)))
    t = torch.from_numpy(x).requires_grad_(True)
    y = selu(t)
    y.sum().backward()
    np.testing.assert_allclose(y.detach().numpy(), want_y, rtol=1e-6)
    np.testing.assert_allclose(t.grad.numpy(), want_g, rtol=1e-6)
    assert np.isfinite(t.grad.numpy()).all()


def test_guarded_one_minus_at_one_is_log_eps():
    """``log(guarded_one_minus(p) + eps)`` at p == 1.0 exactly is
    log(eps), not -inf, as hemx's is under jit."""
    p = torch.ones(3)
    got = torch.log(TLoss.guarded_one_minus(p) + 1e-8)
    want = jax.jit(lambda q: jnp.log(HLoss.guarded_one_minus(q) + 1e-8))(
        jnp.ones(3))
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
    np.testing.assert_allclose(got.numpy(), np.log(np.float32(1e-8)),
                               rtol=1e-6)
