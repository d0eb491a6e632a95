"""hemx_torch's optimizer switch held against hemx's optax transforms.

Every name of ``hemx.train.optimizers.init_optimizer`` (plus rmsprop
centered and with momentum 0, and momentum 0): three steps from the same
parameters with the same gradients, through a conv+BN / flatten / dense
stack so the layout permutes of the state are exercised. Parameters and
every optimizer state leaf agree at rtol 1e-6 (float32 on the CPU; the two
frameworks may round rsqrt, pow and a division by a scalar an ulp apart),
with atol 1e-9 for entries that sit near zero; the state trees have
optax's names and structure, empty states included.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import optax  # noqa: E402
from flax import serialization  # noqa: E402

from tests.conftest import make_args  # noqa: E402


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


CASES = {
    "rmsprop": dict(optimizer="rmsprop"),
    "rmsprop_centered": dict(optimizer="rmsprop", centered=True),
    "rmsprop_momentum0": dict(optimizer="rmsprop", momentum=0.0),
    "adadelta": dict(optimizer="adadelta", lr=1.0),
    "adagrad": dict(optimizer="adagrad"),
    "padagrad": dict(optimizer="padagrad"),
    "sgd": dict(optimizer="sgd"),
    "pgd": dict(optimizer="pgd"),
    "momentum": dict(optimizer="momentum", momentum=0.9),
    "momentum0": dict(optimizer="momentum", momentum=0.0),
    "adam": dict(optimizer="adam", beta1=0.5, beta2=0.9),
    "ftrl": dict(optimizer="ftrl"),
}


def _net():
    from hemx_torch.ops.layers import Conv2d, Dense, Flatten, Sequential
    g = torch.Generator().manual_seed(0)
    return Sequential({"c1": Conv2d(3, 4, 3, 2, use_batch_norm=True,
                                    generator=g),
                       "flatten": Flatten(),
                       "fc": Dense(4 * 4 * 4, 2, generator=g)})


def _spec(tree):
    if isinstance(tree, dict):
        return {k: _spec(v) for k, v in tree.items()}
    return np.shape(tree)


def _assert_trees_close(got, want, rtol=1e-6, atol=1e-9):
    from hemx_torch.convert import flatten_tree
    assert _spec(got) == _spec(want)
    g, w = flatten_tree(got), flatten_tree(want)
    for k in w:
        np.testing.assert_allclose(np.asarray(g[k]), np.asarray(w[k]),
                                   rtol=rtol, atol=atol, err_msg="/".join(k))


@pytest.mark.parametrize("case", sorted(CASES))
def test_optimizer_matches_optax(case):
    from hemx.train.optimizers import init_optimizer as hemx_init
    from hemx_torch import convert
    from hemx_torch.train.optimizers import init_optimizer
    args = make_args(**{"lr": 1e-2, **CASES[case]})
    net = _net()
    params, _ = convert.to_jax(net)
    tx = hemx_init(args)
    state = tx.init(params)
    opt = init_optimizer(args, net)
    rng = np.random.default_rng(4)
    for _ in range(3):
        grads = jax.tree_util.tree_map(
            lambda p: rng.standard_normal(np.shape(p)).astype(np.float32),
            params)
        updates, state = tx.update(grads, state, params)
        params = jax.device_get(optax.apply_updates(params, updates))
        sd = convert.state_dict_from_jax(net, grads, {})
        opt.step([sd[n].contiguous() for n, _ in net.named_parameters()])
    got, _ = convert.to_jax(net)
    _assert_trees_close(got, params)
    _assert_trees_close(convert.opt_state_to_jax(opt),
                        serialization.to_state_dict(jax.device_get(state)))


def test_rmsprop_is_tf_parity():
    """hemx's default optimizer: accumulator initialized to ones, eps 1e-10
    inside the square root, then the lr scale, then the momentum trace."""
    from hemx_torch.train.optimizers import init_optimizer
    net = _net()
    opt = init_optimizer(make_args(optimizer="rmsprop", lr=0.1), net)
    assert set(opt.state) == {"0", "1", "2"} and opt.state["1"] == {}
    assert all(torch.equal(v, torch.ones_like(v))
               for v in opt.state["0"]["nu"].values())
    p0 = {n: p.detach().clone() for n, p in net.named_parameters()}
    grads = [torch.full_like(p, 2.0) for p in net.parameters()]
    opt.step(grads)
    want = -0.1 * 2.0 / np.sqrt(0.9 + 0.1 * 4.0 + 1e-10)
    for n, p in net.named_parameters():
        np.testing.assert_allclose((p - p0[n]).detach().numpy(), want,
                                   rtol=1e-6)


@pytest.mark.parametrize("name", ["scale_by_rms", "scale_by_stddev"])
def test_rms_eps_sits_inside_the_sqrt(name):
    """Where eps sits shows only when the accumulator is tiny: gradients of
    1e-6 from a zero accumulator, against optax with eps_in_sqrt=True."""
    from hemx_torch.train import optimizers as T
    g = np.full((3,), 1e-6, np.float32)
    tx = getattr(optax, name)(decay=0.9, eps=1e-10, initial_scale=0.0,
                              eps_in_sqrt=True)
    want, _ = tx.update({"a": g}, tx.init({"a": g}))
    port = getattr(T, name)(0.9, 1e-10, 0.0)
    p = {"a": torch.zeros(3)}
    got, _ = port.update({"a": torch.from_numpy(g)}, port.init(p), p)
    np.testing.assert_allclose(got["a"].numpy(), np.asarray(want["a"]),
                               rtol=1e-6)


def test_clip_params_matches_hemx():
    from hemx.train.optimizers import clip_params as hemx_clip
    from hemx_torch.train.optimizers import clip_params
    rng = np.random.default_rng(1)
    arrays = [(0.05 * rng.standard_normal(s)).astype(np.float32)
              for s in ((3, 4), (7,))]
    want = jax.device_get(hemx_clip(arrays, 0.01))
    params = [torch.nn.Parameter(torch.from_numpy(a.copy())) for a in arrays]
    clip_params(params, 0.01)
    for p, w in zip(params, want):
        np.testing.assert_array_equal(p.detach().numpy(), w)
    assert max(p.abs().max().item() for p in params) == pytest.approx(0.01)


def test_grad_norm_matches_optax():
    from hemx_torch.models.common import grad_norm
    rng = np.random.default_rng(2)
    grads = [rng.standard_normal(s).astype(np.float32) for s in ((4, 5), (3,))]
    np.testing.assert_allclose(
        float(grad_norm([torch.from_numpy(g) for g in grads])),
        float(optax.global_norm(grads)), rtol=1e-6)


def test_unknown_optimizer_raises():
    from hemx_torch.train.optimizers import init_optimizer
    with pytest.raises(ValueError, match="unknown optimizer"):
        init_optimizer(make_args(optimizer="lion"), _net())
