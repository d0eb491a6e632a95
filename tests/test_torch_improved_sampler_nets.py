"""The spec-built nets of hemx_torch.models.improved_sampler held against
hemx.models.improved_sampler's spec_generator / spec_discriminator.

* Every generator spec (A1, A2, A3, B1, B2, C1, D1, E1) and each distinct
  discriminator spec (A1, B1, B2) on a NARROWED spec dict: every channel
  count divided by 16, with the spec's filters, paddings, BN flags and
  input sizes (65, 66 or 64 px) unchanged, so each stage's padding,
  deconv output size (the bias-only rows of A*'s 5 -> 14 and B1/C1's
  6 -> 14 and 14 -> 31) and concat order is exercised at a fraction of the
  cost; both packages build a net from any spec dict. Output, new BN stats and
  the gradients of sum(y * ct) with respect to the inputs and every
  parameter agree within 1e-10 of each array's largest magnitude
  (float64 on both sides, ``tests/test_torch_depth_nets.py`` says why;
  hemx jitted at XLA backend level 0, which agrees with eager JAX where
  the default level does not), the biases feeding BN held near 0 on both
  sides instead.
* At the published widths the port's nets have hemx's parameter and state
  trees, leaf by leaf in shape, for every generator and discriminator
  spec.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from hemx.models import improved_sampler as HI  # noqa: E402
from hemx_torch import convert  # noqa: E402
from hemx_torch.models import improved_sampler as TI  # noqa: E402
from tests.test_torch_depth_nets import (  # noqa: E402,F401
    _compare, _hemx_float32, _nchw, _x64)
from tests.test_torch_paper_cgan import (  # noqa: E402,F401
    XLA_OPT0, _two_torch_threads)

B = 2
TOL = 1e-10
SIZE = {"A1": 65, "A2": 65, "A3": 65, "B1": 66, "C1": 66, "B2": 64,
        "D1": 64, "E1": 64}
# the depth input of each distinct critic spec: its generator's output
DEPTH = {"A1": 31, "B1": 31, "B2": 32}
# rgb channels: the image plus the extras of a generator that uses the spec
RGB_C = {"A1": 3, "B1": 5, "B2": 6}


def narrow_gen(spec):
    return dict(enc=[(k, ch // 16, pad, bn) for k, ch, pad, bn in spec["enc"]],
                dec=[(k, ch // 16, bn) for k, ch, bn in spec["dec"]],
                final_bn=spec["final_bn"])


def narrow_disc(spec):
    return dict(rgb=[(k, ch // 16, pad) for k, ch, pad in spec["rgb"]],
                depth=[(k, ch // 16, pad) for k, ch, pad in spec["depth"]],
                combined=[max(ch // 16, 1) for ch in spec["combined"]])


def test_spec_tables_are_hemx_tables():
    assert TI.GEN_SPECS == HI.GEN_SPECS
    assert TI.DISC_SPECS == HI.DISC_SPECS
    assert TI.CROPS == HI.CROPS and TI.EXTRAS == HI.EXTRAS
    assert TI.ImprovedSampler.arguments() == HI.ImprovedSampler.arguments()


@pytest.mark.parametrize("arch", sorted(TI.GEN_SPECS))
def test_spec_generator_matches_hemx(arch):
    spec = narrow_gen(HI.GEN_SPECS[arch])
    hw, c = SIZE[arch], 3 + len(HI.EXTRAS.get(arch, ()))
    x = np.random.default_rng(0).random((B, hw, hw, c), dtype=np.float32)
    layer = HI.spec_generator(spec)
    params, state, out_shape = layer.init(jax.random.PRNGKey(1), x.shape)
    net = TI.SpecGenerator(spec, (c, hw, hw),
                           generator=torch.Generator().manual_seed(0))
    ctx_rng = jax.random.PRNGKey(7)
    z = jax.random.uniform(jax.random.split(ctx_rng)[1], (B, hw, hw, 1),
                           minval=-1.0, maxval=1.0)
    out = (B,) + tuple(out_shape[1:])
    _compare(layer, params, state, (jnp.asarray(x, jnp.float64),), ctx_rng,
             net, [_nchw(x)], {"kw": {"noise": _nchw(np.asarray(z))}}, out,
             tol=TOL, compiler_options=XLA_OPT0)


@pytest.mark.parametrize("arch", sorted(DEPTH))
def test_spec_discriminator_matches_hemx(arch):
    spec = narrow_disc(HI.DISC_SPECS[arch])
    hw, c, dh = SIZE[arch], RGB_C[arch], DEPTH[arch]
    rng = np.random.default_rng(1)
    x = rng.random((B, hw, hw, c), dtype=np.float32)
    d = rng.random((B, dh, dh, 1), dtype=np.float32)
    layer = HI.spec_discriminator(spec)
    params, state, out_shape = layer.init(jax.random.PRNGKey(2), x.shape)
    net = TI.SpecDiscriminator(spec, (c, hw, hw),
                               generator=torch.Generator().manual_seed(0))
    _compare(layer, params, state,
             (jnp.asarray(x, jnp.float64), jnp.asarray(d, jnp.float64)),
             jax.random.PRNGKey(0), net, [_nchw(x), _nchw(d)], {"pair": True},
             (B, 1, 1, 1), tol=TOL, compiler_options=XLA_OPT0)


def _shapes(tree):
    return {k: tuple(v.shape) for k, v in convert.flatten_tree(tree).items()}


def test_full_width_trees_match_hemx():
    """Every spec at its published widths: the port's parameter and state
    trees (flat names, BN subtrees, the '_' scalar, kernel layouts) equal
    hemx's in keys and leaf shapes."""
    g = torch.Generator().manual_seed(0)
    pairs = []
    for arch, spec in HI.GEN_SPECS.items():
        c = 3 + len(HI.EXTRAS.get(arch, ()))
        shape = (1, SIZE[arch], SIZE[arch], c)
        pairs.append((HI.spec_generator(spec), shape,
                      TI.SpecGenerator(spec, (c, shape[1], shape[2]),
                                       generator=g)))
    for arch in DEPTH:
        spec, c = HI.DISC_SPECS[arch], RGB_C[arch]
        shape = (1, SIZE[arch], SIZE[arch], c)
        pairs.append((HI.spec_discriminator(spec), shape,
                      TI.SpecDiscriminator(spec, (c, shape[1], shape[2]),
                                           generator=g)))
    for layer, shape, net in pairs:
        params, state = jax.eval_shape(
            lambda k: layer.init(k, shape)[:2], jax.random.PRNGKey(0))
        got_p, got_s = convert.to_jax(net)
        assert _shapes(got_p) == _shapes(params)
        assert _shapes(got_s) == _shapes(state)
