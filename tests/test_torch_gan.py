"""The vanilla GAN and the WGAN of hemx_torch held against hemx's GanModel
and WganModel.

One train call from the same JAX-initialized weights, the same batches and
the same noise (drawn with hemx's own jax.random key chain and handed to
the port through the noise seam) gives the same losses, parameters, and G
and D BN moving stats: losses rtol 5e-4 / atol 1e-5, the rest rtol 2e-3 /
atol 2e-5 (sgd, as tests/test_torch_iwgan.py). The vanilla GAN is one
fused step on one batch and one z; the WGAN is n_disc_train critic steps
and one generator step, each clipping its network to +-0.01 after the
optimizer apply. Both critics have BN on c2/c3 and score real and fake
batches in two passes.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from tests.conftest import make_args  # noqa: E402
from tests.test_torch_iwgan import _assert_trees_close, _nchw  # noqa: E402

B, LATENT, N_D, HW = 4, 16, 2, 32


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


def _torch(tree: dict) -> dict:
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


def jax_train_noise(name, key, step, n_d, b, latent):
    """hemx's key chain for one train call (hemx/models/common.py:107-118,
    hemx/models/gan.py:182-183,229-231,289-291): every substep splits
    fold_in(base, step) into (sub, next base). The vanilla GAN draws z from
    sub; a WGAN critic substep splits sub into (rng, z key, alpha key) and
    leaves alpha unused, the generator substep into (rng, z key)."""
    base = jax.numpy.asarray(key)
    if name == "gan":
        sub, _ = jax.random.split(jax.random.fold_in(base, step))
        return [_torch({"z": jax.random.normal(sub, (b, latent))})]
    out = []
    for i in range(n_d + 1):
        sub, base = jax.random.split(jax.random.fold_in(base, step))
        zk = jax.random.split(sub, 3 if i < n_d else 2)[1]
        out.append(_torch({"z": jax.random.normal(zk, (b, latent))}))
    return out


def jax_eval_noise(key, step, b, latent):
    """hemx's eval z: normal(fold_in(key, step)) (gan.py:325-326)."""
    k = jax.random.fold_in(jax.numpy.asarray(key), step)
    return _torch({"z": jax.random.normal(k, (b, latent))})


@pytest.fixture(scope="module", params=["gan", "wgan"])
def run(request):
    """hemx's model of this regime: its start state, eval losses on the
    first batch, and the state and metrics after one train call (sgd)."""
    from hemx.models.plugin import get_model
    from hemx.parallel.dp import shard_batch
    from hemx.parallel.mesh import make_mesh
    name = request.param
    args = make_args(model=name, batch_size=B, latent_size=LATENT,
                     n_disc_train=N_D, optimizer="sgd", lr=1e-3,
                     synthetic_shape=[HW, HW, 3])
    mesh = make_mesh(1)
    rng = np.random.default_rng(5)
    model = get_model(name)(args, mesh)
    batches = [rng.random((B, HW, HW, 3), dtype=np.float32)
               for _ in range(model.batches_per_train_call())]
    ts = model.init_state(jax.random.PRNGKey(args.seed),
                          {"image": batches[0]})
    start = jax.device_get(ts)
    eval_batch = shard_batch({"image": batches[0]}, mesh)
    evals = {k: float(v) for k, v in
             jax.device_get(model.eval_losses(ts, eval_batch)).items()}
    stream = iter([shard_batch({"image": b}, mesh) for b in batches])
    new_ts, metrics = model.train(ts, stream)
    return dict(name=name, args=args, batches=batches, start=start,
                evals=evals, after=jax.device_get(new_ts),
                metrics={k: float(v) for k, v in
                         jax.device_get(metrics).items()})


def _port_state(run, **overrides):
    from hemx_torch import convert
    from hemx_torch.models.plugin import get_model
    args = make_args(**{**vars(run["args"]), **overrides})
    model = get_model(run["name"])(args, "cpu")
    ts = model.init_state((3, HW, HW), args.seed)
    convert.load_from_jax(ts.nets, run["start"]["params"],
                          run["start"]["mstate"])
    return model, ts


def _stream(run):
    return iter([{"image": _nchw(b)} for b in run["batches"]])


def test_train_call_matches_hemx(run):
    from hemx_torch import convert
    model, ts = _port_state(run)
    assert model.batches_per_train_call() == (1 if run["name"] == "gan"
                                              else N_D + 1)
    noise = jax_train_noise(run["name"], ts.rng, 0, N_D, B, LATENT)
    ts, metrics = model.train(ts, _stream(run), noise=noise)
    for k in ("g_loss", "d_loss"):
        np.testing.assert_allclose(float(metrics[k]), run["metrics"][k],
                                   rtol=5e-4, atol=1e-5, err_msg=k)
    assert ts.step == int(run["after"]["step"]) == 1
    params, mstate = convert.to_jax(ts.nets)
    _assert_trees_close(params, run["after"]["params"], rtol=2e-3, atol=2e-5)
    # G's stats from its forward; D's from its fake pass, which started
    # from the real pass's
    _assert_trees_close(mstate, run["after"]["mstate"], rtol=2e-3, atol=2e-5)
    assert set(convert.flatten_tree(mstate["discriminator"])) == {
        ("c2", "norm0", "mean"), ("c2", "norm0", "var"),
        ("c3", "norm0", "mean"), ("c3", "norm0", "var")}


def test_eval_losses_match_hemx(run):
    from hemx_torch import convert
    model, ts = _port_state(run)
    got = model.eval_losses(ts, {"image": _nchw(run["batches"][0])},
                            noise=jax_eval_noise(ts.rng, 0, B, LATENT))
    for k in ("g_loss", "d_loss"):
        np.testing.assert_allclose(float(got[k]), run["evals"][k],
                                   rtol=5e-4, atol=1e-5, err_msg=k)
    _, mstate = convert.to_jax(ts.nets)
    _assert_trees_close(mstate, run["start"]["mstate"], 0, 0)


def test_check_numerics_names_match_hemx(run):
    """--check_numerics reports every parameter of each network a call
    updates, under hemx's names (g/..., d/...)."""
    from hemx.models.common import grad_finite_report
    start = run["start"]["params"]
    want = set(grad_finite_report({"g": start["generator"],
                                   "d": start["discriminator"]}))
    model, ts = _port_state(run, check_numerics=True)
    noise = jax_train_noise(run["name"], ts.rng, 0, N_D, B, LATENT)
    _, metrics = model.train(ts, _stream(run), noise=noise)
    assert set(metrics["grad_finite"]) == want
    assert all(bool(v) for v in metrics["grad_finite"].values())


def test_convert_round_trip(run):
    """hemx pytrees -> torch modules -> hemx layout again, bit for bit,
    BN state of the critic included; fresh port weights have hemx's
    shapes."""
    from hemx_torch import convert
    from hemx_torch.models.plugin import get_model
    fresh = get_model(run["name"])(run["args"], "cpu").init_state(
        (3, HW, HW), 0)
    got_p, got_s = convert.to_jax(fresh.nets)
    for got, want in ((got_p, run["start"]["params"]),
                      (got_s, run["start"]["mstate"])):
        assert {k: v.shape for k, v in convert.flatten_tree(got).items()} \
            == {k: np.shape(v) for k, v in convert.flatten_tree(want).items()}
    _, ts = _port_state(run)
    got_p, got_s = convert.to_jax(ts.nets)
    _assert_trees_close(got_p, run["start"]["params"], 0, 0)
    _assert_trees_close(got_s, run["start"]["mstate"], 0, 0)


def test_train_without_noise_is_deterministic(run):
    """No noise passed: the port draws z from a generator seeded by the
    state's key and step, so two states seeded alike train identically."""
    results = []
    for _ in range(2):
        model, ts = _port_state(run)
        ts, metrics = model.train(ts, _stream(run))
        assert ts.step == 1
        assert all(np.isfinite(float(v)) for v in metrics.values())
        results.append((float(metrics["d_loss"]), float(metrics["g_loss"])))
    assert results[0] == results[1]
    with pytest.raises(ValueError, match="substeps"):
        model.train(ts, _stream(run), noise=[])


def test_wgan_clips_d_and_g_after_apply():
    """Every parameter of D and G (BN beta included) ends within +-0.01
    after a WGAN call (tests/test_models.py::test_wgan_clip); the BN moving
    stats are not parameters and are not clipped."""
    from hemx_torch.models.gan import WganModel
    args = make_args(model="wgan", batch_size=B, latent_size=LATENT,
                     n_disc_train=1, optimizer="sgd", lr=1e-2)
    model = WganModel(args, "cpu")
    ts = model.init_state((3, HW, HW), 0)
    assert max(p.abs().max().item() for p in ts.nets.parameters()) > 0.01
    rng = np.random.default_rng(1)
    stream = iter([{"image": _nchw(rng.random((B, HW, HW, 3),
                                              dtype=np.float32))}
                   for _ in range(2)])
    ts, _ = model.train(ts, stream)
    for net in ("generator", "discriminator"):
        for n, p in ts.nets[net].named_parameters():
            assert p.abs().max().item() <= 0.01, f"{net}/{n}"
    var = ts.nets["discriminator"].c2.norm0.var
    assert var.min().item() > 0.01
