"""The IWGAN slice of hemx_torch held against hemx's IwganModel.

One full train call (n_disc_train critic steps + one generator step) from
the same JAX-initialized weights, the same batches and the same noise
(drawn with hemx's own jax.random key chain and handed to the port through
the noise seam) must give the same losses, parameters and generator BN
moving stats. Tolerances are those of
tests/test_models.py::TestDataParallel::test_dp_iwgan_matches_single_device
(losses rtol 5e-4 / atol 1e-5; params rtol 2e-3 / atol 2e-5), for the same
reason: sgd makes the parameter delta exactly lr * grad, so reduction-order
noise between two float32 implementations stays at that size.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import optax  # noqa: E402

from tests.conftest import make_args  # noqa: E402

B, LATENT, N_D, HW = 4, 16, 2, 32


@pytest.fixture(autouse=True, scope="module")
def _hemx_float32():
    """hemx's compute dtype and precision are process-wide, and bench.main()
    in an earlier test of this worker may have left them at bfloat16:
    compare against, and leave behind, hemx's float32 defaults."""
    from hemx.ops import layers
    layers.set_compute_dtype(None)
    layers.set_default_precision("default")


def _flat(tree):
    from hemx_torch.convert import flatten_tree
    return {k: np.asarray(v) for k, v in flatten_tree(tree).items()}


def _assert_trees_close(got, want, rtol, atol):
    g, w = _flat(got), _flat(want)
    assert sorted(g) == sorted(w)
    for k in w:
        np.testing.assert_allclose(g[k], w[k], rtol=rtol, atol=atol,
                                   err_msg="/".join(k))


def _jax_noise(seed, step, n_d, b, latent):
    """hemx's key chain for one train call (hemx/models/common.py:107-118,
    hemx/models/gan.py:229-231,254,289-291): every substep splits
    fold_in(base, step) into (sub, next base); a critic substep splits sub
    into (rng, z key, alpha key), the generator substep into (rng, z key)."""
    base = jax.random.PRNGKey(seed)
    out = []
    for i in range(n_d + 1):
        sub, base = jax.random.split(jax.random.fold_in(base, step))
        if i < n_d:
            _, zk, ak = jax.random.split(sub, 3)
            out.append({"z": jax.random.normal(zk, (b, latent)),
                        "alpha": jax.random.uniform(ak, (b, 1))})
        else:
            _, zk = jax.random.split(sub)
            out.append({"z": jax.random.normal(zk, (b, latent))})
    return [{k: torch.from_numpy(np.array(v)) for k, v in d.items()}
            for d in out]


def _nchw(x):
    return torch.from_numpy(x).permute(0, 3, 1, 2)


@pytest.fixture(scope="module")
def setup():
    from hemx.models.plugin import get_model
    from hemx.parallel.mesh import make_mesh
    args = make_args(model="iwgan", batch_size=B, latent_size=LATENT,
                     n_disc_train=N_D, optimizer="sgd", lr=1e-3,
                     synthetic_shape=[HW, HW, 3])
    mesh = make_mesh(1)
    rng = np.random.default_rng(7)
    batches = [rng.random((B, HW, HW, 3), dtype=np.float32)
               for _ in range(N_D + 1)]
    model = get_model("iwgan")(args, mesh)
    ts = model.init_state(jax.random.PRNGKey(0), {"image": batches[0]})
    params0 = jax.device_get(ts["params"])
    mstate0 = jax.device_get(ts["mstate"])
    return args, mesh, model, ts, params0, mstate0, batches


@pytest.fixture(scope="module")
def hemx_result(setup):
    from hemx.parallel.dp import shard_batch
    args, mesh, model, ts, _, _, batches = setup
    stream = iter([shard_batch({"image": b}, mesh) for b in batches])
    new_ts, metrics = model.train(ts, stream)
    return jax.device_get(new_ts), {k: float(v) for k, v in
                                    jax.device_get(metrics).items()}


def _port_state(setup):
    from hemx_torch import convert
    from hemx_torch.models.gan import IwganModel
    args, _, _, _, params0, mstate0, _ = setup
    model = IwganModel(args, "cpu")
    ts = model.init_state((3, HW, HW), args.seed)
    convert.load_from_jax(ts.nets, params0, mstate0)
    return model, ts


def test_train_call_matches_hemx(setup, hemx_result):
    from hemx_torch import convert
    args, _, _, _, _, _, batches = setup
    want_ts, want_m = hemx_result
    model, ts = _port_state(setup)
    noise = _jax_noise(args.seed, 0, N_D, B, LATENT)
    stream = iter([{"image": _nchw(b)} for b in batches])
    ts, metrics = model.train(ts, stream, noise=noise)
    for k in ("g_loss", "d_loss"):
        np.testing.assert_allclose(float(metrics[k]), want_m[k],
                                   rtol=5e-4, atol=1e-5, err_msg=k)
    assert ts.step == int(want_ts["step"]) == 1
    params, mstate = convert.to_jax(ts.nets)
    _assert_trees_close(params, want_ts["params"], rtol=2e-3, atol=2e-5)
    _assert_trees_close(mstate["generator"], want_ts["mstate"]["generator"],
                        rtol=2e-3, atol=2e-5)


def test_convert_round_trip(setup):
    """hemx pytrees -> torch modules -> hemx layout again, bit for bit, for
    the whole IWGAN (params and BN state); torch init shapes match hemx's."""
    from hemx_torch import convert
    from hemx_torch.models.gan import IwganModel
    args, _, _, _, params0, mstate0, _ = setup
    fresh = IwganModel(args, "cpu").init_state((3, HW, HW), 0)
    want_shapes = {k: np.shape(v)
                   for k, v in convert.flatten_tree(params0).items()}
    got_p, _ = convert.to_jax(fresh.nets)
    assert {k: v.shape for k, v in convert.flatten_tree(got_p).items()} \
        == want_shapes
    _, ts = _port_state(setup)
    got_p, got_s = convert.to_jax(ts.nets)
    _assert_trees_close(got_p, params0, 0, 0)
    _assert_trees_close(got_s, mstate0, 0, 0)


def test_critic_step_leaves_generator_untouched(setup):
    """The critic step runs G in training mode but must not write G's BN
    buffers or parameters (hemx/models/gan.py:236)."""
    from hemx_torch import convert
    args, _, _, _, params0, mstate0, batches = setup
    model, ts = _port_state(setup)
    noise = _jax_noise(args.seed, 0, N_D, B, LATENT)[0]
    model.d_step(ts, {"image": _nchw(batches[0])}, noise)
    params, mstate = convert.to_jax(ts.nets)
    _assert_trees_close(params["generator"], params0["generator"], 0, 0)
    _assert_trees_close(mstate["generator"], mstate0["generator"], 0, 0)
    assert ts.step == 0
    assert all(p.grad is None for p in ts.nets.parameters())


def test_train_without_noise_draws_from_state_generator(setup):
    """No noise passed: the port draws z and alpha from a generator seeded
    by the state's key and step, so two states seeded alike train
    identically, the step advances, and the key is kept."""
    args, _, _, _, _, _, batches = setup
    results = []
    for _ in range(2):
        model, ts = _port_state(setup)
        np.testing.assert_array_equal(ts.rng,
                                      np.asarray(jax.random.PRNGKey(args.seed)))
        stream = iter([{"image": _nchw(b)} for b in batches])
        ts, metrics = model.train(ts, stream)
        assert ts.step == 1
        assert all(np.isfinite(float(v)) for v in metrics.values())
        np.testing.assert_array_equal(ts.rng,
                                      np.asarray(jax.random.PRNGKey(args.seed)))
        results.append(float(metrics["d_loss"]))
    assert results[0] == results[1]


def test_call_noise_is_a_function_of_key_and_step():
    """Each call's generator is seeded from (key words, step, stream): the
    same inputs draw the same noise, another step, key or stream other
    noise."""
    from hemx_torch.models import common
    ts = common.TrainState(nets=None, opt={}, step=3,
                           rng=common.prng_key(9))

    def z(state, stream=common.TRAIN):
        gen = common.generator(state, stream, "cpu")
        return common.draw_noise(gen, 2, 4, alpha=False)["z"]
    first = z(ts)
    assert torch.equal(first, z(ts))
    for other in (common.TrainState(None, {}, 4, ts.rng),
                  common.TrainState(None, {}, 3, common.prng_key(10))):
        assert not torch.equal(first, z(other))
    assert not torch.equal(first, z(ts, common.EVAL))


def test_critic_flags_are_anded_across_substeps():
    from hemx_torch.models.common import and_flags
    t, f = torch.tensor(True), torch.tensor(False)
    flags = and_flags({}, {"d/c1/w": f, "d/c1/b": t})
    flags = and_flags(flags, {"d/c1/w": t, "d/c1/b": t})
    flags = and_flags(flags, {"g/fc1/w": t})
    assert {k: bool(v) for k, v in flags.items()} == {
        "d/c1/w": False, "d/c1/b": True, "g/fc1/w": True}


def test_adam_apply_matches_optax(setup):
    """One Adam apply on a fixed gradient tree equals
    optax.adam(1e-4, 0.5, 0.9): parameters rtol 1e-6 (atol 1e-9 for entries
    within ~1e-3 of zero), moments rtol 1e-6."""
    from hemx_torch import convert
    from hemx_torch.train.optimizers import init_optimizer
    args, _, _, _, params0, mstate0, _ = setup
    _, ts = _port_state(setup)
    net = ts.nets["discriminator"]
    p0 = params0["discriminator"]
    rng = np.random.default_rng(3)
    grads = jax.tree_util.tree_map(
        lambda p: rng.standard_normal(np.shape(p)).astype(np.float32), p0)

    tx = optax.adam(1e-4, b1=0.5, b2=0.9)
    state = tx.init(p0)
    updates, state = tx.update(grads, state, p0)
    want = optax.apply_updates(p0, updates)

    adam_args = make_args(optimizer="adam", lr=1e-4, beta1=0.5, beta2=0.9)
    opt = init_optimizer(adam_args, net)
    sd = convert.state_dict_from_jax(net, grads, {})
    opt.step([sd[name].contiguous() for name, _ in net.named_parameters()])
    got, _ = convert.to_jax(net)
    _assert_trees_close(got, jax.device_get(want), rtol=1e-6, atol=1e-9)
    moments = convert.opt_state_to_jax(opt)["0"]
    assert int(moments["count"]) == int(state[0].count) == 1
    _assert_trees_close(moments["mu"], jax.device_get(state[0].mu),
                        rtol=1e-6, atol=0)
    _assert_trees_close(moments["nu"], jax.device_get(state[0].nu),
                        rtol=1e-6, atol=0)


def test_unported_options_raise(setup, tmp_path):
    """A split that is not kept on the device streams through the host
    Pipeline (celeb and coco, once refused here, are ported:
    tests/test_torch_celeb_coco.py)."""
    from hemx_torch import cli
    from hemx_torch.data.pipeline import Pipeline
    argv = ["--model", "iwgan", "--synthetic_u8",
            "--synthetic_count", "8", "--synthetic_shape", "16", "16", "3",
            "--batch_size", "4", "--latent_size", "8", "--n_disc_train", "1",
            "--epochs", "1", "--device", "cpu"]
    for i, flags in enumerate((["--no-device_data_cache"],
                               ["--device_cache_mb", "0"])):
        res = cli.run(argv + ["--dataset", "synthetic", "--dir",
                              str(tmp_path / str(i))] + flags)
        assert isinstance(res["pipeline"], Pipeline)
        assert res["train_state"].step == 2
