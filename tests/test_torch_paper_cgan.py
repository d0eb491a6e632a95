"""paper_cgan of hemx_torch held against hemx's PaperCgan, and the shared
machinery of the depth-model tests (test_torch_paper_family.py and
test_torch_sampler_gan.py import it).

For each configuration hemx runs once, at 65x65 and full channel width,
batch 2 (4 where BN is in a net: BN at 1x1 over two rows cancels its
input gradient to rounding noise): init, eval losses, predict, the sampler
path, the summaries (with a mean image) and one train call, from one
seed. The port loads hemx's initial weights and takes the same batches and
the noise hemx's key chain draws (``Ctx.next_rng``, hemx/core.py:52-56;
``common.split_step_rng``), passed through the seam. Tolerances: losses
rtol 5e-4 / atol 1e-5; parameters, BN state, optimizer moments, gradient
norms and summary scalars rtol 2e-3 / atol 2e-5; G's outputs in predict
and sample rtol 2e-3 / atol 1e-4; under ``wgan`` every parameter
within +-0.01. Under Adam a bias that feeds BN (analytic gradient 0, so
its update is the sign of rounding noise times lr) is held to |change| <=
lr on both sides instead.

hemx's jitted steps are compiled at XLA backend optimization level 0: at
the default level XLA's CPU backend miscompiles the gradient of the BN
depth nets (ROADMAP section 3); level 0 agrees with eager JAX. The
checkpoints of one paper_cgan and one paper_standalone configuration cross
both ways: hemx's after-call state restores into the port bit for bit,
and the port's file restores through hemx's manager bit for bit (each
file ≈ 240 MB at full width, deleted once read).
"""

import contextlib
import functools
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from flax import serialization  # noqa: E402

from tests.conftest import make_args  # noqa: E402

HW = 65
LOSS_TOL = dict(rtol=5e-4, atol=1e-5)
TOL = dict(rtol=2e-3, atol=2e-5)
# G's outputs: sampler_gan's large BN generator runs 15 BN layers before
# its tanh, and at batch 8 its float32 output differs by up to 2.8e-5
PRED_TOL = dict(rtol=2e-3, atol=1e-4)
XLA_OPT0 = {"xla_backend_optimization_level": 0}


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


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Two intra-op threads for PyTorch while a depth-model file runs: the
    suite runs files in parallel workers, and these full-width convs would
    otherwise each take every core."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@contextlib.contextmanager
def xla_opt0():
    """Every ``jax.jit`` made inside compiles at backend level 0."""
    jit = jax.jit

    def patched(fun, **kw):
        return jit(fun, compiler_options=XLA_OPT0, **kw)
    jax.jit = patched
    try:
        yield
    finally:
        jax.jit = jit


def nchw(a):
    return torch.from_numpy(np.array(a, np.float32)).permute(0, 3, 1, 2)


def nhwc(t):
    return t.detach().permute(0, 2, 3, 1).float().numpy()


def flat(tree):
    from hemx_torch.convert import flatten_tree
    return {k: np.asarray(v) for k, v in flatten_tree(tree).items()}


def assert_trees_close(got, want, tol=TOL, skip=()):
    g, w = flat(got), flat(want)
    assert sorted(g) == sorted(w)
    for k in w:
        if k not in skip:
            np.testing.assert_allclose(g[k], w[k], err_msg="/".join(k), **tol)


def mean_image():
    return np.random.default_rng(11).uniform(0.1, 0.9, (29, 29)).astype(
        np.float32)


def scalars(logdir) -> dict:
    """{tag: last value} of the scalar summaries under ``logdir``."""
    from hemx.summaries.reader import get_all_events
    return {t: ev[-1][2] for t, ev in get_all_events(str(logdir)).items()}


def image_tags(logdir) -> set:
    from hemx.summaries.reader import event_files, iter_events
    return {v["tag"] for path in event_files(str(logdir))
            for ev in iter_events(path) for v in ev["values"]
            if "simple_value" not in v}


def hemx_reference(name, tmp, *, batch=2, conditional=True,
                   checkpoint=False, hw=HW, extra_keys=(), summary_hook=None,
                   summaries=True, inference=True, train=True, **overrides):
    """One run of hemx's model ``name``: start state, eval losses, predict,
    sample, summaries, and the state and metrics after one train call, all
    from batches drawn from one seed; with ``checkpoint``, hemx's
    checkpoint of the state after the call (≈ 240 MB at full width).
    ``hw``: the input size; ``extra_keys``: one-channel [0, 1) batch keys
    beside image and depth; ``summary_hook(model, ts)`` runs just before
    hemx writes its summaries, which ``summaries=False`` leaves out;
    ``inference=False`` leaves out eval, predict and sample,
    ``train=False`` the train call."""
    from hemx.models.plugin import get_model
    from hemx.parallel.dp import shard_batch
    from hemx.parallel.mesh import make_mesh
    from hemx.summaries.events import EventsWriter
    from hemx.train.checkpoint import CheckpointManager
    args = make_args(model=name, batch_size=batch, synthetic_shape=[hw, hw, 3],
                     **overrides)
    mesh = make_mesh(1)
    rng = np.random.default_rng(5)
    with xla_opt0():
        model = get_model(name)(args, mesh)
        n = model.batches_per_train_call() if conditional else 1
        batches = [{"image": rng.random((batch, hw, hw, 3), dtype=np.float32),
                    "depth": rng.random((batch, hw, hw, 1), dtype=np.float32),
                    **{k: rng.random((batch, hw, hw, 1), dtype=np.float32)
                       for k in extra_keys}}
                   for _ in range(n)]
        ts = model.init_state(jax.random.PRNGKey(args.seed), batches[0])
        out = {"args": args, "batches": batches, "n": n, "hw": hw,
               "start": jax.device_get(ts)}
        b0 = shard_batch(batches[0], mesh)
        if inference:
            out["evals"] = {k: float(v) for k, v in jax.device_get(
                model.eval_losses(ts, b0)).items()}
            g, prep = model._jit_predict(ts, b0)
            out["predict"] = (np.asarray(g), jax.device_get(prep))
        if inference and conditional:
            g_s, prep_s = model._jit_sample(ts, b0,
                                            jax.random.fold_in(ts["rng"], 0))
            out["sample"] = (np.asarray(g_s), jax.device_get(prep_s))
        if summaries:
            model.mean_image = mean_image()
            if summary_hook is not None:
                summary_hook(model, ts)
            w = EventsWriter(str(tmp / "hemx_events"))
            model.write_summaries(w, 0, ts, b0)
            w.close()
            out["scalars"] = scalars(tmp / "hemx_events")
            out["images"] = image_tags(tmp / "hemx_events")
        out["model"] = model
        if not train:
            return out
        new_ts, metrics = model.train(
            ts, iter([shard_batch(b, mesh) for b in batches]))
        out["metrics"] = {k: float(v) for k, v in
                          jax.device_get(metrics).items()}
        wrapper = {"train_state": new_ts, "epoch": np.int64(1)}
        if checkpoint:
            CheckpointManager(str(tmp / "hemx_ckpt")).save(wrapper, 1)
        out.update(after=jax.device_get(new_ts), ckpt_dir=tmp / "hemx_ckpt",
                   template=jax.device_get(wrapper))
    return out


def port_model(ref, **overrides):
    """The port's model of ``ref``'s configuration and a train state with
    hemx's initial weights (optimizer state fresh, as hemx's)."""
    from hemx_torch import convert
    from hemx_torch.models.plugin import get_model
    args = make_args(**{**vars(ref["args"]), **overrides})
    model = get_model(args.model)(args, "cpu")
    hw = ref.get("hw", HW)
    ts = model.init_state((3, hw, hw), args.seed)
    convert.load_from_jax(ts.nets, ref["start"]["params"],
                          ref["start"]["mstate"])
    return model, ts


def generator_of(ts):
    return ts.nets["generator"] if isinstance(ts.nets, torch.nn.ModuleDict) \
        else ts.nets


def g_noise(net, key, batch, hw=HW):
    """The draws hemx's generator takes from ``key`` through its Ctx (each
    ``next_rng`` draws from ``split(rng)[1]`` and keeps ``split(rng)[0]``,
    hemx/core.py:52-56), in the order ``net.noise_draws`` names them, NCHW;
    {} for a net without noise. hemx draws NHWC: the draws are transposed,
    not redrawn, and keep JAX's dtype."""
    draws = net.noise_draws(batch, hw, hw)
    got = _hemx_draws(tuple(draws.values()))(key)
    # float64 where JAX runs in float64 (the net tests)
    return {name: torch.from_numpy(np.array(a)).permute(0, 3, 1, 2)
            for name, a in zip(draws, got)}


@functools.lru_cache(maxsize=None)
def _hemx_draws(draws: tuple):
    """One jitted program drawing ``draws`` (NCHW :class:`Uniform` and
    :class:`Keep`) NHWC down hemx's Ctx chain; eager, every draw's shape
    compiles its own ops."""
    from hemx_torch.models.depth_nets import Keep

    def chain(key):
        out, rng = [], key
        for d in draws:
            rng, k = jax.random.split(rng)
            n, c, h, w = d.shape
            out.append(jax.random.bernoulli(k, d.p, (n, h, w, c))
                       if isinstance(d, Keep) else
                       jax.random.uniform(k, (n, h, w, c), minval=d.lo,
                                          maxval=d.hi))
        return out
    return jax.jit(chain, compiler_options=XLA_OPT0)


def train_noise(net, key, step, n, batch, hw=HW):
    """hemx's key chain for one train call: every substep splits
    ``fold_in(base, step)`` into (sub, next base); G draws from sub."""
    base = jax.numpy.asarray(key)
    out = []
    for _ in range(n):
        sub, base = jax.random.split(jax.random.fold_in(base, step))
        out.append(g_noise(net, sub, batch, hw))
    return out


def step_noise(net, key, step, batch, hw=HW):
    """eval / predict / sample / grad_report: ``fold_in(key, step)``."""
    return g_noise(net, jax.random.fold_in(jax.numpy.asarray(key), step),
                   batch, hw)


def substeps(model, ref) -> int:
    """Noise draws of one train call: one per substep (a conditional GAN
    may run several substeps on one batch), else one per batch."""
    return model.n_substeps() if hasattr(model, "n_substeps") else ref["n"]


def port_batch(b: dict) -> dict:
    return {k: nchw(v) for k, v in b.items()}


ADAM_EPS = 1e-8
# below this gradient magnitude (100 x Adam's eps) Adam's first step,
# lr * g / (|g| + eps), turns a rounding difference in g into one of up to
# lr in the update
ADAM_FLOOR = 1e-6


def _gan_opt_prefix(k: tuple) -> tuple:
    """Where a conditional GAN's Adam state keeps parameter ``k``'s
    moments: its network's optimizer, the chain's first transform."""
    return ({"generator": "g", "discriminator": "d"}[k[0]], "0"), k[1:]


def check_adam_first_step(ref, got_params, got_opt, want_opt, skip, *,
                          lr, b1, b2, opt_prefix=_gan_opt_prefix):
    """Parameters after an Adam model's first train call: where both
    sides' gradients (read from their first moments) are at least
    ``ADAM_FLOOR``, the port's values against hemx's at ``TOL``; where
    either is smaller, each side's update against optax's first Adam step
    of that side's own gradient and second moment, in float64, rtol 1e-5 /
    atol 1e-8 (a few float32 ulps of the parameters) -- the gradients
    themselves are held to each other through the moments at ``TOL``.
    ``opt_prefix(k)`` gives (the optimizer state's path before ``mu`` /
    ``nu``, the parameter's path after it). Returns the parameter paths
    checked."""
    start, want = flat(ref["start"]["params"]), flat(ref["after"]["params"])
    got = flat(got_params)
    done = set()
    for k in want:
        if k in skip:
            continue
        head, tail = opt_prefix(k)
        mu, nu = (head + (m,) + tail for m in ("mu", "nu"))
        floor = ADAM_FLOOR * (1 - b1)  # on the first moment, (1 - b1) g
        small = ((np.abs(want_opt[mu]) < floor)
                 | (np.abs(got_opt[mu]) < floor))
        np.testing.assert_allclose(got[k][~small], want[k][~small],
                                   err_msg="/".join(k), **TOL)
        for p, opt in ((got[k], got_opt), (want[k], want_opt)):
            m = opt[mu][small].astype(np.float64) / (1 - b1)
            v = opt[nu][small].astype(np.float64) / (1 - b2)
            np.testing.assert_allclose(
                p[small].astype(np.float64) - start[k][small],
                -lr * m / (np.sqrt(v) + ADAM_EPS), rtol=1e-5, atol=1e-8,
                err_msg="/".join(k))
        done.add(k)
    return done


def check_train_call(ref, *, adam_lr=None, clip=None, adam=None):
    """One port train call against hemx's: metrics, step, params, BN state
    and optimizer state. Returns the port's state after the call. With
    ``adam`` (lr, b1, b2) of a model whose optimizers are both that Adam,
    the parameters are held by :func:`check_adam_first_step`."""
    from hemx_torch import convert
    model, ts = port_model(ref)
    batch = ref["args"].batch_size
    noise = train_noise(generator_of(ts), ts.rng, 0, substeps(model, ref),
                        batch, ref.get("hw", HW))
    kw = {"noise": noise} if isinstance(ts.nets, torch.nn.ModuleDict) else {}
    ts, metrics = model.train(ts, iter(port_batch(b) for b in ref["batches"]),
                              **kw)
    want = ref["metrics"]
    assert set(metrics) == set(want)
    for k in want:
        # a gradient norm is a statistic of the gradient, which the
        # parameters' tolerance holds
        np.testing.assert_allclose(float(metrics[k]), want[k], err_msg=k,
                                   **(TOL if k.endswith("grad_norm")
                                      else LOSS_TOL))
    assert ts.step == int(ref["after"]["step"]) == 1
    params, mstate = convert.to_jax(ts.nets)
    skip = set()
    if adam_lr is not None:  # biases feeding BN: the sign of noise x lr
        start, after = flat(ref["start"]["params"]), flat(ref["after"]["params"])
        got = flat(params)
        for k in start:
            if k[-1].endswith("_b") and (k[:-1] + (k[-1][:-2] + "_bn", "beta")
                                         in start):
                skip.add(k)
                for p in (got[k], after[k]):
                    assert np.abs(p - start[k]).max() <= adam_lr * 1.001, k
    got_opt = flat(convert.train_state_to_jax(ts)["opt"])
    want_opt = flat(serialization.to_state_dict(ref["after"]["opt"]))
    assert sorted(got_opt) == sorted(want_opt)
    # the BN-fed biases' moments hold the same rounding noise: not compared
    skipped = {k[-1] for k in skip}
    if adam is not None:
        lr, b1, b2 = adam
        skip |= check_adam_first_step(ref, params, got_opt, want_opt, skip,
                                      lr=lr, b1=b1, b2=b2)
    assert_trees_close(params, ref["after"]["params"], skip=skip)
    assert_trees_close(mstate, ref["after"]["mstate"])
    for k in want_opt:
        if k[-1] in skipped:
            continue
        np.testing.assert_allclose(got_opt[k], want_opt[k],
                                   err_msg="/".join(k), **TOL)
    if clip is not None:
        for p in ts.nets.parameters():
            assert p.abs().max().item() <= clip + 1e-7
    return ts


def check_inference(ref, grad_report=False, capture=()):
    """eval_losses, predict and, for the GANs, sample (noise from hemx's
    step key) against hemx's; with ``grad_report``, its names against
    hemx's parameter paths (the base class's code, run for paper_cgan) and
    the names ``capture_activations`` gives against ``capture``."""
    model, ts = port_model(ref)
    gan = isinstance(ts.nets, torch.nn.ModuleDict)
    kw = ({"noise": step_noise(generator_of(ts), ts.rng, 0,
                               ref["args"].batch_size, ref.get("hw", HW))}
          if gan else {})
    b0 = port_batch(ref["batches"][0])
    evals = model.eval_losses(ts, b0, **kw)
    assert set(evals) == set(ref["evals"])
    for k, v in ref["evals"].items():
        np.testing.assert_allclose(float(evals[k]), v, err_msg=k, **LOSS_TOL)
    for name in ("predict", "sample") if gan else ("predict",):
        g, prep = getattr(model, name)(ts, b0, **kw)
        want_g, want_prep = ref[name]
        np.testing.assert_allclose(nhwc(g), want_g, err_msg=name, **PRED_TOL)
        for k, v in want_prep.items():
            np.testing.assert_allclose(nhwc(prep[k]), v, err_msg=k, **TOL)
    if gan and grad_report:  # hemx's names: each network's parameter paths
        stats = model.grad_report(ts, b0, **kw)
        assert set(stats) == {"/".join(k) for k in flat(ref["start"]["params"])}
        assert all(np.isfinite(float(v["mean"])) for v in stats.values())
        assert set(model.capture_activations(ts, b0)) == set(capture)
    elif not gan:
        assert model.grad_report(ts, b0) is None


def check_summaries(ref, tmp, **kw):
    """write_summaries' scalars (sampler variance, Eigen metrics vs y_hat,
    y_0, y_mean and the sampler) and image tags against hemx's; ``kw`` go
    to the port's write_summaries."""
    from hemx_torch.summaries.events import EventsWriter
    model, ts = port_model(ref)
    if isinstance(ts.nets, torch.nn.ModuleDict):
        # the step key's noise for predict and sample, as hemx's
        noise = step_noise(generator_of(ts), ts.rng, 0,
                           ref["args"].batch_size, ref.get("hw", HW))
        model._noise = lambda ts, stream, prep, given: noise
    model.mean_image = mean_image()
    w = EventsWriter(str(tmp / "port_events"))
    model.write_summaries(w, 0, ts, port_batch(ref["batches"][0]), **kw)
    w.close()
    got = scalars(tmp / "port_events")
    assert set(got) == set(ref["scalars"])
    for k, v in ref["scalars"].items():
        np.testing.assert_allclose(got[k], v, err_msg=k, **TOL)
    assert image_tags(tmp / "port_events") == ref["images"]
    return got


def check_checkpoints_cross(ref, ts_after, tmp):
    """hemx's checkpoint after the call restores into the port bit for bit;
    the port's file of that state restores through hemx's manager bit for
    bit, with hemx's template's leaves exactly."""
    from hemx.train.checkpoint import CheckpointManager as HemxManager
    from hemx_torch import convert
    from hemx_torch.train.checkpoint import CheckpointManager
    model, ts = port_model(ref)
    tree = CheckpointManager(str(ref["ckpt_dir"])).restore()
    assert convert.load_checkpoint(ts, tree) == 1
    got = flat(convert.to_checkpoint(ts, 1))
    want = flat(tree)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k],
                                                                want[k]), k
    path = CheckpointManager(str(tmp / "port_ckpt")).save(
        convert.to_checkpoint(ts_after, 1), 1)
    with open(path, "rb") as f:
        raw = serialization.msgpack_restore(f.read())
    # flax's restore ignores extra keys: hold the raw tree to the template's
    assert sorted(flat(raw)) == sorted(flat(serialization.to_state_dict(
        ref["template"])))
    restored = HemxManager(str(tmp / "port_ckpt")).restore(ref["template"])
    back = flat(serialization.to_state_dict(restored))
    mine = flat(convert.to_checkpoint(ts_after, 1))
    assert sorted(back) == sorted(mine)
    for k in mine:
        assert np.array_equal(back[k], mine[k]), k
    for d in (ref["ckpt_dir"], tmp / "port_ckpt"):  # free the disk now
        shutil.rmtree(d)


# mean_provided's graph is paper_baseline_sampler's mean_provided, held in
# tests/test_torch_paper_family.py (the same class but for its Adam betas)
CGAN = {"baseline_gan": dict(model_version="baseline", training_version="gan"),
        "mean_adjusted_wgan": dict(model_version="mean_adjusted",
                                   training_version="wgan"),
        "mean_provided2_gan": dict(model_version="mean_provided2",
                                   training_version="gan")}
ADAM = dict(g_lr=1e-4, d_lr=1e-4, g_beta1=0.5, d_beta1=0.5, g_beta2=0.999,
            d_beta2=0.999)


# the configuration whose checkpoints cross both ways: optax's rmsprop (G)
# and adam (D) states, the "_" scalars
CROSS = "mean_adjusted_wgan"


@pytest.fixture(scope="module", params=sorted(CGAN))
def ref(request, tmp_path_factory):
    return hemx_reference("paper_cgan", tmp_path_factory.mktemp("cgan"),
                          checkpoint=request.param == CROSS,
                          **CGAN[request.param], **ADAM)


def test_train_call_matches_hemx(ref, tmp_path):
    wgan = ref["args"].training_version == "wgan"
    assert ref["n"] == (6 if wgan else 2)
    ts = check_train_call(ref, clip=0.01 if wgan else None)
    if ref["ckpt_dir"].exists():
        check_checkpoints_cross(ref, ts, tmp_path)


def test_inference_matches_hemx(ref):
    check_inference(ref, grad_report=True)


def test_summaries_match_hemx(ref, tmp_path):
    got = check_summaries(ref, tmp_path)
    for prefix in ("metrics_y_hat/", "metrics_y_0/", "metrics_y_mean/"):
        assert any(k.startswith(prefix) for k in got), prefix


def test_eigen_metrics_for_matches_hemx(ref):
    from hemx.parallel.dp import shard_batch
    from hemx.parallel.mesh import make_mesh
    model, ts = port_model(ref)
    got = model.eigen_metrics_for(ts, port_batch(ref["batches"][0]))
    with xla_opt0():
        h = ref["model"]
        hts = jax.tree_util.tree_map(jax.numpy.asarray, ref["start"])
        want = h.eigen_metrics_for(hts, shard_batch(ref["batches"][0],
                                                    make_mesh(1)))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **TOL)


def test_check_numerics_names_match_hemx(ref):
    from hemx.models.common import grad_finite_report
    start = ref["start"]["params"]
    want = set(grad_finite_report({"g": start["generator"],
                                   "d": start["discriminator"]}))
    model, ts = port_model(ref, check_numerics=True)
    noise = train_noise(generator_of(ts), ts.rng, 0, substeps(model, ref),
                        ref["args"].batch_size, ref.get("hw", HW))
    _, metrics = model.train(ts, iter(port_batch(b) for b in ref["batches"]),
                             noise=noise)
    assert set(metrics["grad_finite"]) == want
