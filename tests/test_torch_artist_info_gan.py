"""artist and info_gan of hemx_torch held against hemx's ArtistModel and
InfoGan.

hemx runs each model once -- artist at 65x65, info_gan at 32x32, full
channel widths, batch 4, Adam(1e-4, 0.5, 0.999), jitted at XLA backend
level 0 -- and records the state after each of its
jitted substeps (artist: the y step then the x step; info_gan: D, G, Q),
each on its own batch. The port:

* runs each substep from hemx's state before it (loaded through the
  checkpoint seam) on the same batch and, for info_gan, the z hemx draws
  from the substep's key itself (``uniform(split(fold_in(rng, step))[0])``,
  not a ``Ctx`` split): the substep's metrics, the parameters of its
  optimizer, every BN moving stat (artist's x step moves the encoder's
  stats, not its weights) and the optimizer state agree with hemx's
  after it, and every other parameter and optimizer is left bit for bit;
  ``step`` goes up on artist's x step and info_gan's Q step only. A
  parameter whose gradient is below 1e-6 on either side is held to
  optax's first step of each side's own gradient
  (``check_adam_first_step``), a bias feeding BN to |change| <= lr;
* runs one whole call through ``train`` from hemx's start (metrics,
  ``step``), and ``eval_losses`` (artist: ``predict`` too; info_gan: z
  from hemx's step key);
* crosses checkpoints both ways (artist's two optimizer trees, the y
  one over the encoder and the y decoder; info_gan's three, Q's over the
  predictor and the generator).

Tolerances as ``tests/test_torch_paper_cgan.py``'s.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from flax import serialization  # noqa: E402

from tests.conftest import make_args  # noqa: E402
from tests.test_torch_paper_cgan import (  # noqa: E402,F401
    LOSS_TOL, PRED_TOL, TOL, _hemx_float32, _two_torch_threads,
    check_adam_first_step, check_checkpoints_cross, flat, image_tags, nchw,
    nhwc, port_batch, port_model, xla_opt0)

BATCH = 4
SIZE = {"artist": 65, "info_gan": 32}
STEPS = {"artist": ("y", "x"), "info_gan": ("d", "g", "q")}
# the optimizer of each substep, and the networks it updates
MOVES = {"y": ("encoder", "y_decoder"), "x": ("x_decoder",),
         "d": ("discriminator",), "g": ("generator",),
         "q": ("predictor", "generator")}
ADAM = dict(optimizer="adam", lr=1e-4, beta1=0.5, beta2=0.999)


def hemx_run(name, tmp):
    """hemx's start state, eval losses (and artist's predict and
    summaries), then one call substep by substep: the state and metrics
    after each, and the checkpoint of the final state."""
    from hemx.models.plugin import get_model
    from hemx.parallel.dp import shard_batch
    from hemx.parallel.mesh import make_mesh
    from hemx.summaries.events import EventsWriter
    from hemx.train.checkpoint import CheckpointManager
    hw = SIZE[name]
    args = make_args(model=name, batch_size=BATCH, synthetic_shape=[hw, hw, 3],
                     **ADAM)
    mesh = make_mesh(1)
    rng = np.random.default_rng(5)
    with xla_opt0():
        model = get_model(name)(args, mesh)
        n = model.batches_per_train_call()
        batches = [{"image": rng.random((BATCH, hw, hw, 3), dtype=np.float32),
                    "depth": rng.random((BATCH, hw, hw, 1), dtype=np.float32)}
                   for _ in range(n)]
        # one jitted program: eager, each initializer compiles its own ops
        # (several times slower); the port loads whatever weights it gives
        ts = jax.jit(lambda key: model.init_state(key, batches[0]))(
            jax.random.PRNGKey(args.seed))
        out = {"args": args, "batches": batches, "n": n, "hw": hw,
               "start": jax.device_get(ts), "states": [], "metrics": {},
               "ckpt_dir": tmp / "hemx_ckpt"}
        b0 = shard_batch(batches[0], mesh)
        out["evals"] = {k: float(v) for k, v in
                        jax.device_get(model.eval_losses(ts, b0)).items()}
        if name == "artist":
            out["predict"] = [np.asarray(a) for a in model._jit_predict(ts, b0)]
            w = EventsWriter(str(tmp / "hemx_events"))
            model.write_summaries(w, 0, ts, b0)
            w.close()
            out["images"] = image_tags(tmp / "hemx_events")
        for step, b in zip(STEPS[name], batches):
            ts, m = getattr(model, f"_jit_{step}")(ts, shard_batch(b, mesh))
            out["states"].append(jax.device_get(ts))
            out["metrics"].update({k: float(v) for k, v in
                                   jax.device_get(m).items()})
        wrapper = {"train_state": ts, "epoch": np.int64(1)}
        CheckpointManager(str(out["ckpt_dir"])).save(wrapper, 1)
        out.update(after=out["states"][-1], template=jax.device_get(wrapper))
    return out


# Adam only: the substeps hold each of a model's optimizers against
# hemx's, and a second optimizer would compile hemx's steps again
@pytest.fixture(scope="module", params=sorted(STEPS),
                ids=[f"{m}-adam" for m in sorted(STEPS)])
def ref(request, tmp_path_factory):
    return hemx_run(request.param, tmp_path_factory.mktemp(request.param))


def _z(key, step, hw):
    """info_gan's z: uniform [0, 1) from the substep key itself, NCHW."""
    sub, _ = jax.random.split(jax.random.fold_in(jax.numpy.asarray(key), step))
    return nchw(jax.random.uniform(sub, (BATCH, hw, hw, 1)))


def _ckpt(state):
    return serialization.to_state_dict({"train_state": state,
                                        "epoch": np.int64(0)})


def _opt_prefix(opt_name):
    def prefix(k):  # g and d keep their network's own tree, x, y, q a dict
        return (opt_name, "0"), (k[1:] if opt_name in ("g", "d") else k)
    return prefix


def _bn_fed_biases(params: dict) -> set:
    return {k for k in params if k[-1].endswith("_b")
            and k[:-1] + (k[-1][:-2] + "_bn", "beta") in params}


def test_substeps_match_hemx(ref):
    from hemx_torch import convert
    name, a = ref["args"].model, ref["args"]
    model, ts = port_model(ref)
    before = ref["start"]
    for i, (step, b) in enumerate(zip(STEPS[name], ref["batches"])):
        after = ref["states"][i]
        convert.load_checkpoint(ts, _ckpt(before))
        old = {k: v.copy() for k, v in flat(convert.train_state_to_jax(ts)
                                            ["params"]).items()}
        old_opt = flat(convert.train_state_to_jax(ts)["opt"])
        batch = port_batch(b)
        if name == "info_gan":
            m = getattr(model, f"{step}_step")(
                ts, batch, _z(before["rng"], int(before["step"]), ref["hw"]))
        else:
            m = getattr(model, f"{step}_step")(ts, batch)
        for k, v in m.items():
            np.testing.assert_allclose(float(v), ref["metrics"][k], err_msg=k,
                                       **LOSS_TOL)
        got = convert.train_state_to_jax(ts)
        assert got["step"] == int(after["step"]) == int(before["step"]) + (
            step in ("x", "q"))
        params, want = flat(got["params"]), flat(after["params"])
        moved = {k for k in params if k[0] in MOVES[step]}
        for k in set(params) - moved:  # left bit for bit, on both sides
            assert np.array_equal(params[k], old[k]), k
            assert np.array_equal(want[k], old[k]), k
        got_opt = flat(got["opt"])
        want_opt = flat(serialization.to_state_dict(after["opt"]))
        assert sorted(got_opt) == sorted(want_opt)
        for k in want_opt:
            if k[0] == step:
                if k[-1] not in {b[-1] for b in _bn_fed_biases(params)}:
                    np.testing.assert_allclose(got_opt[k], want_opt[k],
                                               err_msg="/".join(k), **TOL)
            else:
                assert np.array_equal(got_opt[k], old_opt[k]), k
        skip = set(params) - moved
        for k in _bn_fed_biases(params) & moved:
            skip.add(k)
            for p in (params[k], want[k]):
                assert np.abs(p - old[k]).max() <= a.lr * 1.001, k
        skip |= check_adam_first_step(
            {"start": before, "after": after}, got["params"], got_opt,
            want_opt, skip, lr=a.lr, b1=a.beta1, b2=a.beta2,
            opt_prefix=_opt_prefix(step))
        for k in moved - skip:
            np.testing.assert_allclose(params[k], want[k], err_msg="/".join(k),
                                       **TOL)
        mstate, want_ms = flat(got["mstate"]), flat(after["mstate"])
        assert sorted(mstate) == sorted(want_ms)
        for k in want_ms:
            np.testing.assert_allclose(mstate[k], want_ms[k],
                                       err_msg="/".join(k), **TOL)
        if name == "artist" and step == "x":  # the encoder's stats moved
            assert any(not np.array_equal(want_ms[k], flat(
                before["mstate"])[k]) for k in want_ms if k[0] == "encoder"
                and k[-1] == "mean")
        before = after


def test_train_call_matches_hemx(ref, tmp_path):
    """``train`` over the call's batches: hemx's metrics and ``step`` 1;
    the checkpoints of hemx's state after the call cross both ways."""
    from hemx_torch import convert
    model, ts = port_model(ref)
    kw = {}
    if ref["args"].model == "info_gan":
        base = jax.numpy.asarray(ts.rng)
        noise = []
        for _ in range(3):
            sub, base = jax.random.split(jax.random.fold_in(base, 0))
            noise.append({"z": nchw(jax.random.uniform(
                sub, (BATCH, ref["hw"], ref["hw"], 1)))})
        kw["noise"] = noise
    ts, metrics = model.train(ts, iter(port_batch(b) for b in ref["batches"]),
                              **kw)
    assert set(metrics) == set(ref["metrics"])
    for k, v in ref["metrics"].items():
        np.testing.assert_allclose(float(metrics[k]), v, err_msg=k, **LOSS_TOL)
    assert ts.step == int(ref["after"]["step"]) == 1
    convert.load_checkpoint(ts, _ckpt(ref["after"]))
    check_checkpoints_cross(ref, ts, tmp_path)


def test_inference_matches_hemx(ref, tmp_path):
    """eval_losses; artist's predict and summaries too."""
    model, ts = port_model(ref)
    b0 = port_batch(ref["batches"][0])
    kw = {}
    if ref["args"].model == "info_gan":
        kw["noise"] = {"z": nchw(jax.random.uniform(
            jax.random.fold_in(jax.numpy.asarray(ts.rng), 0),
            (BATCH, ref["hw"], ref["hw"], 1)))}
    else:
        for got, want in zip(model.predict(ts, b0), ref["predict"]):
            np.testing.assert_allclose(nhwc(got), want, **PRED_TOL)
    evals = model.eval_losses(ts, b0, **kw)
    assert set(evals) == set(ref["evals"])
    for k, v in ref["evals"].items():
        np.testing.assert_allclose(float(evals[k]), v, err_msg=k, **LOSS_TOL)
    if ref["args"].model == "artist":
        from hemx_torch.summaries.events import EventsWriter
        w = EventsWriter(str(tmp_path / "port_events"))
        model.write_summaries(w, 0, ts, b0)
        w.close()
        assert image_tags(tmp_path / "port_events") == ref["images"] == {
            "x", "y", "x_hat", "y_hat"}


def test_artist_chain_and_output_padding():
    """The encoder chain at 256 and 65 px, and the decoders back to the
    input size (61 -> 126 -> 256 and 5 -> 14 are one past the transpose)."""
    from hemx.models.artist import _chain
    from hemx_torch.models.artist import Decoder, Encoder, chain
    assert chain(256) == _chain(256) == [256, 126, 61, 29, 13, 5, 1]
    assert chain(65) == _chain(65) == [65, 31, 14, 5, 1]
    g = torch.Generator().manual_seed(0)
    enc = Encoder((3, 256, 256), generator=g)
    x = torch.rand(1, 3, 256, 256, generator=g)
    e, stats = enc(x)
    assert e.shape == (1, 384, 1, 1) and set(stats) == {
        f"e{i}_bn" for i in range(2, 7)}
    y, _ = Decoder(1, 256, generator=g)(torch.cat([e, e]))
    assert y.shape == (2, 1, 256, 256)


def test_info_gan_losses_guarded():
    """d_loss stays finite at d_fake == 1.0 exactly: ``log((1 - p) + eps)``
    in that order is log(eps), as hemx's guarded form gives under jit."""
    from hemx.ops.losses import guarded_one_minus as hemx_guard
    from hemx_torch.models.info_gan import EPS, d_loss_of
    from hemx_torch.ops.losses import guarded_one_minus
    p = torch.ones(4, 1, 1, 1)
    assert guarded_one_minus(p).eq(0).all()
    assert torch.log(guarded_one_minus(p) + EPS).eq(
        torch.log(torch.tensor(EPS))).all()
    d_real = torch.full((4, 1, 1, 1), 0.75)
    got = d_loss_of(d_real, p)
    want = jax.jit(lambda r, f: -jax.numpy.mean(
        jax.numpy.log(r + EPS) + jax.numpy.log(hemx_guard(f) + EPS)))(
        jax.numpy.asarray(d_real.numpy()), jax.numpy.asarray(p.numpy()))
    assert np.isfinite(float(got)) and np.isfinite(float(want))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
