"""hemx_torch's checkpoints held against hemx's flax-msgpack checkpoints.

* The port's msgpack codec writes the bytes ``flax.serialization`` writes
  for the same tree, and each reads the other's; a port checkpoint file is
  byte-identical to hemx's of the same state.
* A checkpoint that hemx wrote after one IWGAN train call (adam and
  rmsprop) restores into the port exactly: every leaf, empty subtrees
  included, bit for bit.
* A checkpoint the port wrote restores through hemx's
  ``CheckpointManager.restore(template)`` exactly, with no leaf missing
  from or extra to hemx's template.
* One more train call from the restored state, with the same noise, gives
  the same losses and parameters in both packages at the tolerances of
  tests/test_torch_iwgan.py (losses rtol 5e-4 / atol 1e-5, params
  rtol 2e-3 / atol 2e-5).
* ``max_to_keep`` and ``latest()`` behave as hemx's.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import msgpack  # noqa: E402
from flax import serialization  # noqa: E402

from tests.conftest import make_args  # noqa: E402
from tests.test_torch_iwgan import _nchw  # noqa: E402

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


def _noise_from_key(key, step):
    """hemx's key chain for one train call from the state's key (which hemx
    advances every substep) and step (hemx/models/common.py:107-118)."""
    base = jax.numpy.asarray(key)
    out = []
    for i in range(N_D + 1):
        sub, base = jax.random.split(jax.random.fold_in(base, step))
        if i < N_D:
            _, zk, ak = jax.random.split(sub, 3)
            out.append({"z": jax.random.normal(zk, (B, LATENT)),
                        "alpha": jax.random.uniform(ak, (B, 1))})
        else:
            _, zk = jax.random.split(sub)
            out.append({"z": jax.random.normal(zk, (B, LATENT))})
    return [{k: torch.from_numpy(np.array(v)) for k, v in d.items()}
            for d in out]


def _spec(tree):
    if isinstance(tree, dict):
        return {k: _spec(v) for k, v in tree.items()}
    return (np.shape(tree), np.asarray(tree).dtype.name)


def _assert_bit_equal(got, want):
    from hemx_torch.convert import flatten_tree
    assert _spec(got) == _spec(want)
    g, w = flatten_tree(got), flatten_tree(want)
    for k in w:
        np.testing.assert_array_equal(np.asarray(g[k]), np.asarray(w[k]),
                                      err_msg="/".join(k))


def _close(got, want, rtol, atol):
    from hemx_torch.convert import flatten_tree
    g, w = flatten_tree(got), flatten_tree(want)
    assert sorted(g) == sorted(w)
    for k in w:
        np.testing.assert_allclose(np.asarray(g[k]), np.asarray(w[k]),
                                   rtol=rtol, atol=atol, err_msg="/".join(k))


@pytest.fixture(scope="module", params=["adam", "rmsprop"])
def hemx_run(request, tmp_path_factory):
    """hemx IWGAN after one train call, saved as checkpoint-1 by hemx's
    CheckpointManager; plus the batches of a second call and hemx's result
    of that call."""
    from hemx.models.plugin import get_model
    from hemx.parallel.dp import shard_batch
    from hemx.parallel.mesh import make_mesh
    from hemx.train.checkpoint import CheckpointManager
    extra = ({"lr": 1e-4, "beta1": 0.5, "beta2": 0.9}
             if request.param == "adam" else {})
    args = make_args(model="iwgan", batch_size=B, latent_size=LATENT,
                     n_disc_train=N_D, optimizer=request.param,
                     synthetic_shape=[HW, HW, 3], seed=3, **extra)
    mesh = make_mesh(1)
    rng = np.random.default_rng(11)
    batches = [rng.random((B, HW, HW, 3), dtype=np.float32)
               for _ in range(2 * (N_D + 1))]
    model = get_model("iwgan")(args, mesh)
    ts = model.init_state(jax.random.PRNGKey(args.seed),
                          {"image": batches[0]})
    stream = iter([shard_batch({"image": b}, mesh) for b in batches])
    ts, _ = model.train(ts, stream)
    d = tmp_path_factory.mktemp(f"hemx_{request.param}")
    wrapper = {"train_state": ts, "epoch": np.int64(1)}
    CheckpointManager(str(d)).save(wrapper, 1)
    tree = serialization.to_state_dict(jax.device_get(wrapper))
    ts2, metrics = model.train(ts, stream)
    return dict(args=args, dir=d, tree=tree, template=wrapper,
                batches=batches[N_D + 1:], after=jax.device_get(ts2),
                metrics={k: float(v) for k, v in
                         jax.device_get(metrics).items()})


def _port_state(args):
    from hemx_torch.models.gan import IwganModel
    model = IwganModel(args, "cpu")
    return model, model.init_state((3, HW, HW), 0)


def test_codec_bytes_equal_flax_and_read_both_ways():
    from hemx_torch.train import msgpack as M
    tree = {"b": {"w": np.arange(24, dtype=np.float32).reshape(2, 3, 4),
                  "flatten": {}, "i": np.array([0, 7], np.uint32)},
            "a": {"step": np.asarray(5, np.int32), "x": np.float32(0.5)},
            "epoch": np.int64(3), "big": np.ones(70000, np.float64)}
    ours = M.packb(tree)
    assert ours == serialization.msgpack_serialize(tree)
    _assert_bit_equal(serialization.msgpack_restore(ours), tree)
    _assert_bit_equal(M.unpackb(serialization.msgpack_serialize(tree)), tree)
    assert isinstance(M.unpackb(ours)["epoch"], np.int64)
    plain = {"s": "x" * 300, "bin": b"\x00" * 70,
             "ints": [0, 127, 128, -1, -33, 65535, 2 ** 33, -2 ** 40],
             "list": list(range(20)), "map": {str(i): i for i in range(20)}}
    assert M.packb(plain) == serialization.msgpack_serialize(plain)
    # the reader also takes the types flax may meet in other trees
    plain.update(n=None, t=True, f=1.5, g=-0.25)
    assert M.unpackb(msgpack.packb(plain)) == plain


def test_codec_refuses_flax_chunked_arrays(monkeypatch):
    from hemx_torch.train import msgpack as M
    chunked = msgpack.packb({"w": {"__msgpack_chunked_array__": True}})
    with pytest.raises(ValueError, match="__msgpack_chunked_array__"):
        M.unpackb(chunked)
    monkeypatch.setattr(M, "MAX_CHUNK_SIZE", 16)
    with pytest.raises(ValueError, match="chunked"):
        M.packb({"w": np.zeros(8, np.float32)})


def test_hemx_checkpoint_restores_into_port_exactly(hemx_run):
    from hemx_torch import convert
    from hemx_torch.train.checkpoint import CheckpointManager
    _, ts = _port_state(hemx_run["args"])
    ckpt = CheckpointManager(str(hemx_run["dir"]))
    assert ckpt.latest().endswith("checkpoint-1.msgpack")
    assert convert.load_checkpoint(ts, ckpt.restore()) == 1
    assert ts.step == 1
    _assert_bit_equal(convert.to_checkpoint(ts, 1), hemx_run["tree"])


def test_port_checkpoint_restores_into_hemx_exactly(hemx_run, tmp_path):
    from hemx.train.checkpoint import CheckpointManager as HemxManager
    from hemx_torch import convert
    from hemx_torch.train.checkpoint import CheckpointManager
    _, ts = _port_state(hemx_run["args"])
    convert.load_checkpoint(ts, hemx_run["tree"])
    path = CheckpointManager(str(tmp_path)).save(
        convert.to_checkpoint(ts, 1), 1)
    with open(path, "rb") as f:
        raw = serialization.msgpack_restore(f.read())
    # flax's restore ignores extra keys, so hold the raw tree to hemx's
    # template's: no leaf missing, none extra
    assert _spec(raw) == _spec(serialization.to_state_dict(
        jax.device_get(hemx_run["template"])))
    restored = HemxManager(str(tmp_path)).restore(hemx_run["template"])
    _assert_bit_equal(serialization.to_state_dict(restored), hemx_run["tree"])
    with open(hemx_run["dir"] / "checkpoint-1.msgpack", "rb") as f:
        assert f.read() == open(path, "rb").read()


def test_train_call_after_restore_matches_hemx(hemx_run):
    from hemx_torch import convert
    from hemx_torch.train.checkpoint import CheckpointManager
    model, ts = _port_state(hemx_run["args"])
    convert.load_checkpoint(ts, CheckpointManager(str(hemx_run["dir"])).restore())
    noise = _noise_from_key(ts.rng, ts.step)
    ts, metrics = model.train(
        ts, iter([{"image": _nchw(b)} for b in hemx_run["batches"]]),
        noise=noise)
    want = hemx_run["after"]
    for k in ("g_loss", "d_loss"):
        np.testing.assert_allclose(float(metrics[k]), hemx_run["metrics"][k],
                                   rtol=5e-4, atol=1e-5, err_msg=k)
    assert ts.step == int(want["step"]) == 2
    params, mstate = convert.to_jax(ts.nets)
    _close(params, want["params"], 2e-3, 2e-5)
    _close(mstate["generator"], want["mstate"]["generator"], 2e-3, 2e-5)


def test_load_refuses_missing_or_extra_leaves(hemx_run):
    import copy
    from hemx_torch import convert
    _, ts = _port_state(hemx_run["args"])
    missing = copy.deepcopy(hemx_run["tree"])
    del missing["train_state"]["mstate"]["discriminator"]["flatten"]
    with pytest.raises(ValueError, match="missing keys"):
        convert.load_checkpoint(ts, missing)
    extra = copy.deepcopy(hemx_run["tree"])
    extra["train_state"]["opt"]["g"]["extra"] = {}
    with pytest.raises(ValueError, match="extra keys"):
        convert.load_checkpoint(ts, extra)
    reshaped = copy.deepcopy(hemx_run["tree"])
    reshaped["train_state"]["rng"] = np.zeros(3, np.uint32)
    with pytest.raises(ValueError, match="expected shape"):
        convert.load_checkpoint(ts, reshaped)


def test_fresh_state_key_is_jax_prngkey():
    from hemx_torch.models.common import prng_key
    for seed in (0, 1, 42, 2 ** 31 + 5):
        np.testing.assert_array_equal(prng_key(seed),
                                      np.asarray(jax.random.PRNGKey(seed)))


@pytest.mark.parametrize("keep", [0, 2])
def test_max_to_keep_and_latest_match_hemx(tmp_path, keep):
    from hemx.train.checkpoint import CheckpointManager as HemxManager
    from hemx_torch.train.checkpoint import CheckpointManager
    port = CheckpointManager(str(tmp_path / "port"), keep)
    ref = HemxManager(str(tmp_path / "hemx"), keep)
    assert port.latest() is None
    for epoch in (0, 1, 2, 10):
        tree = {"epoch": np.int64(epoch)}
        port.save(tree, epoch)
        ref.save(tree, epoch)
    assert [e for e, _ in port.checkpoints()] == \
        [e for e, _ in ref.checkpoints()] == ([0, 1, 2, 10] if keep == 0
                                              else [2, 10])
    assert port.latest().endswith("checkpoint-10.msgpack")
    assert int(port.restore()["epoch"]) == 10
    assert not any(p.name.endswith(".tmp") for p in (tmp_path / "port").iterdir())
