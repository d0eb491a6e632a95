"""hemx's ``model`` mesh axis in hemx_torch (``--model_parallel``), held
against hemx's ``(data=2, model=2)`` mesh.

hemx trains one call on ``make_mesh(4, model=2)`` of the 8-device CPU mesh
of ``tests/conftest.py`` (batch 4 per data shard, global 8), jitted at XLA
backend level 0 (``tests/test_torch_paper_cgan.py:74``), from its own
initial state, which it also writes as ``checkpoint-0``. The port runs the
same call in four gloo processes (``tests/test_torch_dp_worker.py``'s
``calls`` with ``model_parallel 2``): each rank loads its slice of every
kernel hemx shards from hemx's checkpoint, takes its data shard's rows of
each global batch and of hemx's global noise, and the checkpoint the ranks
write together holds the whole kernels. The state after the call and the
metrics must equal hemx's at the tolerances of hemx's own TP tests
(``tests/test_models.py::TestModelParallel``): the CNN's loss rtol 1e-5
and its parameters rtol 2e-4 / atol 1e-6; the IWGAN's (``n_disc_train 2``,
so its gradient penalty differentiates through the sliced critic) and
pix2pix's (U-Net, two optimizers) losses rtol 5e-4 / atol 1e-5, the rest
rtol 2e-3 / atol 2e-5. Each rank's slice of every parameter and optimizer
moment must equal hemx's shard on the matching device
(``addressable_shards``): the placement.

The collectives are checked alone in float64 on two gloo ranks: each
conjugate pair of ``hemx_torch.parallel.tp`` passes ``gradcheck`` and
``gradgradcheck`` in a function whose input and output every rank holds
whole, and the column- and row-parallel conv, deconv and dense layers
equal the whole layer, forward and backward.
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tests.test_torch_dp_worker import calls  # noqa: E402

B, HW, LATENT = 4, 32, 16
CNN_LOSS_TOL = dict(rtol=1e-5, atol=0)
CNN_TOL = dict(rtol=2e-4, atol=1e-6)
LOSS_TOL = dict(rtol=5e-4, atol=1e-5)
TOL = dict(rtol=2e-3, atol=2e-5)
CONFIGS = {
    "cnn": dict(),
    "iwgan": dict(n_disc_train=2, optimizer="sgd", lr=1e-3),
    "pix2pix": dict(n_disc_train=1, add_l1=True, l1_lambda=10.0, noise=[],
                    dropout=0, batch_norm_disc=False, batch_norm_gen=False,
                    optimizer="sgd", lr=1e-3),
}


def image_batches(rows, hw=HW, depth=False):
    def make(rng, n):
        out = []
        for _ in range(n):
            b = {"image": rng.random((rows, hw, hw, 3), dtype=np.float32)}
            if depth:
                b["depth"] = rng.random((rows, hw, hw, 1), dtype=np.float32)
            out.append(b)
        return out
    return make


def hemx_axes_call(name, tmp, batches_of, *, model=1, spatial=1,
                   data=2, **overrides):
    """hemx's model ``name`` on ``make_mesh(data * axis, model=, spatial=)``
    at batch ``B`` per data shard: its start checkpoint in ``tmp/start``,
    one train call on ``batches_of(rng, n)``'s global batches, and the
    state (as hemx's arrays, with their shardings) and metrics after it."""
    import jax
    from flax import serialization

    from hemx.models.plugin import get_model
    from hemx.parallel.dp import shard_batch
    from hemx.parallel.mesh import make_mesh
    from hemx.train.checkpoint import CheckpointManager
    from tests.conftest import make_args
    from tests.test_torch_paper_cgan import xla_opt0
    args = make_args(**{"model": name, "batch_size": B,
                        "latent_size": LATENT,
                        "synthetic_shape": [HW, HW, 3],
                        "model_parallel": model, "spatial_parallel": spatial,
                        **overrides})
    mesh = make_mesh(data * model * spatial, model=model, spatial=spatial)
    rng = np.random.default_rng(3)
    with xla_opt0():
        hm = get_model(name)(args, mesh)
        n = hm.batches_per_train_call()
        batches = batches_of(rng, n)
        ts = hm.init_state(jax.random.PRNGKey(args.seed), batches[0])
        CheckpointManager(str(tmp / "start")).save(
            {"train_state": ts, "epoch": np.int64(0)}, 0)
        start = jax.device_get(ts)
        new_ts, metrics = hm.train(
            ts, iter([shard_batch(b, mesh) for b in batches]))
        CheckpointManager(str(tmp / "hemx_after")).save(
            {"train_state": new_ts, "epoch": np.int64(1)}, 1)
        placed = serialization.to_state_dict(new_ts)
    from hemx_torch.train.checkpoint import CheckpointManager as Port
    return dict(args=args, batches=batches, start=start, mesh=mesh,
                model=hm, placed=placed,
                after=Port(str(tmp / "hemx_after")).restore()["train_state"],
                metrics={k: float(v) for k, v in
                         jax.device_get(metrics).items()})


def port_spec(ref, tmp, noise, image_shape) -> str:
    """The spec of one call of the port's model from hemx's start
    checkpoint in ``tmp`` (``tests/test_torch_dp_worker.py``)."""
    arrays = {f"batch{i}/{k}": v for i, b in enumerate(ref["batches"])
              for k, v in b.items()}
    arrays.update({f"noise{i}/{k}": np.asarray(v) for i, d in
                   enumerate(noise or []) for k, v in d.items()})
    np.savez(tmp / "arrays.npz", **arrays)
    spec = dict(args=dict(vars(ref["args"])), image_shape=image_shape,
                start=str(tmp / "start"), arrays=str(tmp / "arrays.npz"),
                out=str(tmp / "out"))
    with open(tmp / "spec.json", "w") as f:
        json.dump(spec, f)
    return str(tmp / "spec.json")


def port_ranks(specs, nprocs=4) -> None:
    """Each spec's call on ``nprocs`` gloo processes, started once."""
    from hemx_torch.parallel import mesh
    mesh.spawn(calls, nprocs, device="cpu", args=(list(specs),))


def port_result(tmp):
    """(rank 0's checkpoint tree, the metrics) of the call in ``tmp``."""
    from hemx_torch.train.checkpoint import CheckpointManager
    with open(tmp / "out" / "metrics.json") as f:
        metrics = json.load(f)
    return CheckpointManager(str(tmp / "out")).restore(), metrics


def flat(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


def assert_close(got: dict, want: dict, tol):
    g, w = flat(got), flat(want)
    assert sorted(g) == sorted(w)
    for k in w:
        np.testing.assert_allclose(g[k], w[k], err_msg="/".join(k), **tol)


def assert_metrics(metrics, want, loss_tol, tol):
    assert set(metrics) == set(want)
    for k in want:
        np.testing.assert_allclose(metrics[k], want[k], err_msg=k,
                                   **(tol if "grad_norm" in k else loss_tol))


def noise_of(name, ref, rows):
    """hemx's draws of one call for the global batch, in the seam's form
    (None where the model draws nothing)."""
    from tests.test_torch_gan import jax_train_noise
    from tests.test_torch_iwgan import _jax_noise
    from tests.test_torch_vae import jax_eps
    args = ref["args"]
    if name == "iwgan":
        return _jax_noise(args.seed, 0, args.n_disc_train, rows, LATENT)
    if name == "gan":
        return jax_train_noise(name, ref["start"]["rng"], 0,
                               args.n_disc_train, rows, LATENT)
    if name == "vae":
        return [jax_eps(ref["start"]["rng"], 0, rows, LATENT)]
    return None


@pytest.fixture(scope="module")
def calls_done(tmp_path_factory):
    """hemx's call of every configuration, then the port's, all on one
    start of its four ranks: {name: (ref, tmp)}."""
    done, specs = {}, []
    for name in sorted(CONFIGS):
        tmp = tmp_path_factory.mktemp(f"tp_{name}")
        ref = hemx_axes_call(name, tmp, image_batches(
            2 * B, depth=name == "pix2pix"), model=2, **CONFIGS[name])
        specs.append(port_spec(ref, tmp, noise_of(name, ref, 2 * B),
                               (3, HW, HW)))
        done[name] = (ref, tmp)
    port_ranks(specs)
    return done


@pytest.fixture(params=sorted(CONFIGS))
def case(request, calls_done):
    ref, tmp = calls_done[request.param]
    return (request.param, ref, *port_result(tmp), tmp)


def test_four_ranks_match_hemx_data2_model2(case):
    name, ref, tree, metrics, _ = case
    loss_tol, tol = ((CNN_LOSS_TOL, CNN_TOL) if name == "cnn"
                     else (LOSS_TOL, TOL))
    assert_metrics(metrics, ref["metrics"], loss_tol, tol)
    state = tree["train_state"]
    assert int(state["step"]) == 1
    for part in ("params", "mstate", "opt"):
        assert_close(state[part], ref["after"][part], tol)


def test_each_rank_holds_hemx_shard(case):
    """Rank r's slice of every parameter and optimizer moment equals
    hemx's shard on device r of the mesh, and a kernel hemx shards is
    sliced (a leaf it replicates is whole)."""
    name, ref, _, _, tmp = case
    devices = list(ref["mesh"].devices.flat)
    sliced = 0
    for r, dev in enumerate(devices):
        mine = dict(np.load(tmp / "out" / f"shards-{r}.npz"))
        placed = flat({k: ref["placed"][k] for k in ("params", "opt")})
        placed = {"/".join(k): v for k, v in placed.items()
                  if hasattr(v, "addressable_shards")}
        assert set(placed) <= set(mine)
        for key, leaf in placed.items():
            shard = [s for s in leaf.addressable_shards if s.device == dev]
            want = np.asarray(shard[0].data)
            np.testing.assert_array_equal(mine[key].shape, want.shape,
                                          err_msg=key)
            np.testing.assert_allclose(mine[key], want, err_msg=key, **TOL)
            sliced += want.shape != leaf.shape
    assert sliced >= 8  # kernels and their moments, on every rank


# -- the collectives alone ------------------------------------------------

def _pairs_worker():
    from torch.autograd import gradcheck, gradgradcheck

    from hemx_torch.parallel import dp, tp
    dp.set_axis("model", 2)
    a = dp.axis_index()
    torch.manual_seed(0)
    c = torch.tensor([1.5, -0.75], dtype=torch.float64)[a]

    def copy_reduce(x):  # a rank's part of a linear map, summed
        return tp.reduce(torch.sin(tp.copy(x)) * c)

    def gather_scatter(x):  # a rank's slot, scaled, gathered back
        return tp.gather(torch.sin(tp.scatter(x, 1)) * c, 1)

    x = torch.randn(2, 4, 2, 1, dtype=torch.float64, requires_grad=True)
    for fn in (copy_reduce, gather_scatter):
        assert gradcheck(fn, (x,)), fn.__name__
        assert gradgradcheck(fn, (x,)), fn.__name__


def test_conjugate_pairs_gradcheck_and_gradgradcheck():
    from hemx_torch.parallel import mesh
    mesh.spawn(_pairs_worker, 2, device="cpu")


def _layers_worker():
    from hemx_torch.ops import layers
    from hemx_torch.parallel import dp, tp
    torch.manual_seed(0)
    x = torch.randn(2, 6, 9, 7, dtype=torch.float64)
    wc = torch.randn(4, 6, 5, 5, dtype=torch.float64)
    wd = torch.randn(6, 3, 5, 5, dtype=torch.float64)
    xd = torch.randn(2, 12, dtype=torch.float64)
    wl = torch.randn(8, 12, dtype=torch.float64)
    ops = {"conv": lambda t, w: layers.conv2d_op(t, w, 2),
           "deconv": lambda t, w: layers.deconv2d_op(t, w, (18, 14), 2),
           "dense": layers.linear_op}
    whole = {}
    for name, inp, w in (("conv", x, wc), ("deconv", x, wd),
                         ("dense", xd, wl)):
        t, ww = inp.clone().requires_grad_(True), w.clone().requires_grad_(True)
        y = ops[name](t, ww)
        r = torch.randn_like(y)
        whole[name] = (y.detach(), r, *torch.autograd.grad((y * r).sum(),
                                                          (t, ww)))
    dp.set_axis("model", 2)
    a = dp.axis_index()
    for name, inp, w in (("conv", x, wc), ("deconv", x, wd),
                         ("dense", xd, wl)):
        net = torch.nn.Linear(1, 1)
        net.w = torch.nn.Parameter(w.clone())
        tp.shard_module(net)
        assert tp.sharded(net.w) and net.w.shape[0] == w.shape[0] // 2
        t = inp.clone().requires_grad_(True)
        y = ops[name](t, net.w)
        want_y, r, want_gx, want_gw = whole[name]
        torch.testing.assert_close(y, want_y, rtol=1e-12, atol=1e-12)
        gx, gw = torch.autograd.grad((y * r).sum(), (t, net.w))
        torch.testing.assert_close(gx, want_gx, rtol=1e-12, atol=1e-12)
        n = w.shape[0] // 2
        torch.testing.assert_close(gw, want_gw[a * n:(a + 1) * n],
                                   rtol=1e-12, atol=1e-12)


def test_sliced_layers_equal_the_whole_layer():
    """Column-parallel conv and dense, row-parallel deconv (hemx's
    ``[H, W, out, in]`` kernel sharded on ``in``): the whole output on
    every rank, the whole input gradient and the rank's slice of the
    kernel's gradient."""
    from hemx_torch.parallel import mesh
    mesh.spawn(_layers_worker, 2, device="cpu")
