"""Data parallelism of hemx_torch held against hemx's two-device mesh: the
IWGAN (the GP's whole-batch norm), the GAN (BN in G and D, a real then a
fake pass) and the VAE (sum-reduced losses).

hemx trains one call at ``--n_devices 2`` on the 8-device CPU mesh of
``tests/conftest.py`` (batch 4 per device, global 8), jitted at XLA
backend level 0 (``tests/test_torch_paper_cgan.py:74``), from its own
initial state, which it also writes as ``checkpoint-0``. The port runs the
same call in two gloo processes (``hemx_torch.parallel.mesh.spawn`` with
``tests/test_torch_dp_worker.py``'s ``one_call``): each rank restores
hemx's checkpoint, takes its 4 rows of each global batch and its rows of
hemx's global noise (drawn with hemx's key chain, handed in through the
seam), and rank 0 writes the result. Parameters, BN moving statistics,
optimizer state (``momentum``'s trace; sgd for the VAE) and the reported
metrics must equal hemx's, at the tolerances of the one-device tests:
losses rtol 5e-4 / atol 1e-5, the rest rtol 2e-3 / atol 2e-5
(``tests/test_torch_iwgan.py``, ``tests/test_torch_gan.py``), the VAE's
losses rtol 1e-4 and ``grad_norm`` rtol 1e-3 (its float32 KL gradient at
``z_stddev`` near 0 is ill-conditioned: in float64 the two sides agree to
1e-13).
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from tests.conftest import make_args  # noqa: E402
from tests.test_torch_gan import jax_train_noise  # noqa: E402
from tests.test_torch_iwgan import _jax_noise  # noqa: E402
from tests.test_torch_paper_cgan import (  # noqa: E402,F401
    _hemx_float32, flat, xla_opt0)
from tests.test_torch_dp_worker import one_call  # noqa: E402
from tests.test_torch_vae import jax_eps  # noqa: E402

W, B, HW, LATENT = 2, 4, 32, 16
LOSS_TOL = dict(rtol=5e-4, atol=1e-5)
TOL = dict(rtol=2e-3, atol=2e-5)
MOMENTUM = dict(optimizer="momentum", lr=1e-3, momentum=0.5)
CONFIGS = {"iwgan": dict(n_disc_train=2, **MOMENTUM),
           "gan": dict(**MOMENTUM),
           "vae": dict(optimizer="sgd", lr=1e-4)}
METRIC_TOL = {"vae": {"grad_norm": dict(rtol=1e-3, atol=0)},
              "vae_losses": dict(rtol=1e-4, atol=0)}


def global_noise(name, args, start):
    """hemx's draws of one call for the global batch, in the seam's form."""
    if name == "iwgan":
        return _jax_noise(args.seed, 0, args.n_disc_train, W * B, LATENT)
    if name == "gan":
        return jax_train_noise(name, start["rng"], 0, args.n_disc_train,
                               W * B, LATENT)
    return [jax_eps(start["rng"], 0, W * B, LATENT)]


def hemx_call(name, tmp, batches_of, **overrides):
    """hemx's model ``name`` at ``--n_devices 2``: its start checkpoint in
    ``tmp/start``, one train call on ``batches_of(rng, n)``'s global
    batches, and the state and metrics after it."""
    from hemx.models.plugin import get_model
    from hemx.parallel.dp import shard_batch
    from hemx.parallel.mesh import make_mesh
    from hemx.train.checkpoint import CheckpointManager
    args = make_args(**{"model": name, "batch_size": B,
                        "latent_size": LATENT,
                        "synthetic_shape": [HW, HW, 3], **overrides})
    mesh = make_mesh(W)
    rng = np.random.default_rng(3)
    with xla_opt0():
        model = get_model(name)(args, mesh)
        n = model.batches_per_train_call()
        batches = batches_of(rng, n)
        ts = model.init_state(jax.random.PRNGKey(args.seed), batches[0])
        CheckpointManager(str(tmp / "start")).save(
            {"train_state": ts, "epoch": np.int64(0)}, 0)
        start = jax.device_get(ts)
        new_ts, metrics = model.train(
            ts, iter([shard_batch(b, mesh) for b in batches]))
        CheckpointManager(str(tmp / "hemx_after")).save(
            {"train_state": new_ts, "epoch": np.int64(1)}, 1)
    return dict(args=args, batches=batches, start=start, model=model,
                after=_read(tmp / "hemx_after")["train_state"],
                metrics={k: float(v) for k, v in
                         jax.device_get(metrics).items()})


def _read(directory):
    """A checkpoint as plain nested dicts (the port's reader)."""
    from hemx_torch.train.checkpoint import CheckpointManager
    return CheckpointManager(str(directory)).restore()


def port_two_ranks(ref, tmp, noise, image_shape):
    """One call of the port's model in two gloo processes from hemx's
    start checkpoint; returns (rank 0's checkpoint tree, its metrics)."""
    from hemx_torch.parallel import mesh
    arrays = {f"batch{i}/{k}": v for i, b in enumerate(ref["batches"])
              for k, v in b.items()}
    arrays.update({f"noise{i}/{k}": np.asarray(v) for i, d in
                   enumerate(noise or []) for k, v in d.items()})
    np.savez(tmp / "arrays.npz", **arrays)
    args = {k: v for k, v in vars(ref["args"]).items()}
    spec = dict(args=args, image_shape=image_shape, start=str(tmp / "start"),
                arrays=str(tmp / "arrays.npz"), out=str(tmp / "out"))
    with open(tmp / "spec.json", "w") as f:
        json.dump(spec, f)
    mesh.spawn(one_call, W, device="cpu", args=(str(tmp / "spec.json"),))
    with open(tmp / "out" / "metrics.json") as f:
        metrics = json.load(f)
    return _read(tmp / "out"), metrics


def assert_close(got: dict, want: dict, tol, skip=()):
    g, w = flat(got), flat(want)
    assert sorted(g) == sorted(w)
    for k in w:
        if k not in skip:
            np.testing.assert_allclose(g[k], w[k], err_msg="/".join(k), **tol)


def image_batches(rng, n):
    return [{"image": rng.random((W * B, HW, HW, 3), dtype=np.float32)}
            for _ in range(n)]


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def case(request, tmp_path_factory):
    name = request.param
    tmp = tmp_path_factory.mktemp(f"dp_{name}")
    ref = hemx_call(name, tmp, image_batches, **CONFIGS[name])
    noise = global_noise(name, ref["args"], ref["start"])
    tree, metrics = port_two_ranks(ref, tmp, noise, (3, HW, HW))
    return name, ref, tree, metrics


def test_two_ranks_match_hemx_two_devices(case):
    name, ref, tree, metrics = case
    state = tree["train_state"]
    want = ref["metrics"]
    assert set(metrics) == set(want)
    for k in want:
        tol = METRIC_TOL.get(name, {}).get(
            k, METRIC_TOL["vae_losses"] if name == "vae" else LOSS_TOL)
        np.testing.assert_allclose(metrics[k], want[k], err_msg=k, **tol)
    assert int(state["step"]) == int(ref["after"]["step"]) == 1
    assert_close(state["params"], ref["after"]["params"], TOL)
    assert_close(state["mstate"], ref["after"]["mstate"], TOL)
    assert_close(state["opt"], ref["after"]["opt"], TOL)
