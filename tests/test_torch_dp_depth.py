"""Data parallelism of hemx_torch held against hemx's two-device mesh for
the depth models: ``paper_standalone`` (the ``rmse`` loss, a square root
of the global batch's mean; BN in its U-Net) at 65x65, and ``pix2pix`` at
32x32 with every noise site, ``--dropout 0.5`` and BN in G and D (the
noise maps and keep masks drawn for the global batch, each rank keeping
its rows).

The machinery is ``tests/test_torch_dp_gan.py``'s: hemx at ``--n_devices
2`` (batch 4 per device) at XLA backend level 0 against the port in two
gloo processes from hemx's start checkpoint, hemx's draws handed to the
port through the seam. Tolerances are the one-device tests'
(``tests/test_torch_paper_cgan.py``): metrics rtol 5e-4 / atol 1e-5,
parameters, BN statistics and optimizer state rtol 2e-3 / atol 2e-5
(gradient norms are held by the parameters' tolerance there and here).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tests.test_torch_dp_gan import (  # noqa: E402
    B, LOSS_TOL, TOL, W, assert_close, hemx_call, port_two_ranks)
from tests.test_torch_paper_cgan import (  # noqa: E402,F401
    _hemx_float32, _two_torch_threads, generator_of, port_model, train_noise)

CONFIGS = {
    "paper_standalone": (65, dict(model_version="mean_provided", g_lr=1e-4,
                                  g_beta1=0.5, g_beta2=0.999)),
    "pix2pix": (32, dict(noise=["input", "latent", "end"], dropout=0.5,
                         batch_norm_gen=True, batch_norm_disc=True,
                         add_l1=False, l1_lambda=10.0, n_disc_train=1,
                         optimizer="sgd", lr=1e-3)),
}


def depth_batches(hw):
    def make(rng, n):
        return [{"image": rng.random((W * B, hw, hw, 3), dtype=np.float32),
                 "depth": rng.random((W * B, hw, hw, 1), dtype=np.float32)}
                for _ in range(n)]
    return make


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def case(request, tmp_path_factory):
    name = request.param
    hw, flags = CONFIGS[name]
    tmp = tmp_path_factory.mktemp(f"dp_{name}")
    ref = hemx_call(name, tmp, depth_batches(hw), synthetic_shape=[hw, hw, 3],
                    **flags)
    ref["hw"] = hw
    noise = None
    if name == "pix2pix":
        model, ts = port_model(ref)
        noise = train_noise(generator_of(ts), ref["start"]["rng"], 0,
                            model.n_substeps(), W * B, hw)
    tree, metrics = port_two_ranks(ref, tmp, noise, (3, hw, hw))
    return name, ref, tree, metrics


def test_two_ranks_match_hemx_two_devices(case):
    name, ref, tree, metrics = case
    state = tree["train_state"]
    want = ref["metrics"]
    assert set(metrics) == set(want)
    for k in want:
        tol = TOL if "grad_norm" in k else LOSS_TOL
        np.testing.assert_allclose(metrics[k], want[k], err_msg=k, **tol)
    assert int(state["step"]) == 1
    assert_close(state["params"], ref["after"]["params"], TOL)
    assert_close(state["mstate"], ref["after"]["mstate"], TOL)
    assert_close(state["opt"], ref["after"]["opt"], TOL)
