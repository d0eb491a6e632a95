"""improved_sampler of hemx_torch held against hemx's ImprovedSampler at the
published widths, batch 4, with the machinery of
tests/test_torch_paper_cgan.py (hemx once per configuration, its steps at
XLA backend level 0; hemx's weights and key-chain noise in the port). One
configuration per file, so that no file runs long:

* here A1/A1 at 65 px: BN in G (its closing one-channel 1x1 conv
  included), the 0.4769 center crop;
* tests/test_torch_improved_sampler_b1.py: B1/B1 at 66 px, mixed filters,
  the two deconvs one past the full transpose (6 -> 14, 14 -> 31), the
  (17, 17, 31) crop;
* tests/test_torch_improved_sampler_e1.py: E1/E1 at 64 px with
  --g_sparsity --g_rmse, SAME stages, the VALID 4x4 bottleneck and its
  deconv, the x_loc / y_loc / mean channels, both extra generator terms.

Each on a1.config's optimizer (adam, lr 1e-4, beta1 0.5): one train call
(a D step then a G step on the same batch, one noise draw each),
eval_losses, predict, the sampler path and grad_report's names, and
(here) the summaries, whose shuffled and pure-noise diagnostic paths get
hemx's permutation and draws. Tolerances, as in
tests/test_torch_paper_cgan.py: losses (the sparsity term among them)
rtol 5e-4 / atol 1e-5; parameters, optimizer moments, gradient norms and
summary scalars rtol 2e-3 / atol 2e-5; predictions rtol 2e-3 / atol
1e-4; biases feeding BN |change| <= lr.
Where a gradient is below 1e-6, within 100 x Adam's eps, Adam's first step
amplifies its rounding (B1's 1x1 critic conv h1 has such elements: one
moved 4.8e-5 apart, 1.1 %), so there each side's update is held to
optax's step of its own gradient instead (``check_adam_first_step``).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from tests.test_torch_paper_cgan import (  # noqa: E402,F401
    _hemx_float32, _two_torch_threads, check_inference, check_summaries,
    check_train_call, hemx_reference, nchw, port_batch, port_model)

ADAM = dict(optimizer="adam", lr=1e-4, beta1=0.5, beta2=0.999)
CONFIGS = {
    "A1": dict(g_arch="A1", d_arch="A1", hw=65, g_sparsity=False,
               g_rmse=False),
    "B1": dict(g_arch="B1", d_arch="B1", hw=66, g_sparsity=False,
               g_rmse=False),
    "E1_sparsity_rmse": dict(g_arch="E1", d_arch="E1", hw=64,
                             g_sparsity=True, g_rmse=True,
                             extra_keys=("x_loc", "y_loc", "mean")),
}
BATCH = 4


def reference(name: str, tmp_path_factory, *, summaries: bool = True):
    """hemx's run of configuration ``name`` (``hemx_reference``), with the
    diagnostic paths' draws of its summaries under "diag"."""
    flags = CONFIGS[name]
    hw, c = flags["hw"], 3 + len(flags.get("extra_keys", ()))
    diag = {}

    def hook(model, ts):
        """hemx's diagnostic-path draws (improved_sampler.py:319-332) from
        the summary step's key, NCHW for the port: both paths share one
        Ctx, so G's second call draws from the key its first one left."""
        key = jax.random.fold_in(ts["rng"], 0)
        diag["perm"] = torch.from_numpy(
            np.asarray(jax.random.permutation(key, BATCH), np.int64))
        diag["x_noise"] = nchw(jax.random.uniform(
            key, (BATCH, hw, hw, c), minval=-1.0, maxval=1.0))
        for name in ("z_shuffled", "z_noise"):
            key, sub = jax.random.split(key)
            diag[name] = nchw(jax.random.uniform(
                sub, (BATCH, hw, hw, 1), minval=-1.0, maxval=1.0))

    out = hemx_reference("improved_sampler", tmp_path_factory.mktemp(name),
                         batch=BATCH, summary_hook=hook, summaries=summaries,
                         **flags, **ADAM)
    out["diag"] = diag
    return out


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    return reference("A1", tmp_path_factory)


def test_train_call_matches_hemx(ref):
    assert ref["n"] == 1  # one batch: the D and G steps share it
    bn = ref["args"].g_arch == "A1"
    check_train_call(ref, adam_lr=1e-4 if bn else None,
                     adam=(ADAM["lr"], ADAM["beta1"], ADAM["beta2"]))


def test_inference_matches_hemx(ref):
    check_inference(ref, grad_report=True, capture=("generator/e_bottleneck",))


def test_summaries_match_hemx(ref, tmp_path):
    got = check_summaries(ref, tmp_path, diag=ref["diag"])
    assert {"shuffled/variance", "noise/variance",
            "sampler/sample_variance"} <= set(got)


def test_metrics_targets_and_capture(ref):
    """The extra generator metrics hemx reports, the target crop per
    generator, and the capture of G's bottleneck on 8 rows (hemx records
    it as ``e_bottleneck``, improved_sampler.py:163): the last encoder
    stage's relu output, NHWC."""
    want = {"rmse", "l1"} | ({"sparsity_term"} if ref["args"].g_sparsity
                             else set())
    assert want <= set(ref["metrics"])
    side = 32 if ref["args"].g_arch == "E1" else 31
    assert ref["predict"][1]["y"].shape[1:] == (side, side, 1)
    model, ts = port_model(ref)
    b0 = port_batch(ref["batches"][0])
    got = model.capture_activations(ts, b0)
    assert set(got) == {"generator/e_bottleneck"}
    stats = got["generator/e_bottleneck"]
    prep = model.prepare(b0)
    _, _, e = ts.nets["generator"](prep["g_input"], torch.zeros(
        (BATCH, 1, ref["hw"], ref["hw"])), bottleneck=True)
    assert stats["sample"].numel() == e.numel()  # batch 4 < 8 rows
    assert 0.0 < float(stats["zero_fraction"]) < 1.0  # relu output
