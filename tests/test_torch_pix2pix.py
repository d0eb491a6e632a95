"""pix2pix of hemx_torch held against hemx's Pix2PixModel.

hemx runs at 32x32, full channel width, batch 4, jitted at XLA backend
level 0 (``tests/test_torch_paper_cgan.py`` says why), from one seed:
init and one train call of each configuration below, and init, eval
losses, predict, the sampler path and the summaries once, with every
noise site, dropout, BN in G and D and ``--add_l1 --lambda 3``. The port
loads hemx's initial weights and takes the same batches and every draw
hemx's key chain makes -- the U-Net's ``z_input``, ``z_latent``, keep
masks ``keep_d1``-``keep_d3`` and ``z_end``, in that order (``g_noise``).
The train-call configurations:

* ``--add_l1 --lambda 3`` with Adam (the published optimizer): a
  non-default lambda is honoured;
* every noise site, ``--dropout 0.5``, ``--batch_norm_gen`` and
  ``--batch_norm_disc``, sgd;
* ``--n_disc_train 2``, sgd; its checkpoints cross both ways (Adam's
  state crosses in ``tests/test_torch_artist_info_gan.py`` and
  ``tests/test_torch_paper_cgan.py``).

Tolerances as ``tests/test_torch_paper_cgan.py``'s. A 65 px input (the
``cgan_experiments`` configs' ``random_crop 65 65``) is refused by both
packages with hemx's message.
"""

from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from tests.test_torch_paper_cgan import (  # noqa: E402,F401
    _hemx_float32, _two_torch_threads, check_checkpoints_cross,
    check_inference, check_summaries, check_train_call, generator_of,
    hemx_reference, port_batch, port_model)

REPO = Path(__file__).resolve().parents[1]
HW, BATCH = 32, 4
BASE = dict(noise=[], dropout=0, batch_norm_gen=False, batch_norm_disc=False,
            add_l1=False, l1_lambda=10.0, n_disc_train=1, optimizer="sgd",
            lr=1e-3)
ADAM = dict(optimizer="adam", lr=1e-4, beta1=0.5, beta2=0.999)
CONFIGS = {
    "add_l1_lambda3_adam": dict(add_l1=True, l1_lambda=3.0, **ADAM),
    "noise_dropout_bn": dict(noise=["input", "latent", "end"], dropout=0.5,
                             batch_norm_gen=True, batch_norm_disc=True),
    "n_disc_train_2": dict(n_disc_train=2),
}
CROSS = "n_disc_train_2"
# eval_losses, predict, sample, the summaries and the draws without the
# seam, held once: every draw (the three noise sites, the dropout masks),
# BN in G and D and the lambda-weighted l1
INFERENCE = dict(CONFIGS["noise_dropout_bn"], add_l1=True, l1_lambda=3.0)


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def ref(request, tmp_path_factory):
    """hemx's start state and one train call of a configuration."""
    return hemx_reference("pix2pix", tmp_path_factory.mktemp("pix2pix"),
                          batch=BATCH, hw=HW,
                          checkpoint=request.param == CROSS, inference=False,
                          summaries=False, **{**BASE, **CONFIGS[request.param]})


@pytest.fixture(scope="module")
def inference_ref(tmp_path_factory):
    """hemx's eval losses, predict, sample and summaries of
    :data:`INFERENCE` (no train call)."""
    return hemx_reference("pix2pix", tmp_path_factory.mktemp("pix2pix"),
                          batch=BATCH, hw=HW, train=False,
                          **{**BASE, **INFERENCE})


def test_train_call_matches_hemx(ref, tmp_path):
    a = ref["args"]
    assert ref["n"] == a.n_disc_train + 1
    adam = (a.lr, a.beta1, a.beta2) if a.optimizer == "adam" else None
    ts = check_train_call(ref, adam=adam,
                          adam_lr=a.lr if a.optimizer == "adam" else None)
    m = ref["metrics"]
    gan = m["g_gan"] + (a.l1_lambda * m["l1"] if a.add_l1 else 0.0)
    np.testing.assert_allclose(m["g_loss"], gan, rtol=1e-6)
    if ref["ckpt_dir"].exists():
        check_checkpoints_cross(ref, ts, tmp_path)


def test_inference_matches_hemx(inference_ref):
    """eval_losses, predict and sample with hemx's draws: hemx runs them
    with ``Ctx(training=True)``, so noise and dropout are drawn there too."""
    check_inference(inference_ref, grad_report=True)


def test_summaries_match_hemx(inference_ref, tmp_path):
    got = check_summaries(inference_ref, tmp_path)
    assert {"sampler/sample_variance", "sampler/mean_sample_l2",
            "sampler/min_sample_l2"} <= set(got)
    assert inference_ref["images"] == {"model/images", "model/real_depths",
                                       "model/fake_depths",
                                       "sampler/fake_depths"}


def test_draws_on_the_device_generator(inference_ref):
    """Without the seam every site and mask comes from the call's seeded
    generator, in the net's order and the same from one state; a call
    draws them and trains, and under ``--check_numerics`` reports the
    gradients' finiteness under hemx's parameter names (BN's too)."""
    from hemx.models.common import grad_finite_report
    from hemx_torch.models import common
    from hemx_torch.models.conditional import draw_noise
    ref = inference_ref
    model, ts = port_model(ref, check_numerics=True)
    G = generator_of(ts)
    x = port_batch(ref["batches"][0])["image"]
    first, again = (draw_noise(G, common.generator(ts, common.TRAIN, "cpu"), x)
                    for _ in range(2))
    assert list(first) == list(G.noise_draws(BATCH, HW, HW))
    assert all(torch.equal(first[k], again[k]) for k in first)
    params = {n: p.detach().clone() for n, p in ts.nets.named_parameters()}
    ts, metrics = model.train(ts, iter(port_batch(b) for b in ref["batches"]))
    start = ref["start"]["params"]
    assert set(metrics.pop("grad_finite")) == set(grad_finite_report(
        {"g": start["generator"], "d": start["discriminator"]}))
    assert ts.step == 1 and all(np.isfinite(float(v))
                                for v in metrics.values())
    assert any(not torch.equal(p, params[n])
               for n, p in ts.nets.named_parameters())


def test_65px_input_refused_as_hemx_refuses_it(tmp_path):
    """``examples/cgan_experiments/*.config`` crop 65x65: both packages
    parse the file and refuse the input when the U-Net is built."""
    from hemx.config import parse_args as hemx_parse
    from hemx.models.plugin import get_model as hemx_model
    from hemx.parallel.mesh import make_mesh
    from hemx_torch.config import parse_args
    from hemx_torch.models.plugin import get_model
    msg = "unet requires power-of-2 size, got 65"
    argv = ["@" + str(REPO / "examples" / "cgan_experiments" / "noise"
                      / "baseline.config"), "--dataset", "synthetic",
            "--synthetic_shape", "65", "65", "3", "--seed", "1", "--dir",
            str(tmp_path)]
    batch = {"image": np.zeros((2, 65, 65, 3), np.float32),
             "depth": np.zeros((2, 65, 65, 1), np.float32)}
    with pytest.raises(AssertionError, match=msg):
        hemx_model("pix2pix")(hemx_parse(argv), make_mesh(1)).init_state(
            jax.random.PRNGKey(0), batch)
    args = parse_args(argv)
    assert args.noise == ["input"]
    with pytest.raises(ValueError, match=msg):
        get_model("pix2pix")(args, "cpu").init_state((3, 65, 65), 0)
