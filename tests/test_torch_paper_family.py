"""The paper_* GANs of hemx_torch (paper_sampler, paper_noise,
paper_baseline_sampler) held against hemx.models.paper_family, with the
machinery and tolerances of tests/test_torch_paper_cgan.py: one hemx run
per configuration (65x65, full width; batch 4 where BN is in a net, 2
otherwise), then the port's train call, inference and summaries against
it. The standalone models are in
tests/test_torch_paper_standalone.py.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tests.test_torch_paper_cgan import (  # noqa: E402,F401
    _two_torch_threads, check_inference, check_summaries, check_train_call,
    hemx_reference)

ADAM = dict(g_lr=1e-4, d_lr=1e-4, g_beta1=0.5, d_beta1=0.9, g_beta2=0.999,
            d_beta2=0.999)
# name -> (model, batch, flags)
CONFIGS = {
    "sampler_e2_ebn": ("paper_sampler", 4,
                       dict(noise_layer="e2", e_bn=True, **ADAM)),
    "sampler_e4_512": ("paper_sampler", 2,
                       dict(noise_layer="e4-512", e_bn=False, **ADAM)),
    "noise": ("paper_noise", 2, dict(model_version="baseline", **ADAM)),
    "baseline_sampler_mean_provided": (
        "paper_baseline_sampler", 2,
        dict(model_version="mean_provided", training_version="gan", **ADAM)),
}


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


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def ref(request, tmp_path_factory):
    name, batch, flags = CONFIGS[request.param]
    return hemx_reference(name, tmp_path_factory.mktemp(request.param),
                          batch=batch, **flags)


def test_train_call_matches_hemx(ref):
    assert ref["n"] == 2  # one D step and one G step
    check_train_call(ref, adam_lr=1e-4)


def test_inference_matches_hemx(ref):
    check_inference(ref)


def test_summaries_match_hemx(ref, tmp_path):
    got = check_summaries(ref, tmp_path)
    prefixes = ["metrics_y_hat/", "metrics_y_0/", "metrics_y_mean/"]
    if ref["args"].model != "paper_baseline_sampler":
        prefixes.append("metrics_y_sampler/")
    for prefix in prefixes:
        assert any(k.startswith(prefix) for k in got), prefix


@pytest.mark.parametrize("site", ["x", "e1", "e2", "e3", "e4", "e4-512",
                                  "d2", "d3", "d4"])
def test_every_noise_site_trains_and_resamples(site):
    """Every --noise_layer of paper_sampler trains one call (finite
    metrics, step 1) with noise from the seeded generator, and two draws of
    the sampler path differ only through the noise."""
    from hemx_torch.models.paper_family import PaperSampler
    from tests.conftest import make_args
    args = make_args(model="paper_sampler", noise_layer=site, e_bn=False,
                     **ADAM)
    model = PaperSampler(args, "cpu")
    ts = model.init_state((3, 65, 65), 0)
    rng = np.random.default_rng(0)
    batch = {"image": torch.from_numpy(rng.random((2, 3, 65, 65),
                                                  dtype=np.float32)),
             "depth": torch.from_numpy(rng.random((2, 1, 65, 65),
                                                  dtype=np.float32))}
    ts, metrics = model.train(ts, iter([batch, batch]))
    assert ts.step == 1
    assert all(np.isfinite(float(v)) for v in metrics.values())
    g1, _ = model.sample(ts, batch)
    ts.step += 1  # another step key, another draw
    g2, _ = model.sample(ts, batch)
    assert g1.shape == (2, 1, 29, 29)
    assert not torch.equal(g1, g2)
