"""paper_standalone and paper_baseline_standalone of hemx_torch (one
supervised generator, no critic, one Adam, RMSE on /10 meters) held
against hemx.models.paper_family, with the machinery and tolerances of
tests/test_torch_paper_cgan.py: one hemx run per configuration (65x65,
full width, batch 2), then the port's train call (its state tree is the
generator's own, its optimizer state one Adam's), eval, predict, the
summaries against it, and for paper_standalone the checkpoints both ways.
"""

import pytest

torch = pytest.importorskip("torch")

from tests.test_torch_paper_cgan import (  # noqa: E402,F401
    _two_torch_threads, check_checkpoints_cross, check_inference,
    check_summaries, check_train_call, hemx_reference)

ADAM = dict(g_lr=1e-4, g_beta1=0.5, g_beta2=0.999)
CONFIGS = {"standalone_mean_provided2": ("paper_standalone", "mean_provided2"),
           "baseline_standalone_mean_adjusted": ("paper_baseline_standalone",
                                                 "mean_adjusted")}


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
    name, version = CONFIGS[request.param]
    return hemx_reference(name, tmp_path_factory.mktemp(request.param),
                          conditional=False, model_version=version,
                          checkpoint=name == "paper_standalone", **ADAM)


def test_train_call_matches_hemx(ref, tmp_path):
    ts = check_train_call(ref)
    assert set(ts.opt.state) == {"0", "1"}  # optax.adam's chain, one tree
    if ref["ckpt_dir"].exists():
        check_checkpoints_cross(ref, ts, tmp_path)


def test_inference_matches_hemx(ref):
    check_inference(ref)


def test_summaries_match_hemx(ref, tmp_path):
    got = check_summaries(ref, tmp_path)
    for prefix in ("metrics_y_hat/", "metrics_y_0/", "metrics_y_mean/"):
        assert any(k.startswith(prefix) for k in got), prefix


def test_rmse_loss_falls():
    """Four supervised steps on one batch lower the RMSE
    (tests/test_conditional.py::TestPaperFamily::test_paper_standalone)."""
    import numpy as np
    from hemx_torch.models.paper_family import PaperStandalone
    from tests.conftest import make_args
    args = make_args(model="paper_standalone", model_version="mean_provided",
                     **ADAM)
    model = PaperStandalone(args, "cpu")
    ts = model.init_state((3, 65, 65), 0)
    rng = np.random.default_rng(0)
    batch = {"image": torch.from_numpy(rng.random((2, 3, 65, 65),
                                                  dtype=np.float32)),
             "depth": torch.from_numpy(rng.random((2, 1, 65, 65),
                                                  dtype=np.float32))}
    losses = [float(model.train(ts, iter([batch]))[1]["rmse"])
              for _ in range(4)]
    assert losses[-1] < losses[0]
