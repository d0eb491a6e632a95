"""sampler_gan of hemx_torch held against hemx.models.sampler_gan, with the
machinery and tolerances of tests/test_torch_paper_cgan.py: the large
generator with BN and the late critic with BN (one D step), and the small
generator with the early critic with BN (two D steps), on hemx's optimizer
switch at its default (rmsprop, TF parity). Batch 4, and 8 for the late
critic, which runs BN on four 1x1 maps: over 4 rows its float32 gradient
norm already differs between hemx and the port by 4e-3 (rounding, as the
float64 net tests of tests/test_torch_depth_nets.py show).
"""

import pytest

torch = pytest.importorskip("torch")

from tests.test_torch_paper_cgan import (  # noqa: E402,F401
    _two_torch_threads, check_inference, check_summaries, check_train_call,
    hemx_reference)

CONFIGS = {
    "large_late_bn": dict(garch="large", darch="late", batch_norm_gen=True,
                          batch_norm_disc=True, n_disc_train=1, batch=8),
    "small_early_bn_disc": dict(garch="small", darch="early",
                                batch_norm_gen=False, batch_norm_disc=True,
                                n_disc_train=2),
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
    flags = dict(CONFIGS[request.param])
    batch = flags.pop("batch", 4)
    return hemx_reference("sampler_gan", tmp_path_factory.mktemp(request.param),
                          batch=batch, **flags)


def test_train_call_matches_hemx(ref):
    assert ref["n"] == ref["args"].n_disc_train + 1
    check_train_call(ref)


def test_inference_matches_hemx(ref):
    check_inference(ref)


def test_summaries_match_hemx(ref, tmp_path):
    got = check_summaries(ref, tmp_path)
    assert {"sampler/sample_variance", "sampler/mean_sample_l2",
            "sampler/min_sample_l2"} <= set(got)


def test_depth_is_center_cropped_to_31(ref):
    _, prep = ref["predict"]
    assert prep["y"].shape[1:] == (31, 31, 1)
