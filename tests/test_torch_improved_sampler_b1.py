"""improved_sampler B1/B1 at 66 px against hemx: the checks of
tests/test_torch_improved_sampler.py but the summaries (B1's diagnostic
paths run A1's code, held there): one train call, inference, metrics,
target crop and capture.
"""

import pytest

torch = pytest.importorskip("torch")

from tests.test_torch_improved_sampler import (  # noqa: E402,F401
    _hemx_float32, _two_torch_threads, reference,
    test_inference_matches_hemx, test_metrics_targets_and_capture,
    test_train_call_matches_hemx)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    return reference("B1", tmp_path_factory, summaries=False)
