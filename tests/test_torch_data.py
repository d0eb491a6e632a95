"""hemx_torch's data path against hemx's: the numpy copies of the synthetic
image generator, its uint8 rounding and the epoch shuffle must equal the
originals exactly, and the device-resident pipeline (on the CPU, the
kernel's plain path) must yield hemx DeviceDataPipeline's batches bit for
bit, in order, epoch tail included (mirrors
tests/test_data.py::TestDeviceDataPipeline).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from tests.conftest import make_args  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _hemx_float32():
    """hemx's compute dtype and precision are process-wide, and bench.main()
    in an earlier test of this worker may have left them at bfloat16:
    compare against, and leave behind, hemx's float32 defaults."""
    from hemx.ops import layers
    layers.set_compute_dtype(None)
    layers.set_default_precision("default")


@pytest.mark.parametrize("n,h,w,c,seed", [(5, 16, 16, 3, 0),
                                          (3, 8, 12, 1, 7)])
def test_make_images_and_u8_rounding_match_hemx(n, h, w, c, seed):
    from hemx.data import synthetic as H
    from hemx_torch.data import synthetic as T
    want = H._make_images(n, h, w, c, seed, chunk=2)
    got = T._make_images(n, h, w, c, seed, chunk=2)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(T.to_u8(got),
                                  np.round(want * 255.0).astype(np.uint8))


@pytest.mark.parametrize("u8", [False, True])
def test_synthetic_train_split_matches_hemx(u8):
    """Every split (train, validate, test, seeded seed, seed+1, seed+2, the
    eval splits sized by --synthetic_eval_count) equals hemx's, key by key
    (image, depth, x_loc, y_loc, mean), in value, dtype and shape, and the
    uint8 transform covers image and depth."""
    from hemx.data.synthetic import SyntheticDataset as H
    from hemx_torch.data.synthetic import SyntheticDataset as T
    args = make_args(synthetic_count=12, synthetic_shape=[8, 8, 3],
                     synthetic_u8=u8, synthetic_eval_count=5)
    want_splits, got_splits = H.get_datasets(args), T.get_datasets(args)
    assert sorted(got_splits) == ["test", "train", "validate"]
    for name in ("train", "validate", "test"):
        want, got = want_splits[name], got_splits[name]
        assert got.count == want.count == (12 if name == "train" else 5)
        assert sorted(got.source.arrays) == sorted(want.source.arrays) == [
            "depth", "image", "mean", "x_loc", "y_loc"]
        for k, w in want.source.arrays.items():
            g = got.source.arrays[k]
            assert g.dtype == w.dtype and g.shape == w.shape, k
            np.testing.assert_array_equal(g, w, err_msg=k)
        assert (got.device_transform is not None) == u8
        if u8:
            assert got.device_transform.keys == ("image", "depth")


@pytest.mark.parametrize("shuffle", [True, False])
def test_epoch_indices_match_hemx(shuffle):
    from hemx.data.pipeline import ArraySource as HA, Split as HS
    from hemx_torch.data.pipeline import ArraySource as TA, Split as TS
    arrays = {"image": np.zeros((50, 2), np.float32)}
    h, t = HS(HA(arrays)), TS(TA(arrays))
    for epoch in range(3):
        want = list(h.iter_epoch_indices(8, shuffle=shuffle, seed=5,
                                         epoch=epoch))
        got = list(t.iter_epoch_indices(8, shuffle=shuffle, seed=5,
                                        epoch=epoch))
        assert len(got) == len(want) == 6
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("u8", [True, False])
def test_device_pipeline_matches_hemx(u8):
    """2 epochs of 7 batches with group=3: two grouped gathers and one
    per-batch tail batch per epoch, bit-equal to hemx's, for every key of
    the synthetic split (the uint8 image and depth through the kernel's
    plain version, the float keys gathered as they are)."""
    from hemx.data.pipeline import DeviceDataPipeline as HP
    from hemx.data.synthetic import SyntheticDataset as HD
    from hemx.parallel.mesh import make_mesh
    from hemx_torch.data.pipeline import DeviceDataPipeline as TP
    from hemx_torch.data.synthetic import SyntheticDataset as TD
    args = make_args(synthetic_count=112, synthetic_shape=[8, 8, 3],
                     synthetic_u8=u8)
    gb = 16
    hp = HP.maybe(HD.get_datasets(args)["train"], gb, mesh=make_mesh(0),
                  keys=None, shuffle=True, seed=9, group=3)
    tp = TP.maybe(TD.get_datasets(args)["train"], gb, device="cpu",
                  keys=None, shuffle=True, seed=9, group=3)
    assert hp is not None and tp is not None
    for e in range(2):
        want = [jax.device_get(b) for b in hp.epoch(e)]
        got = list(tp.epoch(e))
        assert len(got) == len(want) == 7
        for g, w in zip(got, want):
            assert sorted(g) == sorted(w) == ["depth", "image", "mean",
                                              "x_loc", "y_loc"]
            for k in w:
                assert g[k].dtype == torch.float32, k
                assert g[k].is_contiguous(memory_format=torch.channels_last), k
                np.testing.assert_array_equal(
                    g[k].permute(0, 2, 3, 1).numpy(), np.asarray(w[k]),
                    err_msg=k)


def test_device_pipeline_budget():
    from hemx_torch.data.pipeline import DeviceDataPipeline as TP
    from hemx_torch.data.synthetic import SyntheticDataset as TD
    split = TD.get_datasets(make_args(synthetic_count=8,
                                      synthetic_shape=[8, 8, 3]))["train"]
    assert TP.maybe(split, 4, device="cpu", budget_mb=0) is None
    assert TP.maybe(split, 4, device="cpu", budget_mb=1) is not None
