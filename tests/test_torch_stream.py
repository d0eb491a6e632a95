"""hemx_torch's streaming Pipeline and the loop's streaming path, on the CPU.

* The streaming ``Pipeline`` yields ``DeviceDataPipeline``'s batches and
  hemx's ``Pipeline``'s (per batch and grouped by
  ``make_group_place_stages``) bit for bit, in order, epoch tail included;
  a split with a host transform and its rng (NYUv2 crops, float keys)
  equals hemx's too.
* A worker exception reaches the consumer; a consumer that stops early
  releases the worker; concurrent epochs under a short switch interval
  stay equal.
* Training: a tiny IWGAN run streaming groups of 6 equals the same run on
  the device cache (checkpoints byte for byte); the CNN trains through
  ``cli.run --dataset mnist --no-device_data_cache`` and on NYUv2 crops,
  its input shape and summary batch taken from the first host batch.
"""

import math
import sys
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from tests.conftest import make_args  # noqa: E402
from tests.test_torch_datasets import _mnist_raw, _nyuv2_raw  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _hemx_float32():
    """hemx's compute dtype and precision are process-wide: compare against,
    and leave behind, hemx's float32 defaults."""
    from hemx.ops import layers
    layers.set_compute_dtype(None)
    layers.set_default_precision("default")
    yield
    layers.set_compute_dtype(None)
    layers.set_default_precision("default")


def _synthetic(count=112, u8=True):
    from hemx.data.synthetic import SyntheticDataset as HD
    from hemx_torch.data.synthetic import SyntheticDataset as TD
    args = make_args(synthetic_count=count, synthetic_shape=[8, 8, 3],
                     synthetic_u8=u8)
    return HD.get_datasets(args)["train"], TD.get_datasets(args)["train"]


@pytest.mark.parametrize("group", [1, 3])
@pytest.mark.parametrize("u8", [True, False])
def test_stream_matches_device_cache(group, u8):
    """112 rows, batch 16: 7 batches per epoch; with group 3, two groups
    and a tail group of one batch."""
    from hemx_torch.data.pipeline import DeviceDataPipeline, Pipeline
    _, split = _synthetic(u8=u8)
    cached = DeviceDataPipeline(split, 16, device="cpu", keys=("image",),
                                seed=9, group=group)
    stream = Pipeline(split, 16, device="cpu", keys=("image",), seed=9,
                      group=group)
    for e in range(2):
        want, got = list(cached.epoch(e)), list(stream.epoch(e))
        assert len(got) == len(want) == 7
        for g, w in zip(got, want):
            assert g["image"].dtype == w["image"].dtype == torch.float32
            assert g["image"].stride() == w["image"].stride()
            assert torch.equal(g["image"], w["image"])


@pytest.mark.parametrize("group", [1, 3])
def test_stream_matches_hemx_pipeline(group):
    from hemx.data.pipeline import (Pipeline as HP, make_group_place_stages,
                                    make_place_stages)
    from hemx.parallel.mesh import make_mesh
    from hemx_torch.data.pipeline import Pipeline
    hsplit, split = _synthetic()
    mesh = make_mesh(1)
    stages = (make_group_place_stages if group > 1 else make_place_stages)(
        mesh, hsplit, keys=("image",))
    hemx_pipe = HP(hsplit, 16, seed=4, place=stages[0], post=stages[1],
                   group=group)
    pipe = Pipeline(split, 16, device="cpu", keys=("image",), seed=4,
                    group=group)
    for e in range(2):
        want = [np.asarray(jax.device_get(b["image"]))
                for b in hemx_pipe.epoch(e)]
        got = [b["image"].permute(0, 2, 3, 1).numpy() for b in pipe.epoch(e)]
        assert len(got) == len(want) == 7
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


def test_stream_with_host_transform_matches_hemx(tmp_path):
    """NYUv2 with crops, location maps, mean and originals: every float key
    equals hemx's streamed batch, permuted to (B, C, H, W)."""
    from hemx.data.nyuv2 import NYUv2Dataset as H
    from hemx.data.pipeline import Pipeline as HP, make_group_place_stages
    from hemx.parallel.mesh import make_mesh
    from hemx_torch.data.nyuv2 import NYUv2Dataset as T
    from hemx_torch.data.pipeline import DeviceDataPipeline, Pipeline
    _nyuv2_raw(tmp_path / "raw", n_per_split=9)
    for cls in (H, T):
        cls.convert_to_tfrecord(str(tmp_path / "raw"),
                                str(tmp_path / "store" / cls.name))
    args = make_args(dataset_dir=str(tmp_path / "store"), resize=None,
                     random_crop=[17, 23], include_location=True,
                     skip_invalid=False, normalize=True,
                     include_originals=[12, 16])
    hsplit, split = H.get_datasets(args)["train"], T.get_datasets(args)["train"]
    assert DeviceDataPipeline.maybe(split, 2, device="cpu") is None
    t, f = make_group_place_stages(make_mesh(1), hsplit)
    hemx_pipe = HP(hsplit, 2, seed=7, place=t, post=f, group=3)
    pipe = Pipeline(split, 2, device="cpu", seed=7, group=3)
    for e in range(2):
        want = list(hemx_pipe.epoch(e))
        got = list(pipe.epoch(e))
        assert len(got) == len(want) == 4  # 8 frames: a group and a tail
        for g, w in zip(got, want):
            assert sorted(g) == sorted(w) == sorted(
                ["image", "depth", "x_loc", "y_loc", "mean", "x_full",
                 "y_full"])
            for k in w:
                np.testing.assert_array_equal(
                    g[k].permute(0, 2, 3, 1).numpy(),
                    np.asarray(jax.device_get(w[k])), err_msg=k)


def _raising_split(fail_at: int):
    from hemx_torch.data.pipeline import ArraySource, Split

    def transform(batch, rng):
        if rng.integers(0, 1 << 30) and transform.calls == fail_at:
            raise RuntimeError("boom in the host transform")
        transform.calls += 1
        return batch
    transform.calls = 0
    src = ArraySource({"image": np.zeros((40, 2, 2, 1), np.float32)})
    return Split(src, batch_transform=transform, transform_needs_rng=True)


def _pipeline_threads():
    return [t for t in threading.enumerate()
            if t.name.startswith("hemx_torch-pipeline")]


def test_worker_exception_reaches_consumer():
    from hemx_torch.data.pipeline import Pipeline
    pipe = Pipeline(_raising_split(fail_at=3), 4, device="cpu", group=2)
    got = []
    with pytest.raises(RuntimeError, match="boom"):
        for b in pipe.epoch(0):
            got.append(b)
    assert len(got) == 2  # the first group; the second never assembled
    assert not _pipeline_threads()


def test_early_stop_releases_the_worker():
    from hemx_torch.data.pipeline import Pipeline
    _, split = _synthetic(count=400)
    pipe = Pipeline(split, 4, device="cpu", keys=("image",), depth=1)
    it = pipe.epoch(0)
    next(it)
    it.close()
    assert not _pipeline_threads()


def test_concurrent_epochs_stay_equal():
    """Twelve consumers, each streaming its own epoch, with a short switch
    interval: every batch equals the cached pipeline's."""
    from hemx_torch.data.pipeline import DeviceDataPipeline, Pipeline
    _, split = _synthetic(count=96)
    want = {e: [b["image"] for b in DeviceDataPipeline(
        split, 8, device="cpu", keys=("image",), seed=2, group=2).epoch(e)]
        for e in range(12)}
    errors = []

    def consume(e):
        try:
            pipe = Pipeline(split, 8, device="cpu", keys=("image",), seed=2,
                            group=2)
            got = [b["image"] for b in pipe.epoch(e)]
            assert len(got) == len(want[e])
            assert all(torch.equal(g, w) for g, w in zip(got, want[e]))
        except Exception as exc:
            errors.append(exc)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=consume, args=(e,))
                   for e in range(12)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert not errors, errors


IWGAN = ["--model", "iwgan", "--dataset", "synthetic", "--synthetic_u8",
         "--synthetic_count", "64", "--synthetic_eval_count", "16",
         "--synthetic_shape", "32", "32", "3", "--batch_size", "8",
         "--latent_size", "16", "--n_disc_train", "5", "--optimizer", "adam",
         "--lr", "1e-4", "--beta1", "0.5", "--beta2", "0.9", "--epochs", "1",
         "--epoch_size", "3", "--device", "cpu", "--seed", "3"]


def test_streamed_iwgan_equals_cached(tmp_path):
    """8 batches per data epoch in groups of 6: three calls read 18
    batches, across two epoch tails. Same losses, same checkpoints."""
    from hemx_torch import cli
    from hemx_torch.data.pipeline import DeviceDataPipeline, Pipeline
    cached = cli.run(IWGAN + ["--dir", str(tmp_path / "cached")])
    stream = cli.run(IWGAN + ["--dir", str(tmp_path / "stream"),
                              "--no-device_data_cache"])
    assert isinstance(cached["pipeline"], DeviceDataPipeline)
    assert isinstance(stream["pipeline"], Pipeline)
    assert stream["pipeline"].group == 6
    assert stream["train_state"].step == 3
    strip = [{k: v for k, v in h.items() if k != "seconds"}
             for h in cached["history"]]
    assert strip == [{k: v for k, v in h.items() if k != "seconds"}
                     for h in stream["history"]]
    for name in ("checkpoint-0.msgpack", "checkpoint-1.msgpack"):
        assert ((tmp_path / "cached" / name).read_bytes()
                == (tmp_path / "stream" / name).read_bytes()), name


def test_cnn_streams_mnist_through_the_cli(tmp_path):
    from hemx_torch import cli
    from hemx_torch.data.pipeline import Pipeline
    from hemx_torch.summaries.reader import get_tag_values
    _mnist_raw(tmp_path / "raw", n=24)
    res = cli.run(["--dataset", "mnist", "--raw_dataset_dir",
                   str(tmp_path / "raw"), "--dataset_dir",
                   str(tmp_path / "store"), "--batch_size", "8",
                   "--latent_size", "8", "--epochs", "1", "--device", "cpu",
                   "--no-device_data_cache", "--dir", str(tmp_path / "ws"),
                   "--seed", "1"])
    assert isinstance(res["pipeline"], Pipeline)
    assert res["train_state"].step == 3
    assert all(math.isfinite(h["loss"]) for h in res["history"])
    assert res["timings"]["materialize_s"] > 0
    val = get_tag_values(str(tmp_path / "ws" / "validate"), "losses/loss")
    assert [s for s, _ in val] == [3] and math.isfinite(val[0][1])


def test_cnn_trains_on_nyuv2_crops(tmp_path):
    """The split streams (host transform); the model's input shape is the
    crop's, and the first streamed batch is the first host batch of the
    epoch's order."""
    from hemx_torch import cli
    from hemx_torch.data.nyuv2 import NYUv2Dataset
    _nyuv2_raw(tmp_path / "raw", n_per_split=9)
    argv = ["--dataset", "nyuv2", "--raw_dataset_dir", str(tmp_path / "raw"),
            "--dataset_dir", str(tmp_path / "store"), "--random_crop", "16",
            "16", "--batch_size", "4", "--latent_size", "8", "--epochs", "1",
            "--device", "cpu", "--dir", str(tmp_path / "ws"), "--seed", "5"]
    res = cli.run(argv)
    assert res["train_state"].step == 2
    assert all(math.isfinite(h["loss"]) for h in res["history"])
    # (a model built for the stored 30x40 frames could not take the crops)
    args = res["args"]
    host = next(NYUv2Dataset.get_datasets(args)["train"].iter_epoch(
        4, seed=args.seed, epoch=0))
    first = next(res["pipeline"].epoch(0))
    assert set(first) == {"image"}
    assert first["image"].shape == (4, 3, 16, 16)
    np.testing.assert_array_equal(first["image"].permute(0, 2, 3, 1).numpy(),
                                  host["image"])
