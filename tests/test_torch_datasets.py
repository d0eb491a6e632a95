"""hemx_torch's data layer against hemx's, byte for byte and bit for bit.

* Example protos, TFRecord files and ``count_records`` equal hemx's; the
  port reads a hemx-written file; a truncated file raises.
* The PIL-free PNG decoder equals ``hemx.data.imageio`` (PIL) on
  PIL-written files of every supported colour type and on files written
  with each scanline filter, with PIL blocked around the port's call;
  unsupported PNGs raise, and JPEG without Pillow raises naming it.
* ``resize_bilinear`` equals PIL's bilinear resize (hemx's) on uint8 with 1
  and 3 channels and on float32, down and up, odd sizes.
* Each ported plugin (mnist, cifar with and without ``--cifar_resize``,
  floorplan, nyuv2 with every flag) converts the fake raw files of
  tests/test_data.py into the same record files as hemx's, and its splits
  give hemx's host batches for two epochs; ``to_grayscale`` /
  ``resize_images`` equal hemx's.
"""

import gzip
import io
import os
import pickle
import struct
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from PIL import Image  # noqa: E402

from chip_smoke import png_bytes  # noqa: E402
from tests.conftest import make_args  # noqa: E402


@pytest.fixture
def no_pil(monkeypatch):
    """``import PIL`` (and ``from PIL import Image``) fails while the
    fixture is active."""
    monkeypatch.setitem(sys.modules, "PIL", None)


def _pil_png(arr, mode=None, **save) -> bytes:
    buf = io.BytesIO()
    img = arr if isinstance(arr, Image.Image) else Image.fromarray(arr, mode)
    img.save(buf, format="PNG", **save)
    return buf.getvalue()


# --- protos and TFRecord ----------------------------------------------------

FEATURES = [("image", "bytes", [b"\x00\x01abc", b""]),
            ("label", "int64", [3, -7, 2 ** 40]),
            ("score", "float", [0.5, -1.25e-3])]


def _example(proto):
    make = {"bytes": proto.feature_bytes, "int64": proto.feature_int64,
            "float": proto.feature_float}
    return proto.example({n: make[k](v) for n, k, v in FEATURES})


def test_example_bytes_and_parse_match_hemx():
    from hemx.summaries import proto as H
    from hemx_torch.summaries import proto as T
    rec = _example(T)
    assert rec == _example(H)
    got = T.parse_example(rec)
    assert got == H.parse_example(rec)
    assert got["label"]["int64"] == [3, -7, 2 ** 40]
    assert got["image"]["bytes"] == [b"\x00\x01abc", b""]


def test_tfrecord_files_and_counts_match_hemx(tmp_path):
    from hemx.data import tfrecord as H
    from hemx_torch.data import tfrecord as T
    recs = [bytes(range(i)) * 3 for i in range(0, 200, 37)]
    for mod, name in ((H, "h"), (T, "t")):
        with mod.TFRecordWriter(str(tmp_path / name / "x.tfrecords")) as w:
            for r in recs:
                w.write(r)
    want = (tmp_path / "h" / "x.tfrecords").read_bytes()
    assert (tmp_path / "t" / "x.tfrecords").read_bytes() == want
    hemx_file = str(tmp_path / "h" / "x.tfrecords")
    assert T.read_all_records(hemx_file, verify=True) == recs
    assert list(T.tfrecord_iterator(hemx_file)) == recs
    assert T.count_records(hemx_file) == H.count_records(hemx_file) == len(recs)
    assert (tmp_path / "h" / "x.tfrecords.count").read_text() == str(len(recs))


def test_tfrecord_truncated_and_corrupt_raise(tmp_path):
    from hemx_torch.data import tfrecord as T
    path = tmp_path / "x.tfrecords"
    with T.TFRecordWriter(str(path)) as w:
        w.write(b"a" * 50)
        w.write(b"b" * 50)
    data = path.read_bytes()
    path.write_bytes(data[:-10])
    with pytest.raises(IOError, match="truncated"):
        T.read_all_records(str(path))
    with pytest.raises(IOError, match="truncated"):
        T.count_records(str(path))
    bad = bytearray(data)
    bad[20] ^= 1  # a byte of the first record
    path.write_bytes(bytes(bad))
    assert len(T.read_all_records(str(path))) == 2  # CRCs unread by default
    with pytest.raises(IOError, match="corrupt record crc"):
        T.read_all_records(str(path), verify=True)


# --- PNG decode -------------------------------------------------------------

def _smooth(rng, shape):
    """Image-like content, so PIL's adaptive filter choice varies by row."""
    a = rng.integers(0, 256, shape, dtype=np.uint8)
    return (np.cumsum(a, axis=1) // 9).astype(np.uint8)


def _pil_files():
    rng = np.random.default_rng(0)
    files = {}
    for mode, c in (("L", None), ("LA", 2), ("RGB", 3), ("RGBA", 4)):
        shape = (37, 41) if c is None else (37, 41, c)
        files[f"pil_{mode}"] = _pil_png(_smooth(rng, shape), mode)
        files[f"pil_{mode}_noise"] = _pil_png(
            rng.integers(0, 256, shape, dtype=np.uint8), mode)
    quant = Image.fromarray(_smooth(rng, (30, 33, 3))).quantize(colors=17)
    files["pil_P"] = _pil_png(quant)
    files["pil_P_trns"] = _pil_png(quant, transparency=3)
    return files


def _filter_files():
    rng = np.random.default_rng(1)
    files = {}
    for c in (1, 2, 3, 4):
        img = rng.integers(0, 256, (23, 19, c), dtype=np.uint8)
        for f in range(5):
            files[f"c{c}_filter{f}"] = png_bytes(img, [f] * 23)
        files[f"c{c}_mixed"] = png_bytes(img)
    return files


PNGS = {**_pil_files(), **_filter_files()}


@pytest.mark.parametrize("name", sorted(PNGS))
def test_decode_image_matches_hemx(name, monkeypatch):
    from hemx.data.imageio import decode_image as hemx_decode
    from hemx_torch.data.imageio import decode_image, image_shape
    data = PNGS[name]
    want = {c: hemx_decode(data, c) for c in (3, 1, 0)}
    monkeypatch.setitem(sys.modules, "PIL", None)
    for c, w in want.items():
        got = decode_image(data, c)
        assert got.dtype == w.dtype == np.uint8 and got.shape == w.shape, c
        np.testing.assert_array_equal(got, w, err_msg=f"channels={c}")
    assert image_shape(data) == want[3].shape


@pytest.mark.parametrize("filters", [None, [0] * 9, [1] * 9, [2] * 9,
                                     [3] * 9, [4] * 9])
def test_decode_png16_matches_hemx(filters, no_pil):
    from hemx_torch.data.imageio import decode_png16
    depth = np.random.default_rng(2).integers(0, 65536, (9, 13),
                                              dtype=np.uint16)
    got = decode_png16(png_bytes(depth, filters))
    assert got.dtype == np.uint16 and got.shape == (9, 13, 1)
    np.testing.assert_array_equal(got[:, :, 0], depth)


def test_decode_png16_of_pil_file_matches_hemx():
    from hemx.data.imageio import decode_png16 as hemx_decode16
    from hemx_torch.data.imageio import decode_png16
    depth = np.random.default_rng(3).integers(0, 65536, (17, 21),
                                              dtype=np.uint16)
    data = _pil_png(Image.fromarray(depth))
    np.testing.assert_array_equal(decode_png16(data), hemx_decode16(data))


def test_unsupported_pngs_raise(no_pil):
    from hemx_torch.data.imageio import decode_image, decode_png16
    rgb = png_bytes(np.zeros((4, 4, 3), np.uint8))
    interlaced = rgb[:28] + b"\x01" + rgb[29:]  # IHDR interlace byte
    with pytest.raises(ValueError, match="interlaced"):
        decode_image(interlaced)
    rgb16 = rgb[:24] + b"\x10" + rgb[25:]  # IHDR bit depth
    with pytest.raises(ValueError, match="bit depth 16"):
        decode_image(rgb16)
    with pytest.raises(ValueError, match="bit depth 16"):
        decode_image(png_bytes(np.zeros((4, 4), np.uint16)))
    with pytest.raises(ValueError, match="greyscale"):
        decode_png16(rgb)


def test_low_bit_depth_png_raises():
    from hemx_torch.data.imageio import decode_image
    bilevel = _pil_png(Image.new("1", (8, 8)))
    with pytest.raises(ValueError, match="bit depth 1"):
        decode_image(bilevel)


def test_jpeg_needs_pillow(no_pil):
    from hemx_torch.data.imageio import decode_image
    with pytest.raises(ImportError, match="Pillow"):
        decode_image(b"\xff\xd8\xff\xe0 not a png")


def test_jpeg_through_pil_matches_hemx():
    from hemx.data.imageio import decode_image as hemx_decode
    from hemx_torch.data.imageio import decode_image
    buf = io.BytesIO()
    Image.fromarray(_smooth(np.random.default_rng(4), (16, 24, 3))).save(
        buf, format="JPEG")
    np.testing.assert_array_equal(decode_image(buf.getvalue()),
                                  hemx_decode(buf.getvalue()))


# --- resize -----------------------------------------------------------------

RESIZES = [((100, 130), (64, 64)), ((427, 561), (64, 64)),
           ((218, 178), (64, 64)), ((32, 32), (64, 64)),
           ((50, 40), (37, 81)), ((50, 40), (50, 81)), ((7, 9), (7, 9)),
           ((120, 160), (48, 33))]


@pytest.mark.parametrize("src,dst", RESIZES)
@pytest.mark.parametrize("kind", ["u8_1", "u8_3", "f32_1", "f32_3"])
def test_resize_bilinear_matches_hemx(src, dst, kind, monkeypatch):
    from hemx.data.imageio import resize_bilinear as hemx_resize
    from hemx_torch.data.imageio import resize_bilinear
    rng = np.random.default_rng(5)
    c = int(kind[-1])
    if kind.startswith("u8"):
        img = rng.integers(0, 256, src + (c,), dtype=np.uint8)
    else:
        img = (rng.random(src + (c,)) * 3 - 1).astype(np.float32)
    want = hemx_resize(img, *dst)
    monkeypatch.setitem(sys.modules, "PIL", None)
    got = resize_bilinear(img, *dst)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


# --- plugins ----------------------------------------------------------------

def _assert_batches_equal(hemx_split, port_split, batch, epochs=2, seed=3):
    n = 0
    for e in range(epochs):
        want = list(hemx_split.iter_epoch(batch, seed=seed, epoch=e))
        got = list(port_split.iter_epoch(batch, seed=seed, epoch=e))
        assert len(got) == len(want) > 0
        for g, w in zip(got, want):
            assert sorted(g) == sorted(w)
            for k in w:
                assert g[k].dtype == w[k].dtype, k
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)
            n += 1
    return n


def _convert_both(hemx_cls, port_cls, raw, tmp_path):
    """Convert with both plugins; the record files must be equal."""
    out = {}
    for cls, side in ((hemx_cls, "hemx"), (port_cls, "port")):
        store = tmp_path / side
        assert cls.check_raw_datasets(str(raw))
        cls.convert_to_tfrecord(str(raw), str(store / cls.name))
        assert cls.check_prepared_datasets(str(store / cls.name))
        out[side] = store
    names = sorted(os.listdir(out["hemx"] / hemx_cls.name))
    assert names == sorted(os.listdir(out["port"] / port_cls.name))
    for name in names:
        assert ((out["port"] / port_cls.name / name).read_bytes()
                == (out["hemx"] / hemx_cls.name / name).read_bytes()), name
    return out


def _mnist_raw(raw, n=12):
    from hemx_torch.data.mnist import _FILES
    raw.mkdir()
    rng = np.random.default_rng(0)
    for img_f, lbl_f in _FILES.values():
        imgs = rng.integers(0, 256, (n, 28, 28), dtype=np.uint8)
        lbls = rng.integers(0, 10, n, dtype=np.uint8)
        with gzip.open(raw / img_f, "wb") as f:
            f.write(struct.pack(">IIII", 2051, n, 28, 28) + imgs.tobytes())
        with gzip.open(raw / lbl_f, "wb") as f:
            f.write(struct.pack(">II", 2049, n) + lbls.tobytes())


def test_mnist_matches_hemx(tmp_path):
    from hemx.data.mnist import MnistDataset as H
    from hemx_torch.data.mnist import MnistDataset as T
    from hemx_torch.data.pipeline import DeviceDataPipeline, U8Normalize
    _mnist_raw(tmp_path / "raw")
    stores = _convert_both(H, T, tmp_path / "raw", tmp_path)
    hs = H.get_datasets(make_args(dataset_dir=str(stores["hemx"])))
    ts = T.get_datasets(make_args(dataset_dir=str(stores["port"])))
    assert sorted(ts) == sorted(hs) == ["test", "train", "validate"]
    for name in hs:
        assert ts[name].device_transform == U8Normalize(keys=("image",))
        _assert_batches_equal(hs[name], ts[name], 4)
    # validate aliases test: one source, placed on the device once
    assert ts["validate"].source is ts["test"].source
    p_test = DeviceDataPipeline.maybe(ts["test"], 4, device="cpu",
                                      keys=("image",))
    p_val = DeviceDataPipeline.maybe(ts["validate"], 4, device="cpu",
                                     keys=("image",))
    assert p_test is not None and p_test.ds["image"] is p_val.ds["image"]


def _cifar_raw(raw):
    batches = raw / "cifar-10-batches-py"
    batches.mkdir(parents=True)
    rng = np.random.default_rng(0)
    for name in ["data_batch_1", "data_batch_2", "data_batch_3",
                 "data_batch_4", "data_batch_5", "test_batch"]:
        with open(batches / name, "wb") as f:
            pickle.dump({b"data": rng.integers(0, 256, (4, 3072),
                                               dtype=np.uint8)}, f)


@pytest.mark.parametrize("cifar_resize", [0, 48])
def test_cifar_matches_hemx(tmp_path, cifar_resize):
    from hemx.data.cifar import CifarDataset as H
    from hemx_torch.data.cifar import CifarDataset as T
    _cifar_raw(tmp_path / "raw")
    stores = _convert_both(H, T, tmp_path / "raw", tmp_path)
    hs = H.get_datasets(make_args(dataset_dir=str(stores["hemx"]),
                                  cifar_resize=cifar_resize))
    ts = T.get_datasets(make_args(dataset_dir=str(stores["port"]),
                                  cifar_resize=cifar_resize))
    for name in hs:
        assert (ts[name].batch_transform is None) == (cifar_resize == 0)
        _assert_batches_equal(hs[name], ts[name], 2)
    batch = next(ts["train"].iter_epoch(2))
    assert batch["image"].shape == (2,) + (cifar_resize or 32,) * 2 + (3,)
    assert batch["image"].dtype == np.uint8


def _floorplan_raw(raw):
    """PIL-written PNGs (adaptive filters) and PNGs with all five filters,
    of several sizes and colour types."""
    raw.mkdir()
    rng = np.random.default_rng(0)
    files = {"train_set.txt": ["a.png", "b.png", "c.png", "d.png"],
             "validation_set.txt": ["e.png", "f.png"],
             "test_set.txt": ["g.png", "h.png"]}
    for i, name in enumerate(sum(files.values(), [])):
        shape = [(100, 120, 3), (64, 64, 3), (50, 90, 1), (80, 70, 4)][i % 4]
        img = _smooth(rng, shape)
        data = (_pil_png(img[..., 0] if shape[2] == 1 else img) if i % 2
                else png_bytes(img))
        (raw / name).write_bytes(data)
    for list_file, names in files.items():
        (raw / list_file).write_text("\n".join(names) + "\n")


def test_floorplan_matches_hemx(tmp_path):
    from hemx.data.floorplan import FloorplanDataset as H
    from hemx_torch.data.floorplan import FloorplanDataset as T
    _floorplan_raw(tmp_path / "raw")
    stores = _convert_both(H, T, tmp_path / "raw", tmp_path)
    hs = H.get_datasets(make_args(dataset_dir=str(stores["hemx"])))
    ts = T.get_datasets(make_args(dataset_dir=str(stores["port"])))
    for name in hs:
        assert ts[name].batch_transform is None
        _assert_batches_equal(hs[name], ts[name], 2)
    assert next(ts["train"].iter_epoch(2))["image"].shape == (2, 64, 64, 3)
    assert ts["train"].source.materialize_s > 0


def _nyuv2_raw(raw, n_per_split=4):
    """tests/test_data.py::TestNyuv2's fake frames (PIL 16-bit depth), one
    frame per split with a sensor gap."""
    raw.mkdir()
    rng = np.random.default_rng(0)
    for split_file, prefix in [("train.txt", "tr"), ("validation.txt", "va"),
                               ("test.txt", "te")]:
        frames = [f"{prefix}{i}" for i in range(n_per_split)]
        (raw / split_file).write_text("\n".join(frames) + "\n")
        for i, fr in enumerate(frames):
            img = rng.integers(0, 256, (30, 40, 3), dtype=np.uint8)
            depth = rng.integers(1000, 60000, (30, 40), dtype=np.uint16)
            if i == 0:
                depth[0, 0] = 0 if prefix != "va" else 65535
            (raw / f"{fr}_i.png").write_bytes(png_bytes(img))
            (raw / f"{fr}_f.png").write_bytes(_pil_png(Image.fromarray(depth)))


NYU_FLAGS = [dict(),
             dict(random_crop=[17, 23], include_location=True,
                  normalize=True, include_originals=[12, 16]),
             dict(resize=[24, 32], random_crop=[16, 16], normalize=True)]


@pytest.mark.parametrize("flags", NYU_FLAGS)
def test_nyuv2_matches_hemx(tmp_path, flags):
    from hemx.data.nyuv2 import NYUv2Dataset as H
    from hemx_torch.data.nyuv2 import NYUv2Dataset as T
    _nyuv2_raw(tmp_path / "raw")
    stores = _convert_both(H, T, tmp_path / "raw", tmp_path)
    full = {**dict(resize=None, random_crop=None, include_location=False,
                   skip_invalid=False, normalize=False,
                   include_originals=None), **flags}
    hs = H.get_datasets(make_args(dataset_dir=str(stores["hemx"]), **full))
    ts = T.get_datasets(make_args(dataset_dir=str(stores["port"]), **full))
    for name in hs:
        # the gap frame is gone; a --resize at parse time blends its one
        # gap pixel away, in hemx as here
        assert ts[name].count == hs[name].count == (4 if "resize" in flags
                                                    else 3)
        assert ts[name].transform_needs_rng
        _assert_batches_equal(hs[name], ts[name], 3, epochs=2)
    batch = next(ts["train"].iter_epoch(3))
    want = {"image", "depth"}
    if flags.get("include_location"):
        want |= {"x_loc", "y_loc"}
    if flags.get("normalize"):
        want.add("mean")
    if flags.get("include_originals"):
        want |= {"x_full", "y_full"}
    assert set(batch) == want
    crop = flags.get("random_crop") or flags.get("resize") or [30, 40]
    assert batch["image"].shape == (3, *crop, 3)
    assert all(v.dtype == np.float32 for v in batch.values())


@pytest.mark.parametrize("op", ["grayscale", "resize"])
def test_split_conversions_match_hemx(tmp_path, op):
    """--grayscale / --resize on floorplan's record-backed splits (uint8)
    and on float arrays, memoized per source like hemx's."""
    from hemx.data import pipeline as HP
    from hemx.data.floorplan import FloorplanDataset as H
    from hemx_torch.data import pipeline as TP
    from hemx_torch.data.floorplan import FloorplanDataset as T
    _floorplan_raw(tmp_path / "raw")
    stores = _convert_both(H, T, tmp_path / "raw", tmp_path)
    hs = H.get_datasets(make_args(dataset_dir=str(stores["hemx"])))
    ts = T.get_datasets(make_args(dataset_dir=str(stores["port"])))
    floats = np.random.default_rng(6).random((3, 9, 11, 3)).astype(np.float32)
    hs["float"] = HP.Split(HP.ArraySource({"image": floats}))
    ts["float"] = TP.Split(TP.ArraySource({"image": floats}))
    for name in hs:
        if op == "grayscale":
            h, t = HP.to_grayscale(hs[name]), TP.to_grayscale(ts[name])
        else:
            h = HP.resize_images(hs[name], (20, 27))
            t = TP.resize_images(ts[name], (20, 27))
        want, got = h.source.arrays["image"], t.source.arrays["image"]
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
    shared = TP.ArraySource({"image": floats})
    a, b = TP.Split(shared), TP.Split(shared)
    conv = TP.to_grayscale if op == "grayscale" else (
        lambda s: TP.resize_images(s, (5, 5)))
    assert conv(a).source is conv(b).source


# --- registry ---------------------------------------------------------------

def test_registry_lists_the_ported_datasets():
    """The port's datasets are hemx's, each under its own name."""
    from hemx.data.plugin import available_datasets as hemx_datasets
    from hemx_torch.data import plugin
    assert plugin.available_datasets() == hemx_datasets()
    assert {"celeb", "coco"} <= set(plugin.available_datasets())
    for name in plugin.available_datasets():
        assert plugin.get_dataset(name).name == name
    with pytest.raises(ValueError, match="available"):
        plugin.get_dataset_tensors(make_args(dataset="nope"))


def test_get_dataset_tensors_converts_then_resizes_and_greys(tmp_path):
    from hemx.data.plugin import get_dataset_tensors as hemx_tensors
    from hemx_torch.data.plugin import get_dataset_tensors
    _mnist_raw(tmp_path / "raw")
    kw = dict(dataset="mnist", raw_dataset_dir=str(tmp_path / "raw"),
              resize=[14, 12], grayscale=True)
    hs = hemx_tensors(make_args(dataset_dir=str(tmp_path / "h"), **kw))
    ts = get_dataset_tensors(make_args(dataset_dir=str(tmp_path / "t"), **kw))
    for name in hs:
        got, want = ts[name].source.arrays["image"], hs[name].source.arrays["image"]
        assert got.shape[1:] == (14, 12, 1)
        np.testing.assert_array_equal(got, want)
    assert ts["validate"].source is ts["test"].source
