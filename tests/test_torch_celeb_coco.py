"""The celeb and coco plugins of hemx_torch against hemx's.

Raw trees are written here: CelebA's 178x218 JPEGs (encoded with Pillow)
in the jpg, png and flat directories hemx looks in, with partition codes
0/1/2 and the 40-attribute list; COCO's JPEGs of mixed sizes with polygon
(one of two points, which is skipped), uncompressed-RLE and compressed-RLE
annotations (strings whose deltas go negative), an image the json names
but the directory lacks, and a test split with no images.

* Both packages' converters write byte-identical record files.
* ``parse_example`` gives hemx's arrays exactly (the port resizes with its
  Pillow-exact bilinear, hemx with Pillow; masks by nearest neighbour).
* ``ann_to_mask`` equals hemx's for every annotation kind, and a
  compressed string decodes to its runs' mask.
* A split with no records raises hemx's error in both.
* One IWGAN call on the celeb records, batches from each package's device
  cache (the port's gather+normalize, its plain version here) and hemx's
  noise through the seam, equals hemx's: losses rtol 5e-4 / atol 1e-5,
  parameters and BN statistics rtol 2e-3 / atol 2e-5
  (``tests/test_torch_iwgan.py``'s tolerances).
* The coco CNN's batches carry ``annotations`` as uint8 category ids
  through the port's cache; pix2pix on coco fails as hemx's does, on the
  ``depth`` key coco does not have.
"""

import io
import json
import os
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from PIL import Image  # noqa: E402

import jax  # noqa: E402

from tests.conftest import make_args  # noqa: E402
from tests.test_torch_iwgan import _jax_noise  # noqa: E402
from tests.test_torch_paper_cgan import _hemx_float32, xla_opt0  # noqa: E402,F401

REPO = Path(__file__).resolve().parents[1]
B, LATENT = 4, 16


def jpeg(arr, quality=90) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="JPEG", quality=quality)
    return buf.getvalue()


def png(arr) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="PNG")
    return buf.getvalue()


def write_celeb_raw(raw, n: int = 18, seed: int = 0) -> None:
    """``n`` aligned faces: every third a PNG in ``img_align_celeba_png``,
    the others JPEGs, half of them in ``img_align_celeba_jpg`` and half in
    the flat ``img_align_celeba``."""
    rng = np.random.default_rng(seed)
    dirs = {d: raw / d for d in ("img_align_celeba_png",
                                 "img_align_celeba_jpg", "img_align_celeba")}
    for d in dirs.values():
        d.mkdir(parents=True, exist_ok=True)
    names = []
    for i in range(1, n + 1):
        img = rng.integers(0, 256, (218, 178, 3), dtype=np.uint8)
        if i % 3 == 0:
            name = f"{i:06d}.png"
            (dirs["img_align_celeba_png"] / name).write_bytes(png(img))
        else:
            name = f"{i:06d}.jpg"
            where = "img_align_celeba_jpg" if i % 2 else "img_align_celeba"
            (dirs[where] / name).write_bytes(jpeg(img))
        names.append(name)
    with open(raw / "list_eval_partition.txt", "w") as f:
        for i, name in enumerate(names):
            f.write(f"{name} {0 if i < n - 4 else 1 + i % 2}\n")
    with open(raw / "list_attr_celeba.txt", "w") as f:
        f.write(f"{n}\n" + " ".join(
            ["5_o_Clock_Shadow", "Arched_Eyebrows"] + ["..."] * 38) + "\n")
        for name in names:
            attrs = " ".join(str(v) for v in rng.choice([-1, 1], 40))
            f.write(f"{name} {attrs}\n")


def rle_string(counts) -> str:
    """COCO's compressed RLE of ``counts`` (pycocotools' ``rleToString``:
    from the fourth run on, the difference from the run two before,
    5-bit groups with a continuation bit, '0'-based)."""
    out = []
    for i, x in enumerate(counts):
        if i > 2:
            x -= counts[i - 2]
        more = True
        while more:
            c = x & 0x1F
            x >>= 5
            more = x != -1 if c & 0x10 else x != 0
            out.append(chr((c | 0x20 if more else c) + 48))
    return "".join(out)


# runs of a 20x24 mask whose deltas go negative (12 after 40, 3 after 30)
RUNS = [5, 40, 30, 12, 3, 100, 8, 282]


def coco_annotations(image_id: int, h: int, w: int) -> list:
    return [
        {"segmentation": [[2.0, 2.0, w - 3.0, 3.0, w / 2, h - 2.0],
                          [1.0, 1.0, 4.0, 4.0]],  # 2 points: skipped
         "bbox": [2, 2, w - 5, h - 4], "iscrowd": 0, "area": 99.5,
         "category_id": 7, "image_id": image_id, "id": 3 * image_id},
        {"segmentation": {"counts": [h * 2 + 1, h - 2, h * w - 3 * h + 1],
                          "size": [h, w]},
         "bbox": [2, 1, 1, h - 2], "iscrowd": 1, "area": float(h - 2),
         "category_id": 3, "image_id": image_id, "id": 3 * image_id + 1},
        {"segmentation": {"counts": rle_string(
            [7, 9, h * w - 16]), "size": [h, w]},
         "bbox": [0, 7, 1, 9], "iscrowd": 1, "area": 9.0,
         "category_id": 90, "image_id": image_id, "id": 3 * image_id + 2},
    ]


def write_coco_raw(raw, n_train: int = 10, n_val: int = 4,
                   seed: int = 0) -> None:
    rng = np.random.default_rng(seed)
    (raw / "annotations").mkdir(parents=True, exist_ok=True)
    for d in ("train2014", "val2014", "test2014"):
        (raw / d).mkdir(exist_ok=True)
    sizes = [(48, 64), (70, 50), (33, 41)]
    for split, d, n, ann in (("train", "train2014", n_train,
                              "instances_train2014.json"),
                             ("val", "val2014", n_val,
                              "instances_val2014.json")):
        images, anns = [], []
        for i in range(n):
            image_id = 1000 * (split == "val") + i
            h, w = sizes[i % len(sizes)]
            name = f"COCO_{d}_{image_id:012d}.jpg"
            if i != 1:  # named in the json, missing on disk: skipped
                (raw / d / name).write_bytes(jpeg(rng.integers(
                    0, 256, (h, w, 3), dtype=np.uint8)))
            images.append({"id": image_id, "file_name": name,
                           "height": h, "width": w})
            if i % 4 != 3:  # some images have no annotation
                anns += coco_annotations(image_id, h, w)
        with open(raw / "annotations" / ann, "w") as f:
            json.dump({"images": images, "annotations": anns,
                       "categories": [{"id": c, "name": str(c)}
                                      for c in (3, 7, 90)]}, f)
    with open(raw / "annotations" / "image_info_test2014.json", "w") as f:
        json.dump({"images": [], "annotations": []}, f)


def _convert_both(hemx_cls, port_cls, raw, tmp):
    hemx_cls.convert_to_tfrecord(str(raw), str(tmp / "hemx"))
    port_cls.convert_to_tfrecord(str(raw), str(tmp / "port"))
    files = sorted(os.listdir(tmp / "hemx"))
    assert files == sorted(os.listdir(tmp / "port")) and len(files) == 3
    for name in files:
        assert ((tmp / "port" / name).read_bytes()
                == (tmp / "hemx" / name).read_bytes()), name
    return files


@pytest.fixture(scope="module")
def celeb(tmp_path_factory):
    from hemx.data.celeb import CelebDataset as H
    from hemx_torch.data.celeb import CelebDataset as P
    tmp = tmp_path_factory.mktemp("celeb")
    write_celeb_raw(tmp / "raw")
    assert P.check_raw_datasets(str(tmp / "raw")) is True
    assert P.check_prepared_datasets(str(tmp / "port")) is False
    files = _convert_both(H, P, tmp / "raw", tmp)
    assert P.check_prepared_datasets(str(tmp / "port")) is True
    return tmp, files


@pytest.fixture(scope="module")
def coco(tmp_path_factory):
    from hemx.data.coco import COCODataset as H
    from hemx_torch.data.coco import COCODataset as P
    tmp = tmp_path_factory.mktemp("coco")
    write_coco_raw(tmp / "raw")
    assert P.check_raw_datasets(str(tmp / "raw")) is True
    files = _convert_both(H, P, tmp / "raw", tmp)
    return tmp, files


def test_celeb_records_are_hemx_records(celeb):
    from hemx_torch.data.tfrecord import count_records
    tmp, files = celeb
    counts = {f: count_records(str(tmp / "port" / f)) for f in files}
    assert counts == {"celeba.train.tfrecords": 14,
                      "celeba.validate.tfrecords": 2,
                      "celeba.test.tfrecords": 2}


def test_coco_records_are_hemx_records(coco):
    from hemx_torch.data.tfrecord import count_records
    tmp, files = coco
    counts = {f: count_records(str(tmp / "port" / f)) for f in files}
    # one train and one validate image missing on disk; no test images
    assert counts == {"coco.train.tfrecords": 9,
                      "coco.validate.tfrecords": 3,
                      "coco.test.tfrecords": 0}


@pytest.mark.parametrize("dataset", ["celeb", "coco"])
def test_parse_example_equals_hemx(dataset, celeb, coco):
    import importlib
    from hemx_torch.data.tfrecord import read_all_records
    tmp, files = {"celeb": celeb, "coco": coco}[dataset]
    h = importlib.import_module(f"hemx.data.{dataset}")
    p = importlib.import_module(f"hemx_torch.data.{dataset}")
    seen = 0
    for name in files:
        for rec in read_all_records(str(tmp / "port" / name)):
            want, got = h.parse_example(rec), p.parse_example(rec)
            assert sorted(got) == sorted(want)
            for k in want:
                assert got[k].dtype == want[k].dtype == np.uint8, k
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)
            seen += 1
    assert seen == (18 if dataset == "celeb" else 12)
    if dataset == "coco":  # every category id survives the nearest resize
        masks = [p.parse_example(r)["annotations"] for r in
                 read_all_records(str(tmp / "port" / "coco.train.tfrecords"))]
        assert set(np.unique(np.stack(masks))) == {0, 3, 7, 90}


def test_ann_to_mask_equals_hemx():
    from hemx.data import coco as H
    from hemx_torch.data import coco as P
    anns = coco_annotations(1, 20, 24) + [
        {"segmentation": {"counts": rle_string(RUNS), "size": [20, 24]}},
        {"segmentation": {"counts": RUNS, "size": [20, 24]}},
        {"segmentation": [[0.5, 0.5, 23.5, 0.5, 23.5, 19.5, 0.5, 19.5]]},
        {"bbox": [0, 0, 1, 1]}]  # no segmentation: an empty mask
    for ann in anns:
        want, got = H.ann_to_mask(ann, 20, 24), P.ann_to_mask(ann, 20, 24)
        assert got.dtype == want.dtype == np.uint8
        np.testing.assert_array_equal(got, want, err_msg=str(ann)[:80])
    runs = P.decode_compressed_rle(rle_string(RUNS), 20, 24)
    np.testing.assert_array_equal(runs, P._runs_to_mask(RUNS, 20, 24))
    assert runs.sum() == 40 + 12 + 100 + 282
    assert not P.ann_to_mask(anns[-1], 20, 24).any()
    assert P.ann_to_mask(anns[-2], 20, 24).all()


@pytest.mark.parametrize("dataset", ["celeb", "coco"])
def test_splits_and_empty_split_as_hemx(dataset, celeb, coco):
    """Each split's host batches equal hemx's; coco's test split has no
    records, and asking its size raises hemx's error in both packages."""
    import importlib
    tmp, _ = {"celeb": celeb, "coco": coco}[dataset]
    cls = {"celeb": "CelebDataset", "coco": "COCODataset"}[dataset]
    h = getattr(importlib.import_module(f"hemx.data.{dataset}"), cls)
    p = getattr(importlib.import_module(f"hemx_torch.data.{dataset}"), cls)
    os.makedirs(tmp / "h_store", exist_ok=True)
    os.makedirs(tmp / "p_store", exist_ok=True)
    for side in ("h_store", "p_store"):
        link = tmp / side / dataset
        if not link.exists():
            link.symlink_to(tmp / ("hemx" if side == "h_store" else "port"))
    want = h.get_datasets(make_args(dataset_dir=str(tmp / "h_store")))
    got = p.get_datasets(make_args(dataset_dir=str(tmp / "p_store")))
    assert sorted(got) == sorted(want)
    for name in want:
        if name == "test" and dataset == "coco":
            for split in (want[name], got[name]):
                with pytest.raises(ValueError, match="no records in"):
                    split.count
            continue
        assert got[name].count == want[name].count
        for w, g in zip(want[name].iter_epoch(2, seed=1),
                        got[name].iter_epoch(2, seed=1)):
            for k in w:
                np.testing.assert_array_equal(g[k], w[k])
        assert got[name].device_transform.keys == ("image",)


def test_iwgan_call_on_celeb_matches_hemx(celeb):
    """One IWGAN call (2 critic steps + 1 generator step, sgd) on the
    celeb train split, each package's batches from its device cache."""
    from hemx.data.celeb import CelebDataset as HC
    from hemx.data.pipeline import DeviceDataPipeline as HD
    from hemx.models.plugin import get_model
    from hemx.parallel.mesh import make_mesh
    from hemx_torch import convert
    from hemx_torch.data.celeb import CelebDataset as PC
    from hemx_torch.data.pipeline import DeviceDataPipeline as PD
    from hemx_torch.models.gan import IwganModel
    from tests.test_torch_dp_gan import LOSS_TOL, TOL, assert_close
    tmp, _ = celeb
    store = tmp / "iw_store"
    store.mkdir(exist_ok=True)
    (store / "celeb").symlink_to(tmp / "port")
    args = make_args(model="iwgan", dataset="celeb", batch_size=B,
                     latent_size=LATENT, n_disc_train=2, optimizer="sgd",
                     lr=1e-3, dataset_dir=str(store))
    mesh = make_mesh(1)
    hsplit = HC.get_datasets(args)["train"]
    with xla_opt0():
        model = get_model("iwgan")(args, mesh)
        feed = HD.maybe(hsplit, B, mesh=mesh, keys=("image",), shuffle=True,
                        seed=args.seed, group=3)
        host = next(hsplit.iter_epoch(B, shuffle=False))
        ts = model.init_state(jax.random.PRNGKey(args.seed),
                              {"image": host["image"].astype(np.float32)})
        start = jax.device_get(ts)
        new_ts, metrics = model.train(ts, feed.epoch(0))
    want = jax.device_get(new_ts)
    psplit = PC.get_datasets(args)["train"]
    pfeed = PD.maybe(psplit, B, device="cpu", keys=("image",), shuffle=True,
                     seed=args.seed, group=3)
    port = IwganModel(args, "cpu")
    pts = port.init_state((3, 64, 64), args.seed)
    convert.load_from_jax(pts.nets, start["params"], start["mstate"])
    noise = _jax_noise(args.seed, 0, 2, B, LATENT)
    pts, got = port.train(pts, pfeed.epoch(0), noise=noise)
    for k, v in jax.device_get(metrics).items():
        np.testing.assert_allclose(float(got[k]), float(v), err_msg=k,
                                   **LOSS_TOL)
    params, mstate = convert.to_jax(pts.nets)
    assert_close(params, want["params"], TOL)
    assert_close(mstate, want["mstate"], TOL)


def test_coco_cache_keeps_annotations_as_category_ids(coco):
    from hemx_torch.data.coco import COCODataset
    from hemx_torch.data.pipeline import DeviceDataPipeline
    tmp, _ = coco
    store = tmp / "cnn_store"
    store.mkdir(exist_ok=True)
    (store / "coco").symlink_to(tmp / "port")
    split = COCODataset.get_datasets(make_args(dataset_dir=str(store)))[
        "train"]
    feed = DeviceDataPipeline.maybe(split, 3, device="cpu", shuffle=False,
                                    group=3)
    batches = list(feed.epoch(0))
    host = list(split.iter_epoch(3, shuffle=False))
    assert len(batches) == len(host) == 3
    for b, h in zip(batches, host):
        assert b["annotations"].dtype == torch.uint8
        np.testing.assert_array_equal(
            b["annotations"].permute(0, 2, 3, 1).numpy(), h["annotations"])
        np.testing.assert_allclose(
            b["image"].permute(0, 2, 3, 1).numpy(),
            h["image"].astype(np.float32) / 255.0, rtol=0, atol=1e-7)


def test_pix2pix_on_coco_fails_as_hemx_does(coco):
    """``examples/cgan_experiments/mask.config`` trains pix2pix on coco,
    but the conditional models read ``batch["depth"]``, which coco's
    records do not have: both packages fail there, with a KeyError."""
    from hemx.data.coco import COCODataset as HC
    from hemx.models.plugin import get_model as hemx_model
    from hemx.parallel.mesh import make_mesh
    tmp, _ = coco
    store = tmp / "p2p_store"
    store.mkdir(exist_ok=True)
    (store / "coco").symlink_to(tmp / "port")
    args = make_args(model="pix2pix", dataset="coco", batch_size=2,
                     dataset_dir=str(store), noise=[], dropout=0,
                     batch_norm_gen=False, batch_norm_disc=False,
                     add_l1=False, l1_lambda=10.0, n_disc_train=1)
    host = next(HC.get_datasets(args)["train"].iter_epoch(2, shuffle=False))
    model = hemx_model("pix2pix")(args, make_mesh(1))
    with pytest.raises(KeyError, match="depth"):
        model.init_state(jax.random.PRNGKey(0), host)
    from hemx_torch import cli
    with pytest.raises(KeyError, match="depth"):
        cli.run(["@" + str(REPO / "examples" / "cgan_experiments" /
                           "mask.config"), "--device", "cpu",
                 "--dataset_dir", str(store), "--batch_size", "2",
                 "--epochs", "1", "--dir", str(tmp / "p2p_run")])


def test_prepare_dataset_converts_once_while_others_wait(celeb, tmp_path,
                                                         monkeypatch):
    """Two callers prepare one empty ``--dataset_dir`` at once, as the
    ranks of a group do: one converts, the other waits on the directory's
    lock (not in a collective, whose timeout a long conversion would
    outlast) and returns only when the records are whole, with no second
    conversion."""
    import threading
    import time

    from hemx_torch.data.celeb import CelebDataset
    from hemx_torch.data.plugin import prepare_dataset
    tmp, files = celeb
    real = CelebDataset.convert_to_tfrecord
    converted = []

    def slow(raw, storage):
        time.sleep(0.5)
        real(raw, storage)
        converted.append(time.monotonic())

    monkeypatch.setattr(CelebDataset, "convert_to_tfrecord",
                        staticmethod(slow))
    args = make_args(dataset="celeb", raw_dataset_dir=str(tmp / "raw"),
                     dataset_dir=str(tmp_path / "records"))
    returned = []

    def prepare():
        prepare_dataset(args)
        returned.append(time.monotonic())

    threads = [threading.Thread(target=prepare) for _ in range(2)]
    for t in threads:
        t.start()
        time.sleep(0.1)
    for t in threads:
        t.join()
    assert len(converted) == 1 and len(returned) == 2
    assert min(returned) >= converted[0]
    for name in files:
        assert ((tmp_path / "records" / "celeb" / name).read_bytes()
                == (tmp / "hemx" / name).read_bytes()), name


def test_two_ranks_train_on_an_empty_dataset_dir(celeb, tmp_path):
    """``python -m hemx_torch.cli --device cpu --n_devices 2`` on celeb
    with no records yet: the ranks convert the raw tree once, into hemx's
    records, and train one IWGAN call at the global batch."""
    import subprocess
    import sys
    tmp, files = celeb
    store = tmp_path / "records"
    r = subprocess.run(
        [sys.executable, "-m", "hemx_torch.cli", "--model", "iwgan",
         "--dataset", "celeb", "--raw_dataset_dir", str(tmp / "raw"),
         "--dataset_dir", str(store), "--device", "cpu", "--n_devices", "2",
         "--batch_size", "2", "--latent_size", str(LATENT),
         "--n_disc_train", "1", "--epochs", "1", "--epoch_size", "1",
         "--seed", "3", "--dir", str(tmp_path / "run")],
        cwd=REPO, capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "2"})
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-4000:]
    summary = json.loads(r.stdout.strip().splitlines()[-1])
    assert summary["processes"] == 2 and summary["global_batch"] == 4
    assert summary["step"] == 1
    for name in files:
        assert ((store / "celeb" / name).read_bytes()
                == (tmp / "hemx" / name).read_bytes()), name
