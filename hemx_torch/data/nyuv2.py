"""NYUv2 depth dataset plugin (counterpart of ``hemx.data.nyuv2``).

Record schema: {'image': png bytes (RGB), 'depth': png bytes (16-bit
grey), width/height/channels int64, filename/depth_filename bytes}. Raw
data = a directory of ``<frame>_i.png`` / ``<frame>_f.png`` pairs listed in
train.txt / validation.txt / test.txt.

* ``--resize H W`` resizes at parse time (depth through float32, truncated
  back to uint16);
* frames whose depth has sensor gaps (0 or 65535) are dropped at
  materialization;
* the host ``batch_transform`` divides by 255 and 65535 and applies
  ``--random_crop`` (from the batch rng), ``--include_location``,
  ``--normalize`` and ``--include_originals``, so the split always
  streams. It emits an NHWC dict {'image', 'depth', ['x_loc','y_loc'],
  ['mean'], ['x_full','y_full']} of float32.
"""

from __future__ import annotations

import os

import numpy as np

from hemx_torch.data.imageio import decode_image, decode_png16, resize_bilinear
from hemx_torch.data.pipeline import Split, TFRecordSource
from hemx_torch.data.plugin import DataPlugin, bytes_feature, int64_feature
from hemx_torch.data.tfrecord import TFRecordWriter
from hemx_torch.summaries import proto

_OUTPUT_FILES = {"train": "nyuv2.train.tfrecords",
                 "validate": "nyuv2.validate.tfrecords",
                 "test": "nyuv2.test.tfrecords"}
_LIST_FILES = {"train": "train.txt", "validate": "validation.txt",
               "test": "test.txt"}


def _make_parse(resize):
    def parse(record: bytes) -> dict:
        feats = proto.parse_example(record)
        image = decode_image(feats["image"]["bytes"][0], channels=3)
        depth = decode_png16(feats["depth"]["bytes"][0])
        if resize:
            image = resize_bilinear(image, resize[0], resize[1])
            depth = resize_bilinear(depth.astype(np.float32),
                                    resize[0], resize[1]).astype(np.uint16)
        return {"image": image, "depth": depth}
    return parse


def _has_sensor_gaps(sample: dict) -> bool:
    d = sample["depth"]
    return bool((d == 0).any() or (d == np.iinfo(np.uint16).max).any())


class NYUv2Dataset(DataPlugin):
    name = "nyuv2"

    @staticmethod
    def arguments() -> dict:
        return {
            "--resize": dict(type=int, nargs=2, default=None,
                             help="Resize inputs to H W."),
            "--random_crop": dict(type=int, nargs=2, default=None,
                                  help="Joint random crop of image+depth to H W."),
            "--include_location": dict(action="store_true", default=False,
                                       help="With --random_crop, add 2-channel "
                                            "crop-location maps (fraction of W/H)."),
            "--skip_invalid": dict(action="store_true", default=False,
                                   help="Declared for reference CLI parity "
                                        "but INERT, exactly like the "
                                        "reference: sensor-gap frames are "
                                        "always dropped (the reference "
                                        "declares --skip_invalid at "
                                        "nyuv2.py:60 yet applies its "
                                        "dataset.filter unconditionally at "
                                        ":266)."),
            "--normalize": dict(action="store_true", default=False,
                                help="Provide the per-image mean depth as an "
                                     "extra channel."),
            "--include_originals": dict(type=int, nargs=2, default=None,
                                        help="Also emit full images resized to H W."),
        }

    @staticmethod
    def check_prepared_datasets(storage_dir: str) -> bool:
        return all(os.path.exists(os.path.join(storage_dir, f))
                   for f in _OUTPUT_FILES.values())

    @staticmethod
    def check_raw_datasets(storage_dir: str) -> bool:
        return all(os.path.exists(os.path.join(storage_dir, f))
                   for f in _LIST_FILES.values())

    @staticmethod
    def download(download_dir: str) -> bool:
        raise NotImplementedError(
            "NYUv2 requires manual preprocessing (see reference "
            "hem/data/nyuv2.py header); place <frame>_i.png/<frame>_f.png "
            "pairs + split lists in --raw_dataset_dir")

    @staticmethod
    def convert_to_tfrecord(download_dir: str, storage_dir: str) -> None:
        os.makedirs(storage_dir, exist_ok=True)
        for split, list_file in _LIST_FILES.items():
            out = os.path.join(storage_dir, _OUTPUT_FILES[split])
            with open(os.path.join(download_dir, list_file)) as f:
                frames = [l.strip() for l in f if l.strip()]
            with TFRecordWriter(out) as w:
                for frame in frames:
                    fin = os.path.join(download_dir, frame + "_i.png")
                    fdn = os.path.join(download_dir, frame + "_f.png")
                    with open(fin, "rb") as fi:
                        image_data = fi.read()
                    with open(fdn, "rb") as fd:
                        depth_data = fd.read()
                    w.write(proto.example({
                        "image": bytes_feature(image_data),
                        "depth": bytes_feature(depth_data),
                        "width": int64_feature(427),
                        "height": int64_feature(561),
                        "channels": int64_feature(3),
                        "filename": bytes_feature(fin.encode()),
                        "depth_filename": bytes_feature(fdn.encode()),
                    }))

    @classmethod
    def get_datasets(cls, args) -> dict:
        storage = os.path.join(args.dataset_dir, cls.name)
        resize = getattr(args, "resize", None)
        crop = getattr(args, "random_crop", None)
        include_location = getattr(args, "include_location", False)
        normalize = getattr(args, "normalize", False)
        originals = getattr(args, "include_originals", None)

        def transform(batch: dict, rng: np.random.Generator) -> dict:
            image = batch["image"].astype(np.float32) / np.iinfo(np.uint8).max
            depth = batch["depth"].astype(np.float32) / np.iinfo(np.uint16).max
            n, h, w, _ = image.shape
            out: dict = {}
            if originals:
                out["x_full"] = np.stack([resize_bilinear(im, *originals)
                                          for im in image])
                out["y_full"] = np.stack([resize_bilinear(dm, *originals)
                                          for dm in depth])
            if crop:
                ch, cw = crop
                tops = rng.integers(0, h - ch + 1, size=n)
                lefts = rng.integers(0, w - cw + 1, size=n)
                img_c = np.empty((n, ch, cw, 3), np.float32)
                dep_c = np.empty((n, ch, cw, 1), np.float32)
                for i, (t, l) in enumerate(zip(tops, lefts)):
                    img_c[i] = image[i, t:t + ch, l:l + cw]
                    dep_c[i] = depth[i, t:t + ch, l:l + cw]
                if include_location:
                    # crop-location maps: fraction of the source extent
                    # covered by each cropped pixel (hem/data/nyuv2.py:158-166)
                    ys = np.linspace(0.0, 1.0, h, dtype=np.float32)
                    xs = np.linspace(0.0, 1.0, w, dtype=np.float32)
                    x_loc = np.empty((n, ch, cw, 1), np.float32)
                    y_loc = np.empty((n, ch, cw, 1), np.float32)
                    for i, (t, l) in enumerate(zip(tops, lefts)):
                        y_loc[i, :, :, 0] = ys[t:t + ch, None]
                        x_loc[i, :, :, 0] = xs[None, l:l + cw]
                    out["x_loc"] = x_loc
                    out["y_loc"] = y_loc
                image, depth = img_c, dep_c
            out["image"] = image
            out["depth"] = depth
            if normalize:
                mean = depth.mean(axis=(1, 2, 3), keepdims=True)
                out["mean"] = np.broadcast_to(
                    mean, depth.shape).astype(np.float32).copy()
            return out

        splits = {}
        for split, fname in _OUTPUT_FILES.items():
            src = TFRecordSource([os.path.join(storage, fname)],
                                 _make_parse(resize),
                                 sample_filter=lambda s: not _has_sensor_gaps(s))
            splits[split] = Split(src, batch_transform=transform, name=split,
                                  transform_needs_rng=True)
        return splits
