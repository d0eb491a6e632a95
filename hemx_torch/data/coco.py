"""MS-COCO 2014 dataset plugin (counterpart of ``hemx.data.coco``).

Record schema, hemx's: {'image': encoded bytes, 'annotations': the raw
bytes of one uint8 category-id mask (H, W, 1), 'width', 'height',
'image_id': int64, 'filename': bytes, and the variable-length 'labels',
'iscrowds' (int64) and 'bboxes', 'areas' (float)}. Masks are rasterized
without pycocotools, as hemx does: polygons through Pillow's ``ImageDraw``
(imported when a polygon is drawn), uncompressed and compressed RLE
decoded here. Parse: decode -> resize to 64x64 (bilinear), uint8, and the
mask by nearest neighbour (row ``i`` reads row ``i * h // 64``), so the
category ids stay ids. Only ``image`` normalizes on the device;
``annotations`` stays uint8 (the device cache gathers it with
``index_select``).
"""

from __future__ import annotations

import json
import os
import urllib.request

import numpy as np

from hemx_torch.data.imageio import decode_image, resize_bilinear
from hemx_torch.data.pipeline import Split, TFRecordSource, U8Normalize
from hemx_torch.data.plugin import (DataPlugin, bytes_feature, float_feature,
                                    int64_feature)
from hemx_torch.data.tfrecord import TFRecordWriter
from hemx_torch.summaries import proto

_OUTPUT_FILES = {"train": "coco.train.tfrecords",
                 "validate": "coco.validate.tfrecords",
                 "test": "coco.test.tfrecords"}
_IMAGE_DIRS = {"train": "train2014", "validate": "val2014", "test": "test2014"}
_ANNOTATION_FILES = {"train": "instances_train2014.json",
                     "validate": "instances_val2014.json",
                     "test": "image_info_test2014.json"}


def decode_compressed_rle(counts: str, h: int, w: int) -> np.ndarray:
    """COCO compressed RLE string -> (h, w) uint8 mask (column-major runs);
    from the fourth run on, a run is coded as its difference from the run
    two before it, as hemx decodes it."""
    runs = []
    i = 0
    n = len(counts)
    while i < n:
        x = 0
        k = 0
        more = True
        while more:
            c = ord(counts[i]) - 48
            x |= (c & 0x1F) << (5 * k)
            more = bool(c & 0x20)
            i += 1
            k += 1
            if not more and (c & 0x10):
                x |= -1 << (5 * k)
        if len(runs) > 2:
            x += runs[-2]
        runs.append(x)
    return _runs_to_mask(runs, h, w)


def _runs_to_mask(runs, h: int, w: int) -> np.ndarray:
    flat = np.zeros(h * w, np.uint8)
    pos = 0
    val = 0
    for run in runs:
        if val:
            flat[pos:pos + run] = 1
        pos += run
        val ^= 1
    # COCO RLE is column-major
    return flat[:h * w].reshape(w, h).T


def ann_to_mask(ann: dict, h: int, w: int) -> np.ndarray:
    """Annotation -> binary (h, w) mask: polygons (each of 3 points or
    more, outline and fill 1), uncompressed RLE, or compressed RLE."""
    seg = ann.get("segmentation")
    if seg is None:
        return np.zeros((h, w), np.uint8)
    if isinstance(seg, list):  # polygons
        from PIL import Image, ImageDraw

        img = Image.new("L", (w, h), 0)
        draw = ImageDraw.Draw(img)
        for poly in seg:
            pts = [(poly[i], poly[i + 1]) for i in range(0, len(poly) - 1, 2)]
            if len(pts) >= 3:
                draw.polygon(pts, outline=1, fill=1)
        return np.asarray(img, np.uint8)
    counts = seg["counts"]
    sh, sw = seg["size"]
    if isinstance(counts, list):  # uncompressed RLE
        return _runs_to_mask(counts, sh, sw)
    return decode_compressed_rle(counts, sh, sw)


def parse_example(record: bytes) -> dict:
    feats = proto.parse_example(record)
    w = feats["width"]["int64"][0]
    h = feats["height"]["int64"][0]
    image = decode_image(feats["image"]["bytes"][0], channels=3)
    mask = np.frombuffer(feats["annotations"]["bytes"][0],
                         np.uint8).reshape(h, w, 1)
    image = resize_bilinear(image, 64, 64)
    ys = (np.arange(64) * h // 64).clip(0, h - 1)
    xs = (np.arange(64) * w // 64).clip(0, w - 1)
    mask64 = mask[np.ix_(ys, xs)].reshape(64, 64, 1)
    return {"image": image, "annotations": mask64}


class COCODataset(DataPlugin):
    name = "coco"

    @staticmethod
    def arguments() -> dict:
        return {}

    @staticmethod
    def check_prepared_datasets(storage_dir: str) -> bool:
        return all(os.path.exists(os.path.join(storage_dir, f))
                   for f in _OUTPUT_FILES.values())

    @staticmethod
    def check_raw_datasets(storage_dir: str) -> bool:
        return all(os.path.isdir(os.path.join(storage_dir, d))
                   for d in _IMAGE_DIRS.values()) and os.path.isdir(
            os.path.join(storage_dir, "annotations"))

    @staticmethod
    def download(download_dir: str) -> bool:
        # hemx's URLs (the msvocds mirror is decommissioned; the zips are
        # named the same at images.cocodataset.org): place them in
        # download_dir by hand if this fails
        base = "http://msvocds.blob.core.windows.net/"
        files = ["coco2014/train2014.zip", "coco2014/val2014.zip",
                 "coco2014/test2014.zip",
                 "annotations-1-0-3/instances_train-val2014.zip",
                 "annotations-1-0-4/image_info_test2014.zip"]
        os.makedirs(download_dir, exist_ok=True)
        for f in files:
            dest = os.path.join(download_dir, os.path.basename(f))
            if not os.path.exists(dest):
                urllib.request.urlretrieve(base + f, dest)
        return True

    @staticmethod
    def convert_to_tfrecord(download_dir: str, storage_dir: str) -> None:
        """One record per image of each split's json whose file exists (the
        others are skipped), its annotations' masks merged into one mask of
        category ids, a later annotation over an earlier one."""
        os.makedirs(storage_dir, exist_ok=True)
        for split in _OUTPUT_FILES:
            ann_path = os.path.join(download_dir, "annotations",
                                    _ANNOTATION_FILES[split])
            with open(ann_path) as f:
                coco = json.load(f)
            anns_by_image: dict[int, list] = {}
            for a in coco.get("annotations", []):
                anns_by_image.setdefault(a["image_id"], []).append(a)
            image_dir = os.path.join(download_dir, _IMAGE_DIRS[split])
            out = os.path.join(storage_dir, _OUTPUT_FILES[split])
            with TFRecordWriter(out) as w:
                for img in coco["images"]:
                    path = os.path.join(image_dir, img["file_name"])
                    if not os.path.exists(path):
                        continue
                    with open(path, "rb") as f:
                        image_data = f.read()
                    h, wd = img["height"], img["width"]
                    total_mask = np.zeros((h, wd, 1), np.uint8)
                    labels, bboxes, crowds, areas = [], [], [], []
                    for a in anns_by_image.get(img["id"], []):
                        m = ann_to_mask(a, h, wd)
                        total_mask[m == 1] = int(a["category_id"])
                        bboxes.extend(a["bbox"])
                        crowds.append(a["iscrowd"])
                        areas.append(a["area"])
                        labels.append(a["category_id"])
                    w.write(proto.example({
                        "image": bytes_feature(image_data),
                        "annotations": bytes_feature(total_mask.tobytes()),
                        "filename": bytes_feature(img["file_name"].encode()),
                        "width": int64_feature(wd),
                        "height": int64_feature(h),
                        "image_id": int64_feature(img["id"]),
                        "bboxes": float_feature(*bboxes),
                        "iscrowds": int64_feature(*crowds),
                        "areas": float_feature(*areas),
                        "labels": int64_feature(*labels),
                    }))

    @classmethod
    def get_datasets(cls, args) -> dict:
        storage = os.path.join(args.dataset_dir, cls.name)
        splits = {}
        for split, fname in _OUTPUT_FILES.items():
            src = TFRecordSource([os.path.join(storage, fname)], parse_example)
            splits[split] = Split(src, name=split,
                                  device_transform=U8Normalize())
        return splits
