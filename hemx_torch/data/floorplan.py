"""Floorplan dataset plugin (counterpart of ``hemx.data.floorplan``).

Record schema: {'image': encoded bytes, 'width','height','channels':
int64, 'filename': bytes} (``width`` holds the image's height and
``height`` its width, as ``hemx`` writes them). Parse: decode -> RGB ->
resize to 64x64, uint8; no host transform, so the split is eligible for
the device cache and normalizes on the device.

Raw data = a directory with train_set.txt / validation_set.txt /
test_set.txt listing image paths (no public download).
"""

from __future__ import annotations

import os

from hemx_torch.data.imageio import decode_image, image_shape, resize_bilinear
from hemx_torch.data.pipeline import Split, TFRecordSource, U8Normalize
from hemx_torch.data.plugin import DataPlugin, bytes_feature, int64_feature
from hemx_torch.data.tfrecord import TFRecordWriter
from hemx_torch.summaries import proto

_OUTPUT_FILES = {"train": "floorplan.train.tfrecords",
                 "validate": "floorplan.validate.tfrecords",
                 "test": "floorplan.test.tfrecords"}
_LIST_FILES = {"train": "train_set.txt", "validate": "validation_set.txt",
               "test": "test_set.txt"}


def parse_example(record: bytes) -> dict:
    feats = proto.parse_example(record)
    img = decode_image(feats["image"]["bytes"][0], channels=3)
    img = resize_bilinear(img, 64, 64)
    return {"image": img}


class FloorplanDataset(DataPlugin):
    name = "floorplan"

    @staticmethod
    def arguments() -> dict:
        return {}

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
        # no public source
        raise NotImplementedError(
            "floorplan has no public download; place train_set.txt/"
            "validation_set.txt/test_set.txt + images in --raw_dataset_dir")

    @staticmethod
    def convert_to_tfrecord(download_dir: str, storage_dir: str) -> None:
        os.makedirs(storage_dir, exist_ok=True)
        for split, list_file in _LIST_FILES.items():
            out = os.path.join(storage_dir, _OUTPUT_FILES[split])
            with open(os.path.join(download_dir, list_file)) as f:
                lines = [l.strip() for l in f if l.strip()]
            with TFRecordWriter(out) as w:
                for line in lines:
                    path = os.path.join(download_dir, line)
                    with open(path, "rb") as img_f:
                        data = img_f.read()
                    # decode_image(data).shape, from a PNG's header
                    shape = image_shape(data)
                    w.write(proto.example({
                        "image": bytes_feature(data),
                        "width": int64_feature(shape[0]),
                        "height": int64_feature(shape[1]),
                        "channels": int64_feature(shape[2]),
                        "filename": bytes_feature(path.encode()),
                    }))

    @classmethod
    def get_datasets(cls, args) -> dict:
        storage = os.path.join(args.dataset_dir, cls.name)
        splits = {}
        for split, fname in _OUTPUT_FILES.items():
            src = TFRecordSource([os.path.join(storage, fname)], parse_example)
            # no host batch_transform -> device-resident-cache eligible
            splits[split] = Split(src, name=split,
                                  device_transform=U8Normalize())
        return splits
