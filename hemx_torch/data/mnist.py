"""MNIST dataset plugin (counterpart of ``hemx.data.mnist``).

Record schema: {'image': bytes(784), 'label': int64}. Images parse to
(28, 28, 1) uint8 and normalize on the device. Splits: train/test;
'validate' aliases test's source, so the device cache holds it once.
"""

from __future__ import annotations

import gzip
import os
import struct
import urllib.request

import numpy as np

from hemx_torch.data.pipeline import Split, TFRecordSource, U8Normalize
from hemx_torch.data.plugin import DataPlugin, bytes_feature, int64_feature
from hemx_torch.data.tfrecord import TFRecordWriter
from hemx_torch.summaries import proto

_FILES = {
    "train": ("train-images-idx3-ubyte.gz", "train-labels-idx1-ubyte.gz"),
    "test": ("t10k-images-idx3-ubyte.gz", "t10k-labels-idx1-ubyte.gz"),
}
_URL = "https://storage.googleapis.com/cvdf-datasets/mnist/"


def _read_idx_images(path: str) -> np.ndarray:
    with gzip.open(path, "rb") as f:
        magic, n, rows, cols = struct.unpack(">IIII", f.read(16))
        assert magic == 2051, f"bad idx image magic {magic}"
        return np.frombuffer(f.read(n * rows * cols), np.uint8).reshape(n, rows, cols)


def _read_idx_labels(path: str) -> np.ndarray:
    with gzip.open(path, "rb") as f:
        magic, n = struct.unpack(">II", f.read(8))
        assert magic == 2049, f"bad idx label magic {magic}"
        return np.frombuffer(f.read(n), np.uint8)


def parse_example(record: bytes) -> dict:
    feats = proto.parse_example(record)
    img = np.frombuffer(feats["image"]["bytes"][0], np.uint8).reshape(28, 28, 1)
    label = np.int64(feats["label"]["int64"][0])
    return {"image": img, "label": label}


class MnistDataset(DataPlugin):
    name = "mnist"

    @staticmethod
    def arguments() -> dict:
        return {}

    @staticmethod
    def check_prepared_datasets(storage_dir: str) -> bool:
        return all(os.path.exists(os.path.join(storage_dir, f"{s}.tfrecords"))
                   for s in ("train", "test"))

    @staticmethod
    def check_raw_datasets(storage_dir: str) -> bool:
        return all(os.path.exists(os.path.join(storage_dir, f))
                   for pair in _FILES.values() for f in pair)

    @staticmethod
    def download(download_dir: str) -> bool:
        os.makedirs(download_dir, exist_ok=True)
        for pair in _FILES.values():
            for fname in pair:
                dest = os.path.join(download_dir, fname)
                if not os.path.exists(dest):
                    urllib.request.urlretrieve(_URL + fname, dest)
        return True

    @staticmethod
    def convert_to_tfrecord(download_dir: str, storage_dir: str) -> None:
        os.makedirs(storage_dir, exist_ok=True)
        for split, (img_f, lbl_f) in _FILES.items():
            images = _read_idx_images(os.path.join(download_dir, img_f))
            labels = _read_idx_labels(os.path.join(download_dir, lbl_f))
            out = os.path.join(storage_dir, f"{split}.tfrecords")
            with TFRecordWriter(out) as w:
                for img, lbl in zip(images, labels):
                    w.write(proto.example({
                        "image": bytes_feature(img.tobytes()),
                        "label": int64_feature(int(lbl)),
                    }))

    @classmethod
    def get_datasets(cls, args) -> dict:
        storage = os.path.join(args.dataset_dir, cls.name)
        splits = {}
        for split in ("train", "test"):
            src = TFRecordSource([os.path.join(storage, f"{split}.tfrecords")],
                                 parse_example)
            # no host batch_transform: uint8 ships as-is and normalizes
            # on the device, which keeps the split eligible for the
            # device-resident cache (DeviceDataPipeline.maybe requires
            # batch_transform is None)
            splits[split] = Split(src, name=split,
                                  device_transform=U8Normalize())
        splits["validate"] = Split(splits["test"].source, name="validate",
                                   device_transform=U8Normalize())
        return splits
