"""CIFAR-10 dataset plugin (counterpart of ``hemx.data.cifar``).

Record schema: {'image': bytes} of raw 32x32x3 uint8 HWC pixels, from the
pickled batches (or their tarball). ``--cifar_resize N`` resizes each host
batch to NxN (PIL bilinear, uint8 out, normalized on the device), which
makes the split stream; without it the split is cache-eligible.
'validate' aliases test's source.
"""

from __future__ import annotations

import os
import pickle
import tarfile
import urllib.request

import numpy as np

from hemx_torch.data.imageio import resize_bilinear
from hemx_torch.data.pipeline import Split, TFRecordSource, U8Normalize
from hemx_torch.data.plugin import DataPlugin, bytes_feature
from hemx_torch.data.tfrecord import TFRecordWriter
from hemx_torch.summaries import proto

_OUTPUT_FILES = {"train": "cifar.train.tfrecords", "test": "cifar.test.tfrecords"}
_INPUT_FILE = "cifar-10-python.tar.gz"
_URL = "https://www.cs.toronto.edu/~kriz/cifar-10-python.tar.gz"
_TRAIN_BATCHES = ["data_batch_1", "data_batch_2", "data_batch_3",
                  "data_batch_4", "data_batch_5"]


def parse_example(record: bytes) -> dict:
    feats = proto.parse_example(record)
    img = np.frombuffer(feats["image"]["bytes"][0], np.uint8).reshape(32, 32, 3)
    return {"image": img}


class CifarDataset(DataPlugin):
    name = "cifar"

    @staticmethod
    def arguments() -> dict:
        return {
            "--cifar_resize": dict(type=int, default=0,
                                   help="Resize images to NxN (0 = native 32; "
                                        "the v1 pipeline used 64, data.py:44)."),
        }

    @staticmethod
    def check_prepared_datasets(storage_dir: str) -> bool:
        return all(os.path.exists(os.path.join(storage_dir, f))
                   for f in _OUTPUT_FILES.values())

    @staticmethod
    def check_raw_datasets(storage_dir: str) -> bool:
        if os.path.exists(os.path.join(storage_dir, _INPUT_FILE)):
            return True
        # also accept an already-extracted batches dir
        return all(os.path.exists(os.path.join(storage_dir,
                                               "cifar-10-batches-py", b))
                   for b in _TRAIN_BATCHES)

    @staticmethod
    def download(download_dir: str) -> bool:
        os.makedirs(download_dir, exist_ok=True)
        dest = os.path.join(download_dir, _INPUT_FILE)
        if not os.path.exists(dest):
            urllib.request.urlretrieve(_URL, dest)
        return True

    @staticmethod
    def convert_to_tfrecord(download_dir: str, storage_dir: str) -> None:
        os.makedirs(storage_dir, exist_ok=True)
        batches_dir = os.path.join(download_dir, "cifar-10-batches-py")
        if not os.path.isdir(batches_dir):
            with tarfile.open(os.path.join(download_dir, _INPUT_FILE)) as tar:
                tar.extractall(download_dir)

        def build(split: str, filelist: list[str]) -> None:
            out = os.path.join(storage_dir, _OUTPUT_FILES[split])
            with TFRecordWriter(out) as w:
                for fname in filelist:
                    with open(os.path.join(batches_dir, fname), "rb") as f:
                        d = pickle.load(f, encoding="bytes")
                    images = d[b"data"].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
                    for img in images:
                        w.write(proto.example(
                            {"image": bytes_feature(img.tobytes())}))

        build("train", _TRAIN_BATCHES)
        build("test", ["test_batch"])

    @classmethod
    def get_datasets(cls, args) -> dict:
        storage = os.path.join(args.dataset_dir, cls.name)
        resize = getattr(args, "cifar_resize", 0)

        def transform(batch: dict) -> dict:
            imgs = np.stack([resize_bilinear(i, resize, resize)
                             for i in batch["image"]])
            # uint8 to the device; normalized there
            return {"image": imgs}

        # only a real --cifar_resize needs a host transform; the default
        # path keeps batch_transform None so the split stays eligible for
        # the device-resident cache (DeviceDataPipeline.maybe)
        bt = transform if resize else None
        splits = {}
        for split, fname in _OUTPUT_FILES.items():
            src = TFRecordSource([os.path.join(storage, fname)], parse_example)
            splits[split] = Split(src, batch_transform=bt, name=split,
                                  device_transform=U8Normalize())
        splits["validate"] = Split(splits["test"].source,
                                   batch_transform=bt, name="validate",
                                   device_transform=U8Normalize())
        return splits
