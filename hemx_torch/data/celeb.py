"""CelebA dataset plugin (counterpart of ``hemx.data.celeb``).

Record schema: {'image': encoded jpg/png, 'filename': bytes,
'attributes': bytes}, the 40 attributes of ``list_attr_celeba.txt``
packed as raw bools. Parse: decode to RGB -> resize to 64x64 (the port's
Pillow-exact bilinear), uint8; the attributes as a uint8 40-vector. No
host transform: the split may live in the device cache, where ``image``
normalizes on the device.

Splits come from ``list_eval_partition.txt`` (0 = train, 1 = validate,
2 = test). The images are read from ``img_align_celeba_png`` (a ``.png``
name) or ``img_align_celeba_jpg``, else from ``img_align_celeba``. CelebA
has no download: its files are placed in ``--raw_dataset_dir`` by hand.
hemx's ``check_prepared`` / ``check_raw`` return their result (the
reference's lacked the ``return``).
"""

from __future__ import annotations

import os

import numpy as np

from hemx_torch.data.imageio import decode_image, resize_bilinear
from hemx_torch.data.pipeline import Split, TFRecordSource, U8Normalize
from hemx_torch.data.plugin import DataPlugin, bytes_feature
from hemx_torch.data.tfrecord import TFRecordWriter
from hemx_torch.summaries import proto

_OUTPUT_FILES = {"train": "celeba.train.tfrecords",
                 "validate": "celeba.validate.tfrecords",
                 "test": "celeba.test.tfrecords"}

ATTRIBUTE_NAMES = [
    "5_o_Clock_Shadow", "Arched_Eyebrows", "Attractive", "Bags_Under_Eyes",
    "Bald", "Bangs", "Big_Lips", "Big_Nose", "Black_Hair", "Blond_Hair",
    "Blurry", "Brown_Hair", "Bushy_Eyebrows", "Chubby", "Double_Chin",
    "Eyeglasses", "Goatee", "Gray_Hair", "Heavy_Makeup", "High_Cheekbones",
    "Male", "Mouth_Slightly_Open", "Mustache", "Narrow_Eyes", "No_Beard",
    "Oval_Face", "Pale_Skin", "Pointy_Nose", "Receding_Hairline",
    "Rosy_Cheeks", "Sideburns", "Smiling", "Straight_Hair", "Wavy_Hair",
    "Wearing_Earrings", "Wearing_Hat", "Wearing_Lipstick", "Wearing_Necklace",
    "Wearing_Necktie", "Young",
]


def parse_example(record: bytes) -> dict:
    feats = proto.parse_example(record)
    img = decode_image(feats["image"]["bytes"][0], channels=3)
    img = resize_bilinear(img, 64, 64)
    attrs = np.frombuffer(feats["attributes"]["bytes"][0], np.bool_)
    return {"image": img, "attributes": attrs.astype(np.uint8)}


class CelebDataset(DataPlugin):
    name = "celeb"

    @staticmethod
    def arguments() -> dict:
        return {}

    @staticmethod
    def check_prepared_datasets(storage_dir: str) -> bool:
        return all(os.path.exists(os.path.join(storage_dir, f))
                   for f in _OUTPUT_FILES.values())

    @staticmethod
    def check_raw_datasets(storage_dir: str) -> bool:
        return (os.path.exists(os.path.join(storage_dir,
                                            "list_eval_partition.txt"))
                and os.path.exists(os.path.join(storage_dir,
                                                "list_attr_celeba.txt")))

    @staticmethod
    def download(download_dir: str) -> bool:
        raise NotImplementedError(
            "CelebA requires manual download (aligned images + "
            "list_eval_partition.txt + list_attr_celeba.txt into "
            "--raw_dataset_dir)")

    @staticmethod
    def convert_to_tfrecord(download_dir: str, storage_dir: str) -> None:
        os.makedirs(storage_dir, exist_ok=True)
        split_lists: dict[str, list[str]] = {"train": [], "validate": [],
                                             "test": []}
        split_by_code = {0: "train", 1: "validate", 2: "test"}
        with open(os.path.join(download_dir, "list_eval_partition.txt")) as f:
            for line in f:
                parts = line.split()
                if len(parts) == 2:
                    split_lists[split_by_code[int(parts[1])]].append(parts[0])

        attributes: dict[str, np.ndarray] = {}
        with open(os.path.join(download_dir, "list_attr_celeba.txt")) as f:
            for line in f.readlines()[2:]:
                d = line.strip().split()
                attributes[d[0]] = np.array([x == "1" for x in d[1:]],
                                            dtype=np.bool_)

        png_dir = os.path.join(download_dir, "img_align_celeba_png")
        jpg_dir = os.path.join(download_dir, "img_align_celeba_jpg")
        flat_dir = os.path.join(download_dir, "img_align_celeba")

        def image_path(fn: str) -> str:
            p = os.path.join(png_dir if fn.endswith(".png") else jpg_dir, fn)
            return p if os.path.exists(p) else os.path.join(flat_dir, fn)

        for split, files in split_lists.items():
            out = os.path.join(storage_dir, _OUTPUT_FILES[split])
            with TFRecordWriter(out) as w:
                for fn in files:
                    with open(image_path(fn), "rb") as img_f:
                        data = img_f.read()
                    w.write(proto.example({
                        "image": bytes_feature(data),
                        "filename": bytes_feature(fn.encode()),
                        "attributes": bytes_feature(attributes[fn].tobytes()),
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
