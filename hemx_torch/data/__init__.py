"""Data layer (counterpart of ``hemx.data``): TFRecord IO (through the C++
reader of ``hemx_torch.native``), PNG decode and resize, sources, splits,
the device-resident cache and the streaming pipeline, and the dataset
plugins (mnist, cifar, floorplan, nyuv2, celeb, coco, synthetic)."""

from hemx_torch.data.plugin import DataPlugin, get_dataset, get_dataset_tensors
from hemx_torch.data.tfrecord import (TFRecordWriter, tfrecord_iterator,
                                      count_records)
from hemx_torch.data.pipeline import ArraySource, TFRecordSource, Split, Pipeline
