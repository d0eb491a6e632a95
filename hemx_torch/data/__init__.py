"""Data layer (counterpart of ``hemx.data``): TFRecord IO, PNG decode and
resize, sources, splits, the device-resident cache and the streaming
pipeline, and the dataset plugins (mnist, cifar, floorplan, nyuv2,
celeb, coco, synthetic)."""
