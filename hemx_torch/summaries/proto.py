"""Protobuf wire format for tfevents and TFRecord Examples (copy of
``hemx.summaries.proto``): Event, Summary, Summary.Image, HistogramProto and
the tf.train.Example feature messages of the data layer. Field numbers
follow tensorflow/core/util/event.proto, framework/summary.proto and
example/example.proto."""

from __future__ import annotations

import struct
from typing import Iterator, Tuple


def enc_varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def dec_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def key(field: int, wire_type: int) -> bytes:
    return enc_varint(field << 3 | wire_type)


def enc_double(field: int, v: float) -> bytes:
    return key(field, 1) + struct.pack("<d", v)


def enc_float(field: int, v: float) -> bytes:
    return key(field, 5) + struct.pack("<f", v)


def enc_int64(field: int, v: int) -> bytes:
    return key(field, 0) + enc_varint(v & 0xFFFFFFFFFFFFFFFF)


def enc_bytes(field: int, v: bytes) -> bytes:
    return key(field, 2) + enc_varint(len(v)) + v


def enc_string(field: int, v: str) -> bytes:
    return enc_bytes(field, v.encode("utf-8"))


def enc_message(field: int, body: bytes) -> bytes:
    return enc_bytes(field, body)


def enc_packed_doubles(field: int, values) -> bytes:
    body = b"".join(struct.pack("<d", float(v)) for v in values)
    return enc_bytes(field, body)


def iter_fields(buf: bytes) -> Iterator[Tuple[int, int, object]]:
    """Yield (field_number, wire_type, value) for a serialized message."""
    pos = 0
    n = len(buf)
    while pos < n:
        tag, pos = dec_varint(buf, pos)
        field, wt = tag >> 3, tag & 7
        if wt == 0:
            v, pos = dec_varint(buf, pos)
        elif wt == 1:
            v = struct.unpack("<d", buf[pos:pos + 8])[0]
            pos += 8
        elif wt == 2:
            ln, pos = dec_varint(buf, pos)
            v = buf[pos:pos + ln]
            pos += ln
        elif wt == 5:
            v = struct.unpack("<f", buf[pos:pos + 4])[0]
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wt}")
        yield field, wt, v


# --- summary.proto ---------------------------------------------------------

def summary_value_scalar(tag: str, value: float) -> bytes:
    # Summary.Value: tag=1, simple_value=2
    return enc_string(1, tag) + enc_float(2, float(value))


def summary_value_image(tag: str, png: bytes, height: int, width: int,
                        colorspace: int = 3) -> bytes:
    # Summary.Image: height=1, width=2, colorspace=3, encoded_image_string=4
    img = (enc_int64(1, height) + enc_int64(2, width)
           + enc_int64(3, colorspace) + enc_bytes(4, png))
    return enc_string(1, tag) + enc_message(4, img)


def summary_value_histo(tag: str, *, hmin: float, hmax: float, num: float,
                        hsum: float, sum_squares: float,
                        bucket_limits, buckets) -> bytes:
    # HistogramProto: min=1, max=2, num=3, sum=4, sum_squares=5,
    # bucket_limit=6 (packed), bucket=7 (packed)
    h = (enc_double(1, hmin) + enc_double(2, hmax) + enc_double(3, num)
         + enc_double(4, hsum) + enc_double(5, sum_squares)
         + enc_packed_doubles(6, bucket_limits) + enc_packed_doubles(7, buckets))
    return enc_string(1, tag) + enc_message(5, h)


def summary(values: list[bytes]) -> bytes:
    # Summary: repeated Value value = 1
    return b"".join(enc_message(1, v) for v in values)


# --- event.proto -----------------------------------------------------------

def event(wall_time: float, step: int = 0, *, file_version: str | None = None,
          summary_bytes: bytes | None = None) -> bytes:
    # Event: wall_time=1 (double), step=2 (int64), file_version=3, summary=5
    out = enc_double(1, wall_time)
    if step:
        out += enc_int64(2, step)
    if file_version is not None:
        out += enc_string(3, file_version)
    if summary_bytes is not None:
        out += enc_message(5, summary_bytes)
    return out


# --- example.proto (tf.train.Example) --------------------------------------

def feature_bytes(values: list[bytes]) -> bytes:
    # Feature{bytes_list=1{value=1}}
    bl = b"".join(enc_bytes(1, v) for v in values)
    return enc_message(1, bl)


def feature_int64(values) -> bytes:
    # Feature{int64_list=3{value=1 packed}}
    body = b"".join(enc_varint(int(v) & 0xFFFFFFFFFFFFFFFF) for v in values)
    il = enc_bytes(1, body)  # packed repeated int64
    return enc_message(3, il)


def feature_float(values) -> bytes:
    # Feature{float_list=2{value=1 packed}}
    body = b"".join(struct.pack("<f", float(v)) for v in values)
    fl = enc_bytes(1, body)
    return enc_message(2, fl)


def example(features: dict[str, bytes]) -> bytes:
    # Example{features=1{feature=1 map<string,Feature>}}
    entries = b""
    for name, feat in features.items():
        entry = enc_string(1, name) + enc_message(2, feat)
        entries += enc_message(1, entry)
    return enc_message(1, entries)


def parse_example(buf: bytes) -> dict[str, dict]:
    """Decode a tf.train.Example into {name: {'bytes'|'int64'|'float': list}}."""
    result: dict[str, dict] = {}
    for f, wt, v in iter_fields(buf):          # Example
        if f != 1:
            continue
        for f2, wt2, v2 in iter_fields(v):     # Features
            if f2 != 1:
                continue
            name = None
            feat = None
            for f3, wt3, v3 in iter_fields(v2):  # map entry
                if f3 == 1:
                    name = v3.decode("utf-8")
                elif f3 == 2:
                    feat = v3
            if name is None or feat is None:
                continue
            result[name] = _parse_feature(feat)
    return result


def _parse_feature(buf: bytes) -> dict:
    for f, wt, v in iter_fields(buf):  # Feature oneof
        if f == 1:   # BytesList
            vals = [x for ff, _, x in iter_fields(v) if ff == 1]
            return {"bytes": vals}
        if f == 2:   # FloatList
            vals = []
            for ff, wt2, x in iter_fields(v):
                if ff != 1:
                    continue
                if wt2 == 2:  # packed
                    vals.extend(struct.unpack(f"<{len(x)//4}f", x))
                else:
                    vals.append(x)
            return {"float": vals}
        if f == 3:   # Int64List
            vals = []
            for ff, wt2, x in iter_fields(v):
                if ff != 1:
                    continue
                if wt2 == 2:  # packed
                    pos = 0
                    while pos < len(x):
                        n, pos = dec_varint(x, pos)
                        if n >= 1 << 63:
                            n -= 1 << 64
                        vals.append(n)
                else:
                    if x >= 1 << 63:
                        x -= 1 << 64
                    vals.append(x)
            return {"int64": vals}
    return {}
