"""Host-side image decode and resize for the dataset plugins (counterpart of
``hemx.data.imageio``), without PIL on the PNG path.

``hemx`` decodes with PIL and resizes with PIL's ``BILINEAR``; the machine
the port trains on may have no Pillow. Here PNG is decoded with ``zlib``
and numpy, and the resize is a numpy copy of Pillow's separable resampler
(``libImaging/Resample.c``), so both give ``hemx``'s arrays bit for bit
(pinned by ``tests/test_torch_datasets.py``):

* ``decode_image`` reads 8-bit PNGs of colour types 0 (grey), 2 (RGB),
  3 (palette), 4 (grey + alpha) and 6 (RGBA) and converts them as PIL's
  ``convert("RGB")`` / ``convert("L")`` do: alpha dropped, grey
  replicated, the palette looked up, luma in PIL's 16-bit fixed point.
  Interlaced (Adam7) files, bit depths below 8 and 16-bit colour are
  refused. Other formats (JPEG) go to PIL, imported when needed; without
  Pillow that raises, naming it.
* ``decode_png16`` reads 16-bit greyscale PNGs (NYUv2 depth).
* ``resize_bilinear`` resizes uint8 images in 22-bit fixed point and float
  images in float64 sums stored as float32, the horizontal pass first.

The scanline filters None, Sub and Up are vectorised (runs of rows at
once); Average and Paeth depend on the byte one pixel to the left and run
as a Python loop along the row, which is the decode's cost.
"""

from __future__ import annotations

import io
import math
import struct
import zlib

import numpy as np

_PNG_SIG = b"\x89PNG\r\n\x1a\n"
# PNG colour type -> samples per pixel
_SAMPLES = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
# PIL's ITU-R 601-2 luma in 16-bit fixed point (libImaging/Convert.c L24)
_LUMA = (19595, 38470, 7471)
_PRECISION_BITS = 22  # Resample.c: 32 - 8 - 2


# --- PNG --------------------------------------------------------------------

def _read_png(data: bytes, depths: tuple) -> tuple:
    """(width, height, bit depth, colour type, palette, inflated data);
    refuses a bit depth not in ``depths``."""
    ihdr, palette, idat = None, None, []
    pos = len(_PNG_SIG)
    while pos + 8 <= len(data):
        length, tag = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        if len(body) < length:
            raise ValueError(f"PNG chunk {tag!r} is truncated")
        pos += 12 + length
        if tag == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", body)
        elif tag == b"PLTE":
            palette = body
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
    if ihdr is None or not idat:
        raise ValueError("PNG without IHDR or IDAT")
    width, height, depth, ctype, _, _, interlace = ihdr
    if ctype not in _SAMPLES:
        raise ValueError(f"PNG colour type {ctype} is invalid")
    if interlace:
        raise ValueError("interlaced (Adam7) PNGs are not supported")
    if depth not in depths:
        raise ValueError(f"PNG bit depth {depth} is not supported here "
                         f"(supported: {depths}; decode_png16 reads 16-bit "
                         f"greyscale)")
    if ctype == 3 and palette is None:
        raise ValueError("palette PNG without a PLTE chunk")
    return width, height, depth, ctype, palette, zlib.decompress(b"".join(idat))


def _unfilter_average(raw, prior, bpp: int) -> list:
    r, b = raw.tolist(), prior.tolist()
    out = r[:]
    for lane in range(bpp):  # each byte lane is its own recurrence
        a = 0
        for i in range(lane, len(r), bpp):
            a = (r[i] + ((a + b[i]) >> 1)) & 255
            out[i] = a
    return out


def _unfilter_paeth(raw, prior, bpp: int) -> list:
    r, b = raw.tolist(), prior.tolist()
    out = r[:]
    for lane in range(bpp):  # a: decoded left byte; c: prior row's left byte
        a = c = 0
        for i in range(lane, len(r), bpp):
            bi = b[i]
            # p = a + b - c; |p - a| = |b - c|, |p - b| = |a - c|
            pa = bi - c if bi >= c else c - bi
            pb = a - c if a >= c else c - a
            pc = a + bi - c - c
            if pc < 0:
                pc = -pc
            if pa <= pb and pa <= pc:
                pred = a
            elif pb <= pc:
                pred = bi
            else:
                pred = c
            a = (r[i] + pred) & 255
            out[i] = a
            c = bi
    return out


def _unfilter(raw: bytes, height: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the per-scanline filters: (height, stride) uint8."""
    buf = np.frombuffer(raw, np.uint8)
    if buf.size < height * (stride + 1):
        raise ValueError("PNG image data is truncated")
    rows = buf[:height * (stride + 1)].reshape(height, stride + 1)
    kinds, data = rows[:, 0], rows[:, 1:]
    if kinds.size and kinds.max() > 4:
        raise ValueError(f"PNG filter type {int(kinds.max())} is invalid")
    out = np.empty((height, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    y = 0
    while y < height:
        kind = kinds[y]
        if kind in (3, 4):
            fn = _unfilter_average if kind == 3 else _unfilter_paeth
            out[y] = fn(data[y], prior, bpp)
            prior = out[y]
            y += 1
            continue
        end = y + 1
        while end < height and kinds[end] == kind:
            end += 1
        if kind == 0:    # None
            out[y:end] = data[y:end]
        elif kind == 1:  # Sub: per-lane running sum along the row, mod 256
            out[y:end] = np.cumsum(data[y:end].reshape(end - y, -1, bpp),
                                   axis=1, dtype=np.uint8).reshape(end - y, -1)
        else:            # Up: running sum down the columns from the prior row
            out[y:end] = np.cumsum(
                np.concatenate([prior[None], data[y:end]]), axis=0,
                dtype=np.uint8)[1:]
        prior = out[end - 1]
        y = end
    return out


def _decode_png_samples(data: bytes, depths: tuple) -> tuple:
    """(samples (H, W, S) uint8, or uint16 from big-endian 16-bit samples;
    colour type; palette)."""
    width, height, depth, ctype, palette, raw = _read_png(data, depths)
    nbytes = depth // 8
    bpp = _SAMPLES[ctype] * nbytes
    rows = _unfilter(raw, height, width * bpp, bpp)
    if depth == 16:
        samples = rows.view(">u2").astype(np.uint16)
    else:
        samples = rows
    return samples.reshape(height, width, _SAMPLES[ctype]), ctype, palette


def _luma(rgb: np.ndarray) -> np.ndarray:
    w = np.array(_LUMA, np.int64)
    return ((rgb[..., :3].astype(np.int64) @ w + 0x8000) >> 16).astype(np.uint8)


def _palette(palette: bytes) -> np.ndarray:
    """(256, 3) uint8; entries past the PLTE chunk are black."""
    table = np.zeros((256, 3), np.uint8)
    entries = np.frombuffer(palette, np.uint8)[:768]
    entries = entries[:entries.size // 3 * 3].reshape(-1, 3)
    table[:len(entries)] = entries
    return table


def _pil_open(data: bytes):
    try:
        from PIL import Image
    except ImportError:
        raise ImportError(
            "this image is not a PNG; decoding it (JPEG and other formats) "
            "needs Pillow, which is not installed") from None
    return Image.open(io.BytesIO(data))


def decode_image(data: bytes, channels: int = 3) -> np.ndarray:
    """Decode image bytes -> (H, W, channels) uint8 (``channels`` 3: RGB,
    1: luma; any other value keeps the file's own samples, palette indices
    for a palette PNG, as PIL does)."""
    if not data.startswith(_PNG_SIG):
        img = _pil_open(data)
        if channels in (1, 3):
            img = img.convert("RGB" if channels == 3 else "L")
        arr = np.asarray(img)
        return arr[:, :, None] if arr.ndim == 2 else arr
    samples, ctype, palette = _decode_png_samples(data, (8,))
    if channels not in (1, 3):
        return samples
    if ctype == 3:
        rgb = _palette(palette)[samples[:, :, 0]]
    elif ctype in (0, 4):
        grey = np.ascontiguousarray(samples[:, :, :1])
        return grey if channels == 1 else np.repeat(grey, 3, axis=2)
    else:
        rgb = samples[:, :, :3]
    return _luma(rgb)[:, :, None] if channels == 1 else np.ascontiguousarray(rgb)


def decode_png16(data: bytes) -> np.ndarray:
    """Decode a 16-bit greyscale PNG (NYUv2 depth maps) -> (H, W, 1)
    uint16; an 8-bit greyscale PNG gives its values as uint16."""
    if not data.startswith(_PNG_SIG):
        arr = np.asarray(_pil_open(data))
        return (arr[:, :, None] if arr.ndim == 2 else arr).astype(np.uint16)
    samples, ctype, _ = _decode_png_samples(data, (8, 16))
    if ctype != 0:
        raise ValueError(f"decode_png16 reads greyscale PNGs; colour type "
                         f"{ctype}")
    return samples.astype(np.uint16)


def image_shape(data: bytes) -> tuple:
    """``decode_image(data).shape`` (RGB) without decoding a PNG: its IHDR
    gives (H, W, 3)."""
    if data.startswith(_PNG_SIG) and data[12:16] == b"IHDR":
        width, height = struct.unpack(">II", data[16:24])
        return (height, width, 3)
    return decode_image(data).shape


def encode_png_bytes(img: np.ndarray) -> bytes:
    from hemx_torch.summaries.png import encode_png
    return encode_png(np.asarray(img, np.uint8))


# --- resize -----------------------------------------------------------------

def _coefficients(in_size: int, out_size: int) -> tuple:
    """Pillow's ``precompute_coeffs`` for the bilinear filter: per output
    pixel, the source index of each tap (clamped; weight 0 past ``xmax``)
    and its normalised weight."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 1.0 * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    center = (np.arange(out_size) + 0.5) * scale
    xmin = np.maximum(np.trunc(center - support + 0.5), 0).astype(np.int64)
    xmax = (np.minimum(np.trunc(center + support + 0.5).astype(np.int64),
                       in_size) - xmin)
    taps = np.arange(ksize)
    x = (((taps[None, :] + xmin[:, None]).astype(np.float64)
          - center[:, None] + 0.5) * (1.0 / filterscale))
    w = np.where(np.abs(x) < 1.0, 1.0 - np.abs(x), 0.0)
    w = np.where(taps[None, :] < xmax[:, None], w, 0.0)
    total = np.zeros(out_size)
    for t in range(ksize):  # summed in tap order, as Pillow does
        total = total + w[:, t]
    w = np.where(total[:, None] != 0.0, w / np.where(total == 0.0, 1.0,
                                                     total)[:, None], w)
    idx = np.minimum(taps[None, :] + xmin[:, None], in_size - 1)
    return idx, w


def _resample(img: np.ndarray, out_size: int, axis: int) -> np.ndarray:
    """One separable pass of ``img`` (H, W, C) along ``axis`` (1: width,
    0: height)."""
    idx, w = _coefficients(img.shape[axis], out_size)
    shape = [1, 1, 1]
    shape[axis] = out_size
    if img.dtype == np.uint8:
        # Resample.c normalize_coeffs_8bpc: 22-bit fixed point rounded away
        # from zero, accumulation from 1 << 21, >> 22 and clip8
        k = np.where(w < 0, np.trunc(-0.5 + w * (1 << _PRECISION_BITS)),
                     np.trunc(0.5 + w * (1 << _PRECISION_BITS))).astype(np.int64)
        acc = np.full(img.shape[:axis] + (out_size,) + img.shape[axis + 1:],
                      1 << (_PRECISION_BITS - 1), np.int64)
        for t in range(idx.shape[1]):
            acc += (np.take(img, idx[:, t], axis=axis).astype(np.int64)
                    * k[:, t].reshape(shape))
        return np.clip(acc >> _PRECISION_BITS, 0, 255).astype(np.uint8)
    acc = np.zeros(img.shape[:axis] + (out_size,) + img.shape[axis + 1:])
    for t in range(idx.shape[1]):
        acc = acc + (np.take(img, idx[:, t], axis=axis).astype(np.float64)
                     * w[:, t].reshape(shape))
    return acc.astype(np.float32)


def resize_bilinear(img: np.ndarray, height: int, width: int) -> np.ndarray:
    """Bilinear resize of (H, W, C) uint8 (C 1 or 3) or float -> (height,
    width, C), equal to PIL's ``Image.resize((width, height), BILINEAR)``
    (float channels each in PIL's 'F' mode; the result keeps the input's
    float dtype)."""
    arr = np.asarray(img)
    if arr.ndim == 2:
        arr = arr[:, :, None]
    floating = np.issubdtype(arr.dtype, np.floating)
    if floating:
        out = arr.astype(np.float32)
    elif arr.dtype == np.uint8 and arr.shape[-1] in (1, 3):
        out = arr
    else:
        raise ValueError(f"resize_bilinear takes uint8 images of 1 or 3 "
                         f"channels or float images; got {arr.dtype} "
                         f"{arr.shape}")
    if out.shape[1] != width:
        out = _resample(out, int(width), axis=1)
    if out.shape[0] != height:
        out = _resample(out, int(height), axis=0)
    if out is arr:
        out = arr.copy()
    return out.astype(arr.dtype) if floating else out
