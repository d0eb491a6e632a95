"""Image ops (counterpart of ``hemx.ops.images``).

``rescale``, ``center_crop`` and ``crop_to_bounding_box`` take NCHW tensors
(the port's layout; hemx's take NHWC) and crop the same pixels.
``colorize`` runs on the host at summary time, on NHWC numpy arrays as in
hemx, which calls matplotlib's ``jet``. The port carries jet's segment
data and builds matplotlib's 256-entry lookup table with numpy
(``matplotlib.colors._create_lookup_table``), and picks entries as a
``Colormap`` call does: ``x * 256`` truncated, 1.0 mapped to the last
entry, values below 0 to the first, above 1 to the last, NaN to
transparent black. So summaries need no matplotlib; a test holds the
result equal to matplotlib's.
"""

from __future__ import annotations

import numpy as np
import torch


def rescale(x, orig_range, new_range):
    """Linear range remap (reference: hem/ops/images.py:53-70)."""
    o_lo, o_hi = orig_range
    n_lo, n_hi = new_range
    return (x - o_lo) * (n_hi - n_lo) / (o_hi - o_lo) + n_lo


def center_crop(x: torch.Tensor, fraction: float) -> torch.Tensor:
    """Central crop of NCHW ``x`` to ``round(H * fraction)`` x
    ``round(W * fraction)`` (65 -> 31 at 0.4769), top-left at the floor of
    the margin (reference: hem/ops/images.py:92-95)."""
    h, w = x.shape[2:]
    ch, cw = int(round(h * fraction)), int(round(w * fraction))
    top, left = (h - ch) // 2, (w - cw) // 2
    return x[:, :, top:top + ch, left:left + cw]


def crop_to_bounding_box(x: torch.Tensor, offset_h: int, offset_w: int,
                         target_h: int, target_w: int) -> torch.Tensor:
    """Fixed bounding-box crop of NCHW ``x`` (reference:
    hem/ops/images.py:97-101)."""
    return x[:, :, offset_h:offset_h + target_h, offset_w:offset_w + target_w]


# matplotlib's jet (matplotlib/_cm.py): per channel, (x, y0, y1) anchors
_JET = {"red": ((0.0, 0, 0), (0.35, 0, 0), (0.66, 1, 1), (0.89, 1, 1),
                (1.0, 0.5, 0.5)),
        "green": ((0.0, 0, 0), (0.125, 0, 0), (0.375, 1, 1), (0.64, 1, 1),
                  (0.91, 0, 0), (1.0, 0, 0)),
        "blue": ((0.0, 0.5, 0.5), (0.11, 1, 1), (0.34, 1, 1), (0.65, 0, 0),
                 (1.0, 0, 0))}
_N = 256


def _channel_lut(data, n: int = _N) -> np.ndarray:
    """matplotlib's ``_create_lookup_table(n, data, gamma=1.0)``."""
    adata = np.array(data, dtype=float)
    x, y0, y1 = adata[:, 0] * (n - 1), adata[:, 1], adata[:, 2]
    xind = (n - 1) * np.linspace(0, 1, n)
    ind = np.searchsorted(x, xind)[1:-1]
    distance = (xind[1:-1] - x[ind - 1]) / (x[ind] - x[ind - 1])
    lut = np.concatenate([[y1[0]], distance * (y0[ind] - y1[ind - 1])
                          + y1[ind - 1], [y0[-1]]])
    return np.clip(lut, 0.0, 1.0)


def jet_lut() -> np.ndarray:
    """(256 + 3, 3) RGB table: jet's 256 entries, then under (the first
    entry), over (the last) and bad (black), as matplotlib's ``_lut``."""
    lut = np.stack([_channel_lut(_JET[c]) for c in ("red", "green", "blue")],
                   axis=1)
    return np.concatenate([lut, lut[:1], lut[-1:], np.zeros((1, 3))])


def jet(x: np.ndarray) -> np.ndarray:
    """RGB in [0, 1] (float64) of float values ``x``, shape ``x.shape + (3,)``,
    indexed as ``matplotlib.cm.jet(x)[..., :3]`` indexes its table."""
    xa = np.array(x, dtype=float, copy=True) * _N
    xa[xa == _N] = _N - 1
    under, over, bad = xa < 0, xa >= _N, np.isnan(xa)
    with np.errstate(invalid="ignore"):
        idx = xa.astype(int)
    idx[under], idx[over], idx[bad] = _N, _N + 1, _N + 2
    return jet_lut().take(idx, axis=0, mode="clip")


def colorize(images: np.ndarray) -> np.ndarray:
    """1-channel images, (N, H, W, 1) or (H, W, 1), each min-max normalized
    on its own, -> jet RGB float32 in [0, 1] (``hemx.ops.images.colorize``;
    reference: hem/ops/images.py:10-50)."""
    arr = np.asarray(images, dtype=np.float64)
    squeeze = arr.ndim == 3
    if squeeze:
        arr = arr[None]
    arr = arr[..., 0]
    lo = arr.min(axis=(1, 2), keepdims=True)
    hi = arr.max(axis=(1, 2), keepdims=True)
    norm = (arr - lo) / np.maximum(hi - lo, 1e-12)
    rgb = jet(norm).astype(np.float32)
    return rgb[0] if squeeze else rgb
