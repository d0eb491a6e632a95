"""Spatial parallelism: hemx's ``spatial`` mesh axis
(``--spatial_parallel S``).

hemx shards the height of every batch leaf of rank >= 3 whose height ``S``
divides (``hemx.parallel.mesh.batch_spec``) and GSPMD inserts the conv halo
exchanges. Here rank ``a`` of an axis group holds rows
``[a*H/S : (a+1)*H/S)`` of each image of its data shard (the feeders
deliver only those, ``dp.host_slice`` and the input kernel's ``rows``),
and every parameter whole.

Which tensors are bands is a property of a network's forward, kept in a
scope (:func:`bands`) that the model code opens around each network it
runs on bands, saying whether the network's input is a band:

* conv and deconv on a band (:func:`conv2d`, :func:`deconv2d`) fetch the
  kernel-overlap rows from the neighbouring bands (:func:`_rows`), which
  depend on hemx's asymmetric SAME padding, the deconv's SAME crop and
  ``output_padding``, and VALID padding; an output height ``S`` does not
  divide gathers the input to whole height first and the rest of the
  network runs whole, as hemx's ``batch_spec`` falls back;
* BN statistics, and every ``dp.global_sum``, go over data x spatial
  while the tensors are bands (``dp.batch_group``);
* the NHWC ``Flatten`` before a dense layer gathers the bands
  (:func:`gather`), and the rest runs whole; an ``Unflatten`` in a scope
  cuts the whole tensor back to this rank's band (:func:`cut`).

Convention: every rank's loss is a term, hemx's loss is their mean over
all ranks and the gradients are averaged over all ranks (every rank holds
the whole model), as under data parallelism. So a value the ranks of an
axis group share (a critic's score after the gather) is one term on each
of them, and the backward of each collective is its exact adjoint over
the group: :func:`gather`'s is a reduce-scatter (the sum of every rank's
gradient of the band), :func:`cut`'s places the band's gradient in zeros,
and the halo's sends each fetched row's gradient back to its band.
"""

from __future__ import annotations

import contextlib
import contextvars
import math

import torch
import torch.nn.functional as F

from hemx_torch.parallel import dp, tp


class Bands:
    """The state of one network's forward under :func:`bands`: whether
    its tensors are still bands."""

    def __init__(self, banded: bool):
        self.banded = banded

    def band(self, y: torch.Tensor) -> torch.Tensor:
        """This rank's band of the network's output ``y``."""
        return y if self.banded else cut(y)

    def rows(self, y: torch.Tensor, h: int) -> torch.Tensor:
        """This rank's band of rows ``[0, h)`` of the output ``y`` (a
        decoder's output cropped to its input height ``h``)."""
        if not active():
            return y[:, :, :h]
        if self.banded and y.shape[2] * size() == h:
            return y
        whole = gather(y) if self.banded else y
        return cut(whole[:, :, :h])


_scope = contextvars.ContextVar("hemx_torch_sp_scope", default=None)


def active() -> bool:
    return dp.spatial_axis_size() > 1


def size() -> int:
    return dp.spatial_axis_size()


@contextlib.contextmanager
def bands(banded: bool = True):
    """A network's forward whose input is a band (``banded``) or a whole
    tensor that its ``Unflatten`` cuts; yields its :class:`Bands`. Outside
    a spatial axis it changes nothing."""
    state = Bands(banded and active())
    token = _scope.set(state if active() else None)
    try:
        yield state
    finally:
        _scope.reset(token)


def banded() -> bool:
    """The tensors of the forward in progress are bands."""
    state = _scope.get()
    return state is not None and state.banded and active()


def height(x: torch.Tensor) -> int:
    """The whole height of ``x`` (of the tensor it is a band of)."""
    return x.shape[2] * size() if banded() else x.shape[2]


def leave() -> None:
    """The forward in progress has gathered its tensors to whole height."""
    _scope.get().banded = False


def enter(x: torch.Tensor) -> torch.Tensor:
    """An ``Unflatten``'s output: in a scope, cut to this rank's band when
    ``S`` divides its height (the rest of the forward runs on bands)."""
    state = _scope.get()
    if state is None or state.banded or not active():
        return x
    if x.shape[2] < size() or x.shape[2] % size():
        return x
    state.banded = True
    return cut(x)


# -- the pairs ---------------------------------------------------------------

def _gather_h(x):
    return tp.all_gather(x, 2, dp.axis_group(), dp.axis_size(),
                         dp.axis_index())


def _reduce_scatter_h(x):
    return tp.take(tp.all_reduce(x, dp.axis_group()), 2, dp.axis_size(),
                   dp.axis_index())


def _take_h(x):
    return tp.take(x, 2, dp.axis_size(), dp.axis_index())


def _place_h(x):
    k, a = dp.axis_size(), dp.axis_index()
    n = x.shape[2]
    return F.pad(x, (0, 0, a * n, (k - 1 - a) * n))


def gather(x: torch.Tensor) -> torch.Tensor:
    """The whole height from the bands (all-gather); backward: the sum of
    every rank's gradient of this rank's band (reduce-scatter)."""
    if not active():
        return x
    return tp._Linear.apply(x, _gather_h, _reduce_scatter_h)


def cut(x: torch.Tensor) -> torch.Tensor:
    """This rank's band of a whole tensor; backward: the band's gradient
    in zeros of the whole height."""
    if not active():
        return x
    return tp._Linear.apply(x, _take_h, _place_h)


def _halo_fwd(top: int, bot: int):
    """Rows ``top`` above and ``bot`` below this rank's band from its
    neighbours (zeros beyond the image): one all-reduce of a buffer in
    which each rank writes, in its slot, its last ``top`` rows then its
    first ``bot`` rows."""
    def fwd(x):
        k, a = dp.axis_size(), dp.axis_index()
        hb = x.shape[2]
        slot = torch.cat([x[:, :, hb - top:], x[:, :, :bot]], 2)
        buf = tp.all_gather(slot.unsqueeze(0), 0, dp.axis_group(), k, a)
        up = (buf[a - 1, :, :, :top] if a > 0
              else x.new_zeros(x.shape[:2] + (top, x.shape[3])))
        down = (buf[a + 1, :, :, top:] if a < k - 1
                else x.new_zeros(x.shape[:2] + (bot, x.shape[3])))
        return torch.cat([up, x, down], 2)
    return fwd


def _halo_adj(top: int, bot: int):
    """The adjoint of :func:`_halo_fwd`: the gradients of the rows fetched
    sent back to the bands they came from and added there."""
    def adj(g):
        k, a = dp.axis_size(), dp.axis_index()
        hb = g.shape[2] - top - bot
        mine = g[:, :, top:top + hb]
        buf = g.new_zeros((k,) + g.shape[:2] + (top + bot, g.shape[3]))
        if a > 0:
            buf[a - 1, :, :, :top] = g[:, :, :top]
        if a < k - 1:
            buf[a + 1, :, :, top:] = g[:, :, top + hb:]
        back = tp.all_reduce(buf, dp.axis_group())[a]
        out = mine.clone()
        out[:, :, hb - top:] += back[:, :, :top]
        out[:, :, :bot] += back[:, :, top:]
        return out
    return adj


def _rows(x: torch.Tensor, need) -> torch.Tensor | None:
    """Global rows ``need(a) = [start, stop)`` of the band-sharded tensor
    ``x`` for rank ``a`` (zeros outside the image), or None when a rank
    needs rows beyond its neighbours' bands. The exchange moves the most
    rows any rank needs above and below, the same on every rank; each
    keeps its own."""
    k, a = dp.axis_size(), dp.axis_index()
    hb = x.shape[2]
    tops = [b * hb - need(b)[0] for b in range(k)]
    bots = [need(b)[1] - (b + 1) * hb for b in range(k)]
    top, bot = max(max(tops), 0), max(max(bots), 0)
    if top > hb or bot > hb:
        return None
    if top or bot:
        x = tp._Linear.apply(x, _halo_fwd(top, bot), _halo_adj(top, bot))
    return x[:, :, top - tops[a]:top + hb + bots[a]]


def _whole(x: torch.Tensor) -> torch.Tensor:
    """The fallback: the rest of the forward runs on whole height."""
    leave()
    return gather(x)


def conv2d(x: torch.Tensor, w: torch.Tensor, stride: int,
           padding: str) -> torch.Tensor:
    """``hemx_torch.ops.layers.conv2d_op`` on this rank's band ``x``;
    returns the band of the output (or, where ``S`` does not divide the
    output height, the whole output, the scope left)."""
    from hemx_torch.ops import layers
    k = size()
    h, kh, kw = x.shape[2] * k, w.shape[2], w.shape[3]
    if padding == "SAME":
        lo, hi = layers.same_padding(h, kh, stride)
        pw = layers.same_padding(x.shape[3], kw, stride)
    elif padding == "VALID":
        lo, hi, pw = 0, 0, (0, 0)
    else:
        raise ValueError(f"unknown padding '{padding}'")
    oh = (h + lo + hi - kh) // stride + 1
    ob = oh // k
    rows = None
    if oh >= k and oh % k == 0:
        rows = _rows(x, lambda b: (b * ob * stride - lo,
                                   ((b + 1) * ob - 1) * stride - lo + kh))
    if rows is None:
        return layers.conv2d_op(_whole(x), w, stride, padding)
    if any(pw):
        rows = F.pad(rows, (pw[0], pw[1], 0, 0))
    return F.conv2d(rows, w, stride=stride)


def deconv2d(x: torch.Tensor, w: torch.Tensor, out_hw: tuple[int, int],
             stride: int, padding: str) -> torch.Tensor:
    """``hemx_torch.ops.layers.deconv2d_op`` on this rank's band ``x``
    (``out_hw`` the whole output's size); returns the band of the output,
    or the whole output as :func:`conv2d` does."""
    from hemx_torch.ops import layers
    k = size()
    h, kh = x.shape[2] * k, w.shape[2]
    oh, ow = out_hw
    # the whole op's checks and its crop (lo rows on top) and extra rows
    layers.deconv_check(h, x.shape[3], w, out_hw, stride, padding)
    pad_h = (h - 1) * stride + kh - oh
    lo = max(pad_h, 0) // 2
    ob = oh // k

    def need(b):
        o0, o1 = b * ob, (b + 1) * ob
        return (math.ceil((o0 + lo - kh + 1) / stride),
                (o1 - 1 + lo) // stride + 1)

    # a kernel narrower than its stride leaves output rows no input row
    # reaches: the whole op then
    banded = oh >= k and oh % k == 0 and kh >= stride
    rows = _rows(x, need) if banded else None
    if rows is None:
        return layers.deconv2d_op(_whole(x), w, out_hw, stride, padding)
    pad_w = (x.shape[3] - 1) * stride + w.shape[3] - ow
    y = F.conv_transpose2d(rows, w, stride=stride,
                           padding=(0, max(pad_w, 0) // 2),
                           output_padding=(0, max(-pad_w, 0)))
    # row r of y is the uncropped row start*stride + r of the whole op
    first = dp.axis_index() * ob + lo - need(dp.axis_index())[0] * stride
    short = first + ob - y.shape[2]
    if short > 0:  # rows past the whole transpose: zeros, as hemx pads
        y = F.pad(y, (0, 0, 0, short))
    return y[:, :, first:first + ob, :ow]
