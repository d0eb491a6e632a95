"""Networks of the 65x65-patch depth-estimation family (counterpart of
``hemx.models.depth_nets`` and of ``hemx.models.paper_family``'s
``noise_site_generator``).

One spatial skeleton of VALID 5x5 stride-2 convs: encoder 65 -> 31 -> 14
-> 5 -> 1, skip-connected decoder 1 -> 5 -> 14 -> 31 (the 5 -> 14 deconv is
one past the full transpose, 13: its last row and column hold the bias
only), a closing stride-1 SAME conv, optionally cropped to the top-left
29x29. Critics run separate rgb and depth conv paths merged by 1x1 convs.
Stage sizes come from the input by VALID arithmetic, so tests can run
other sizes where a net allows it.

Parameters have hemx's flat names: ``{name}_w`` (conv kernels OIHW, deconv
kernels torch's (in, out, kh, kw); ``hemx_torch.convert`` permutes the
names in ``kernels``), ``{name}_b``, and a :class:`BatchNorm` child
``{name}_bn`` (``beta``; buffers ``mean``, ``var``). Each net carries the
0-d buffer ``_`` that hemx keeps in every net's state. ``forward`` returns
``(y, stats)``, stats keyed by BN child name (``hemx_torch.ops.layers``);
each conv and deconv casts at hemx's points under a compute dtype. Noise is
an argument (NCHW), drawn by the model: ``noise_draws(n, h, w)`` names
every draw a forward takes, in hemx's draw order (:class:`Uniform` noise,
:class:`Keep` masks); a net with one uniform draw calls it ``z`` and takes
it as the tensor ``noise``.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch
import torch.nn as nn

from hemx_torch.ops import layers
from hemx_torch.ops.activations import lrelu
from hemx_torch.ops.initializers import xavier_uniform
from hemx_torch.ops.layers import CL, BatchNorm, cast_in

K = 5
ENC = (64, 128, 256, 512)


class Uniform(NamedTuple):
    """A draw of uniform noise on [lo, hi) of an NCHW ``shape``."""
    shape: tuple
    lo: float
    hi: float


class Keep(NamedTuple):
    """A boolean dropout keep mask of an NCHW ``shape``, each entry True
    with probability ``p`` (``jax.random.bernoulli``)."""
    shape: tuple
    p: float


def valid_out(size: int, k: int = K, s: int = 2) -> int:
    return (size - k) // s + 1


def enc_sizes(size: int, n: int = 4) -> list[int]:
    """[size, then each VALID 5x5 stride-2 stage's output]."""
    sizes = [size]
    for _ in range(n):
        sizes.append(valid_out(sizes[-1]))
    return sizes


class DepthNet(nn.Module):
    """Flat-named parameters and the conv/deconv/BN chain of ``hemx``'s
    ``_P``/``_A`` helpers: product (cast to the compute dtype) -> + bias
    (in the product's dtype) -> BN -> activation."""

    def __init__(self, init: Callable, generator: torch.Generator,
                 dtype: Optional[torch.dtype]):
        super().__init__()
        self.compute_dtype = dtype
        self.kernels: set = set()
        self._draw = lambda shape: init(shape, generator=generator)
        self.register_buffer("_", torch.zeros(()))

    def _param(self, name: str, t: torch.Tensor) -> None:
        self.register_parameter(name, nn.Parameter(t))

    def add_conv(self, name: str, k: int, cin: int, cout: int) -> None:
        w = self._draw((k, k, cin, cout))
        self._param(f"{name}_w", w.permute(3, 2, 0, 1).contiguous(
            memory_format=CL))
        self._param(f"{name}_b", self._draw((cout,)))
        self.kernels.add(f"{name}_w")

    def add_deconv(self, name: str, k: int, cin: int, cout: int) -> None:
        w = self._draw((k, k, cout, cin))  # hemx's [H, W, out, in]
        self._param(f"{name}_w", w.permute(3, 2, 0, 1).contiguous(
            memory_format=CL))
        self._param(f"{name}_b", self._draw((cout,)))
        self.kernels.add(f"{name}_w")

    def add_bn(self, name: str, channels: int) -> None:
        self.add_module(f"{name}_bn", BatchNorm(channels))

    def done(self) -> None:
        del self._draw  # the generator is not part of the module

    def _post(self, name, y, activation, bn, stats):
        y = y + getattr(self, f"{name}_b").view(1, -1, 1, 1).to(y.dtype)
        if bn:
            y, stats[f"{name}_bn"] = getattr(self, f"{name}_bn")(y)
        return activation(y) if activation is not None else y

    def conv(self, name, x, stride, padding, activation, bn, stats):
        x, w = cast_in(x, getattr(self, f"{name}_w"), self.compute_dtype)
        y = layers.conv2d_op(x, w, stride, padding)
        return self._post(name, y, activation, bn, stats)

    def deconv(self, name, x, out, stride, padding, activation, bn, stats):
        x, w = cast_in(x, getattr(self, f"{name}_w"), self.compute_dtype)
        y = layers.deconv2d_op(x, w, (out, out), stride, padding)
        return self._post(name, y, activation, bn, stats)

    def noise_draws(self, n: int, h: int, w: int) -> dict:
        """``{name: Uniform or Keep}`` of every draw a forward on an
        (n, C, h, w) input needs, in draw order; ``{}`` without noise."""
        return {}


def check_draws(net: DepthNet, noise: dict, n: int, h: int, w: int) -> dict:
    """``net.noise_draws(n, h, w)``, after checking that ``noise`` holds
    each of them at its shape."""
    draws = net.noise_draws(n, h, w)
    for name, d in draws.items():
        got = noise.get(name)
        if got is None or tuple(got.shape) != tuple(d.shape):
            raise ValueError(f"this net needs noise of shape {d.shape} for "
                             f"its draw {name}, got "
                             f"{None if got is None else tuple(got.shape)}")
    return draws


class ValidUnet(DepthNet):
    """The sampler/paper generator (``hemx.models.depth_nets.valid_unet``).

    * ``noise_channel``: a uniform [-1, 1] channel concatenated onto the
      input (sampler_gan.py:171-173);
    * ``garch='large'``: two stride-1 SAME convs after e1-e3 and a stride-1
      SAME deconv after each decoder stage (sampler_gan.py:174-216);
    * ``mean_at_e1``: ``forward`` takes ``y_bar`` (N, 1, 1, 1); its constant
      map is concatenated onto e1's output, and that concatenation is also
      the e1 skip (paper_cgan g_mean_provided, :244-258);
    * ``use_batch_norm``: BN on e2-e4 (not e1), on e1b-e3c, on every deconv
      and on ``final`` (which inherits it in the reference);
    * ``final_filter`` / ``final_activation`` / ``final_crop``: the closing
      stride-1 SAME conv to 1 channel, cropped to its top-left
      ``final_crop`` square.
    """

    def __init__(self, in_shape, *, noise_channel: bool = False,
                 garch: str = "small", mean_at_e1: bool = False,
                 use_batch_norm: bool = False,
                 final_activation: Optional[Callable] = torch.tanh,
                 final_filter: int = 5, final_crop: Optional[int] = None,
                 init: Callable = xavier_uniform,
                 generator: torch.Generator,
                 dtype: Optional[torch.dtype] = None):
        super().__init__(init, generator, dtype)
        if garch not in ("small", "large"):
            raise ValueError(f"unknown garch '{garch}'")
        c = in_shape[0]
        self.noise_channel, self.garch = noise_channel, garch
        self.mean_at_e1, self.use_bn = mean_at_e1, use_batch_norm
        self.final_activation, self.final_crop = final_activation, final_crop
        cin = c + (1 if noise_channel else 0)
        for i, cout in enumerate(ENC):
            if i == 1 and mean_at_e1:
                cin += 1
            self.add_conv(f"e{i+1}", K, cin, cout)
            if use_batch_norm and i > 0:
                self.add_bn(f"e{i+1}", cout)
            if garch == "large" and i < 3:
                for s in ("b", "c"):
                    self.add_conv(f"e{i+1}{s}", K, cout, cout)
                    if use_batch_norm:
                        self.add_bn(f"e{i+1}{s}", cout)
            cin = cout
        plan = [(512, 256, 256), (512, 128, 128),
                (256, 64, 64 + (1 if mean_at_e1 else 0))]
        for i, (cin_d, cout_d, skip_c) in enumerate(plan):
            self.add_deconv(f"d{i+1}", K, cin_d, cout_d)
            if use_batch_norm:
                self.add_bn(f"d{i+1}", cout_d)
            if garch == "large":
                cc = cout_d + skip_c
                self.add_deconv(f"d{i+1}b", K, cc, cc)
                if use_batch_norm:
                    self.add_bn(f"d{i+1}b", cc)
        self.add_conv("final", final_filter, 64 + 64 + (1 if mean_at_e1 else 0),
                      1)
        if use_batch_norm:
            self.add_bn("final", 1)
        self.done()

    def noise_draws(self, n, h, w):
        return ({"z": Uniform((n, 1, h, w), -1.0, 1.0)} if self.noise_channel
                else {})

    def forward(self, x, noise=None, y_bar=None):
        n, _, h, w = x.shape
        check_draws(self, {"z": noise}, n, h, w)
        sizes = enc_sizes(h)
        stats, bn = {}, self.use_bn
        if self.noise_channel:
            x = torch.cat([x, noise], dim=1)
        enc, hcur = [], x
        for i in range(4):
            if i == 1 and self.mean_at_e1:
                mean_map = y_bar.reshape(n, 1, 1, 1).expand(
                    n, 1, hcur.shape[2], hcur.shape[3])
                hcur = torch.cat([hcur, mean_map], dim=1)
                enc[-1] = hcur  # the e1 skip carries the mean channel
            hcur = self.conv(f"e{i+1}", hcur, 2, "VALID", torch.relu,
                             bn and i > 0, stats)
            if self.garch == "large" and i < 3:
                for s in ("b", "c"):
                    hcur = self.conv(f"e{i+1}{s}", hcur, 1, "SAME",
                                     torch.relu, bn, stats)
            enc.append(hcur)
        y = hcur
        for i, skip in enumerate((2, 1, 0)):
            target = sizes[3 - i]
            y = self.deconv(f"d{i+1}", y, target, 2, "VALID", lrelu, bn,
                            stats)
            y = torch.cat([y, enc[skip]], dim=1)
            if self.garch == "large":
                y = self.deconv(f"d{i+1}b", y, target, 1, "SAME", lrelu, bn,
                                stats)
        y = self.conv("final", y, 1, "SAME", self.final_activation, bn, stats)
        if self.final_crop:
            y = y[:, :, :self.final_crop, :self.final_crop]
        return y, stats


NOISE_SITES = ["x", "e1", "e2", "e3", "e4", "e4-512", "d2", "d3", "d4"]


class NoiseSiteGenerator(DepthNet):
    """paper_sampler's generator (``hemx.models.paper_family.
    noise_site_generator``): the VALID skeleton with uniform [0, 1) noise
    concatenated at one site, ``noise_layer`` in :data:`NOISE_SITES`
    (paper_sampler.py:159-240). At ``e1``-``e3`` the noise joins the
    encoder's next input but not the skip, which is taken before it
    (paper_sampler.py:176); ``e4`` is one channel at 1x1, ``e4-512`` 512;
    ``d2``-``d4`` join the decoder's input after the skip concat. ReLU
    encoder (BN on every stage under ``e_bn``), lrelu decoder, a 1x1
    linear head, cropped to 29x29."""

    def __init__(self, in_shape, *, noise_layer: str = "x",
                 e_bn: bool = False, generator: torch.Generator,
                 dtype: Optional[torch.dtype] = None):
        super().__init__(xavier_uniform, generator, dtype)
        if noise_layer not in NOISE_SITES:
            raise ValueError(f"unknown noise_layer '{noise_layer}'")
        self.noise_layer, self.e_bn = noise_layer, e_bn
        cin = in_shape[0] + (1 if noise_layer == "x" else 0)
        for i, ch in enumerate(ENC):
            if noise_layer == f"e{i}":
                cin += 1
            self.add_conv(f"e{i+1}", K, cin, ch)
            if e_bn:
                self.add_bn(f"e{i+1}", ch)
            cin = ch
        extra = {"e4": 1, "e4-512": 512}.get(noise_layer, 0)
        self.add_deconv("d1", K, 512 + extra, 256)
        self.add_deconv("d2", K, 512 + (noise_layer == "d2"), 128)
        self.add_deconv("d3", K, 256 + (noise_layer == "d3"), 64)
        self.add_conv("d4", 1, 128 + (noise_layer == "d4"), 1)
        self.done()

    def noise_draws(self, n, h, w):
        sizes = enc_sizes(h)
        site = self.noise_layer
        shape = {"x": (n, 1, h, w), "e1": (n, 1, sizes[1], sizes[1]),
                 "e2": (n, 1, sizes[2], sizes[2]),
                 "e3": (n, 1, sizes[3], sizes[3]), "e4": (n, 1, 1, 1),
                 "e4-512": (n, 512, 1, 1), "d2": (n, 1, sizes[3], sizes[3]),
                 "d3": (n, 1, sizes[2], sizes[2]),
                 "d4": (n, 1, sizes[1], sizes[1])}[site]
        return {"z": Uniform(shape, 0.0, 1.0)}

    def forward(self, x, noise=None):
        n, _, h, w = x.shape
        check_draws(self, {"z": noise}, n, h, w)
        site, stats = self.noise_layer, {}
        sizes = enc_sizes(h)
        if site == "x":
            x = torch.cat([x, noise], dim=1)
        enc, hcur = [], x
        for i in range(4):
            hcur = self.conv(f"e{i+1}", hcur, 2, "VALID", torch.relu,
                             self.e_bn, stats)
            enc.append(hcur)
            if site == f"e{i+1}" and i < 3:
                hcur = torch.cat([hcur, noise], dim=1)
        y = enc[-1]
        if site in ("e4", "e4-512"):
            y = torch.cat([y, noise], dim=1)
        for i, skip in enumerate((2, 1, 0)):
            y = self.deconv(f"d{i+1}", y, sizes[3 - i], 2, "VALID", lrelu,
                            False, stats)
            y = torch.cat([y, enc[skip]], dim=1)
            if site == f"d{i+2}":
                y = torch.cat([y, noise], dim=1)
        y = self.conv("d4", y, 1, "SAME", None, False, stats)
        return y[:, :, :29, :29], stats


class TwoPathDisc(DepthNet):
    """Separate rgb and depth conv paths merged by 1x1 convs
    (``hemx.models.depth_nets.two_path_disc``); ``forward((x, depth))``.

    * ``'paper'``: rgb four VALID stride-2 convs to 1x1x512, depth (29x29)
      three to 1x1x512, then 1x1 convs 1024 -> 1024 -> 512 -> 1 logit; no BN
      (paper_cgan d_baseline, :318-341);
    * ``'early'``: one rgb conv 65 -> 31, a stride-1 SAME depth conv,
      concat, three VALID stride-2 convs to 1x1x512 "logits"; under
      ``use_batch_norm`` BN on h1-h3, h3 without activation
      (sampler_gan.py:232-239);
    * ``'late'``: two four-conv paths (the depth path's first conv stride-1
      SAME), concat at 1x1, a 5x5 SAME conv 1024 -> 1024 and a 1x1 stride-2
      SAME conv -> 512 with lrelu; BN on hx2-hx4, hy2-hy4, ha and hb
      (sampler_gan.py:240-257).

    ``rgb_extra_channels`` / ``depth_extra_channels``: conditioning channels
    the caller concatenates onto each input.
    """

    def __init__(self, in_shape, *, variant: str = "paper",
                 use_batch_norm: bool = False, depth_extra_channels: int = 0,
                 rgb_extra_channels: int = 0,
                 init: Callable = xavier_uniform,
                 generator: torch.Generator,
                 dtype: Optional[torch.dtype] = None):
        super().__init__(init, generator, dtype)
        self.variant, self.use_bn = variant, use_batch_norm
        c_rgb = in_shape[0] + rgb_extra_channels
        c_depth = 1 + depth_extra_channels
        paths = [(c_rgb, 64), (64, 128), (128, 256), (256, 512)]
        if variant == "paper":
            for i, (cin, cout) in enumerate(paths):
                self.add_conv(f"hx{i+1}", K, cin, cout)
            for i, (cin, cout) in enumerate([(c_depth, 128), (128, 256),
                                             (256, 512)]):
                self.add_conv(f"hy{i+1}", K, cin, cout)
            for name, cin, cout in [("h1", 1024, 1024), ("h2", 1024, 512),
                                    ("h3", 512, 1)]:
                self.add_conv(name, 1, cin, cout)
        elif variant == "early":
            self.add_conv("rgb", K, c_rgb, 64)
            self.add_conv("depth", K, c_depth, 64)
            for name, cin, cout in [("h1", 128, 256), ("h2", 256, 512),
                                    ("h3", 512, 512)]:
                self.add_conv(name, K, cin, cout)
                if use_batch_norm:
                    self.add_bn(name, cout)
        elif variant == "late":
            for p in ("x", "y"):
                first = c_rgb if p == "x" else c_depth
                for i, (cin, cout) in enumerate([(first, 64)] + paths[1:]):
                    self.add_conv(f"h{p}{i+1}", K, cin, cout)
                    if use_batch_norm and i > 0:
                        self.add_bn(f"h{p}{i+1}", cout)
            self.add_conv("ha", K, 1024, 1024)
            self.add_conv("hb", 1, 1024, 512)
            if use_batch_norm:
                self.add_bn("ha", 1024)
                self.add_bn("hb", 512)
        else:
            raise ValueError(f"unknown disc variant {variant}")
        self.done()

    def forward(self, xy):
        x, depth = xy
        stats, bn = {}, self.use_bn
        if self.variant == "paper":
            h1 = x
            for i in range(4):
                h1 = self.conv(f"hx{i+1}", h1, 2, "VALID", lrelu, False, stats)
            h2 = depth
            for i in range(3):
                h2 = self.conv(f"hy{i+1}", h2, 2, "VALID", lrelu, False, stats)
            h = torch.cat([h1, h2], dim=1)
            h = self.conv("h1", h, 1, "SAME", lrelu, False, stats)
            h = self.conv("h2", h, 1, "SAME", lrelu, False, stats)
            h = self.conv("h3", h, 1, "SAME", None, False, stats)
        elif self.variant == "early":
            rgb = self.conv("rgb", x, 2, "VALID", lrelu, False, stats)
            dep = self.conv("depth", depth, 1, "SAME", lrelu, False, stats)
            h = torch.cat([rgb, dep], dim=1)
            h = self.conv("h1", h, 2, "VALID", lrelu, bn, stats)
            h = self.conv("h2", h, 2, "VALID", lrelu, bn, stats)
            h = self.conv("h3", h, 2, "VALID", None, bn, stats)
        else:
            h1 = x
            for i in range(4):
                h1 = self.conv(f"hx{i+1}", h1, 2, "VALID", lrelu, bn and i > 0,
                               stats)
            h2 = self.conv("hy1", depth, 1, "SAME", lrelu, False, stats)
            for i in range(1, 4):
                h2 = self.conv(f"hy{i+1}", h2, 2, "VALID", lrelu, bn, stats)
            h = torch.cat([h1, h2], dim=1)
            h = self.conv("ha", h, 1, "SAME", lrelu, bn, stats)
            h = self.conv("hb", h, 2, "SAME", lrelu, bn, stats)
        return h, stats
