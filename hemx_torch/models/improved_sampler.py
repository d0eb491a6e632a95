"""Improved sampler: the thesis's second-generation conditional GAN with 8
generator and 6 discriminator architectures built from specs (counterpart
of ``hemx.models.improved_sampler``; reference:
hem/models/improved_sampler.py).

* ``GEN_SPECS`` / ``DISC_SPECS``: hemx's tables. A generator spec lists its
  stride-2 encoder stages ``(filter, channels, padding, bn)``, its decoder
  stages ``(filter, channels, bn)`` and whether the closing 1x1 conv has
  BN; a discriminator spec lists its rgb and depth stages ``(filter,
  channels, padding)`` and the channels of the 1x1 convs that merge them.
* G (:class:`SpecGenerator`): a uniform [-1, 1] noise channel concatenated
  onto the input, relu encoder, lrelu(0.2) decoder whose stage ``d{i+1}``
  undoes encoder stage ``len(enc) - i`` with that stage's padding and
  output size (B2's ``d1`` is the VALID 4x4 from 1 to 4; A*'s ``d2`` 5 ->
  14 and B1/C1's ``d2`` 6 -> 14 and ``d3`` 14 -> 31 are one past the full
  transpose and carry a bias-only last row, ``hemx_torch.ops.layers.
  deconv2d_op``), each decoder output concatenated with its skip as
  ``[y, skip]``, then a 1x1 SAME conv (BN under ``final_bn``) and tanh.
* D (:class:`SpecDiscriminator`): lrelu rgb and depth paths, concatenated
  ``[rgb, depth]``, then 1x1 convs, the last one linear; no BN.
* Input prep: image and depth rescaled to [-1, 1], the target depth cropped
  per generator (``CROPS``: the 0.4769 center crop, 65 -> 31, for A*), the
  ``EXTRAS`` channels concatenated onto G's and D's input ``[x, extras...]``.
* Loss: sigmoid cross-entropy; ``rmse`` and ``l1`` on [0, 1] depths are
  reported, ``--g_rmse`` adds the rmse to G's loss, ``--g_sparsity``
  subtracts the fraction of exact zeros in G's relu bottleneck (no
  gradient).
* A train call runs the D step and then the G step on the SAME batch
  (one batch per call), each with its own noise draw.
* Summaries add hemx's diagnostic paths: G (batch statistics, nothing
  committed) on the batch's inputs shuffled against their targets, and on
  pure uniform-noise inputs, as montages and variances.
"""

from __future__ import annotations

import numpy as np
import torch

from hemx_torch.models import common
from hemx_torch.models.conditional import (ConditionalGanBase, draw_noise,
                                           numpy_nhwc)
from hemx_torch.models.depth_nets import DepthNet, Uniform, check_draws
from hemx_torch.ops.activations import lrelu, value_fraction
from hemx_torch.ops.images import center_crop, colorize, crop_to_bounding_box
from hemx_torch.ops.initializers import xavier_uniform
from hemx_torch.ops.losses import rmse

# (filter, out_ch, padding, bn) per stride-2 encoder stage
# (filter, out_ch, bn) per stride-2 decoder stage (targets mirror encoder)
GEN_SPECS = {
    "A1": dict(enc=[(5, 64, "VALID", False), (5, 128, "VALID", True),
                    (5, 256, "VALID", True), (5, 512, "VALID", True)],
               dec=[(5, 256, True), (5, 128, True), (5, 64, True)],
               final_bn=True),
    "A2": dict(enc=[(5, 64, "VALID", False), (5, 128, "VALID", True),
                    (5, 256, "VALID", True), (5, 512, "VALID", False)],
               dec=[(5, 256, False), (5, 128, False), (5, 64, False)],
               final_bn=False),
    "A3": dict(enc=[(5, 64, "VALID", False), (5, 128, "VALID", False),
                    (5, 256, "VALID", False), (5, 512, "VALID", False)],
               dec=[(5, 256, False), (5, 128, False), (5, 64, False)],
               final_bn=False),
    "B1": dict(enc=[(5, 64, "VALID", False), (4, 128, "VALID", False),
                    (3, 256, "VALID", False), (6, 512, "VALID", False)],
               dec=[(6, 256, False), (3, 128, False), (4, 64, False)],
               final_bn=False),
    "B2": dict(enc=[(5, 64, "SAME", False), (5, 128, "SAME", False),
                    (5, 256, "SAME", False), (5, 512, "SAME", False),
                    (4, 1024, "VALID", False)],
               dec=[(4, 512, False), (5, 256, False), (5, 128, False),
                    (5, 64, False)],
               final_bn=False),
}
GEN_SPECS["C1"] = dict(GEN_SPECS["B1"],
                       dec=[(6, 256, False), (3, 128, False), (4, 64, True)])
GEN_SPECS["D1"] = GEN_SPECS["B2"]
GEN_SPECS["E1"] = GEN_SPECS["B2"]

# rgb/depth path stages: (filter, out_ch, padding); combined: channel list
DISC_SPECS = {
    "A1": dict(rgb=[(5, 64, "VALID"), (5, 128, "VALID"), (5, 256, "VALID"),
                    (5, 512, "VALID")],
               depth=[(5, 128, "VALID"), (5, 256, "VALID"), (5, 512, "VALID")],
               combined=[1024, 512, 1]),
    "B1": dict(rgb=[(5, 64, "VALID"), (4, 128, "VALID"), (3, 256, "VALID"),
                    (6, 512, "VALID")],
               depth=[(4, 128, "VALID"), (3, 256, "VALID"), (6, 512, "VALID")],
               combined=[1024, 512, 1]),
    "B2": dict(rgb=[(5, 64, "SAME"), (5, 128, "SAME"), (5, 256, "SAME"),
                    (5, 512, "SAME"), (4, 1024, "VALID")],
               depth=[(5, 128, "SAME"), (5, 256, "SAME"), (5, 512, "SAME"),
                      (4, 1024, "VALID")],
               combined=[1024, 512, 256, 128, 64, 1]),
}
DISC_SPECS["C1"] = DISC_SPECS["B1"]
DISC_SPECS["D1"] = DISC_SPECS["B2"]
DISC_SPECS["E1"] = DISC_SPECS["B2"]

# target depth crop per generator arch: None = center_crop 0.4769
CROPS = {"A1": None, "A2": None, "A3": None,
         "B1": (17, 17, 31), "C1": (17, 17, 31),
         "B2": (16, 16, 32), "D1": (16, 16, 32), "E1": (16, 16, 32)}
# extra conditioning channels per arch
EXTRAS = {"C1": ("x_loc", "y_loc"), "D1": ("x_loc", "y_loc"),
          "E1": ("x_loc", "y_loc", "mean")}


class SpecGenerator(DepthNet):
    """The noise-channel encoder/decoder of a generator spec
    (``hemx.models.improved_sampler.spec_generator``); ``in_shape`` is
    (C, H, W) of G's input before the noise channel. ``forward(x, noise,
    bottleneck=False)`` returns ``(y, stats)``, and with ``bottleneck`` the
    last encoder stage's relu output too."""

    def __init__(self, spec: dict, in_shape, *, generator: torch.Generator,
                 dtype=None):
        super().__init__(xavier_uniform, generator, dtype)
        self.enc = [tuple(s) for s in spec["enc"]]
        self.dec = [tuple(s) for s in spec["dec"]]
        self.bn_final = spec["final_bn"]
        cin = in_shape[0] + 1  # the noise channel
        for i, (k, ch, _, bn) in enumerate(self.enc):
            self.add_conv(f"e{i+1}", k, cin, ch)
            if bn:
                self.add_bn(f"e{i+1}", ch)
            cin = ch
        for i, (k, ch, bn) in enumerate(self.dec):
            self.add_deconv(f"d{i+1}", k, cin, ch)
            if bn:
                self.add_bn(f"d{i+1}", ch)
            cin = ch + self.enc[len(self.enc) - 2 - i][1]  # [y, skip]
        self.add_conv("final", 1, cin, 1)
        if self.bn_final:
            self.add_bn("final", 1)
        self.done()

    def noise_draws(self, n, h, w):
        return {"z": Uniform((n, 1, h, w), -1.0, 1.0)}

    def forward(self, x, noise=None, bottleneck: bool = False):
        n, _, h, w = x.shape
        check_draws(self, {"z": noise}, n, h, w)
        stats, sizes, skips = {}, [h], []
        hcur = torch.cat([x, noise], dim=1)
        for i, (_, _, pad, bn) in enumerate(self.enc):
            hcur = self.conv(f"e{i+1}", hcur, 2, pad, torch.relu, bn, stats)
            sizes.append(hcur.shape[2])
            skips.append(hcur)
        last = len(self.enc) - 1
        y = hcur
        for i, (_, _, bn) in enumerate(self.dec):
            # d{i+1} undoes encoder stage last - i: its padding, its input size
            y = self.deconv(f"d{i+1}", y, sizes[last - i], 2,
                            self.enc[last - i][2], lrelu, bn, stats)
            y = torch.cat([y, skips[last - 1 - i]], dim=1)
        y = torch.tanh(self.conv("final", y, 1, "SAME", None, self.bn_final,
                                 stats))
        return (y, stats, hcur) if bottleneck else (y, stats)


class SpecDiscriminator(DepthNet):
    """The two-path critic of a discriminator spec
    (``hemx.models.improved_sampler.spec_discriminator``); ``in_shape`` is
    (C, H, W) of its rgb input; ``forward((x, depth))``."""

    def __init__(self, spec: dict, in_shape, *, generator: torch.Generator,
                 dtype=None):
        super().__init__(xavier_uniform, generator, dtype)
        self.rgb = [tuple(s) for s in spec["rgb"]]
        self.depth = [tuple(s) for s in spec["depth"]]
        self.combined = list(spec["combined"])
        cin = in_shape[0]
        for i, (k, ch, _) in enumerate(self.rgb):
            self.add_conv(f"hx{i+1}", k, cin, ch)
            cin = ch
        rgb_out, cin = cin, 1
        for i, (k, ch, _) in enumerate(self.depth):
            self.add_conv(f"hy{i+1}", k, cin, ch)
            cin = ch
        cin += rgb_out
        for i, ch in enumerate(self.combined):
            self.add_conv(f"h{i+1}", 1, cin, ch)
            cin = ch
        self.done()

    def forward(self, xy):
        x, d = xy
        stats = {}
        for i, (_, _, pad) in enumerate(self.rgb):
            x = self.conv(f"hx{i+1}", x, 2, pad, lrelu, False, stats)
        for i, (_, _, pad) in enumerate(self.depth):
            d = self.conv(f"hy{i+1}", d, 2, pad, lrelu, False, stats)
        h = torch.cat([x, d], dim=1)
        for i in range(len(self.combined)):
            act = None if i == len(self.combined) - 1 else lrelu
            h = self.conv(f"h{i+1}", h, 1, "SAME", act, False, stats)
        return h, stats


class ImprovedSampler(ConditionalGanBase):
    name = "improved_sampler"

    @staticmethod
    def arguments() -> dict:
        return {
            "--g_sparsity": dict(action="store_true", default=False,
                                 help="Subtract the bottleneck zero-fraction "
                                      "from the generator loss."),
            "--g_rmse": dict(action="store_true", default=False,
                             help="Add an RMSE term to the generator loss."),
            "--g_arch": dict(type=str, default="A1",
                             choices=sorted(GEN_SPECS)),
            "--d_arch": dict(type=str, default="A1",
                             choices=sorted(DISC_SPECS)),
        }

    def extras(self) -> tuple:
        """The batch keys concatenated onto G's and D's input, in order."""
        return EXTRAS.get(self.args.g_arch, ())

    @property
    def batch_keys(self) -> tuple:
        return ("image", "depth") + self.extras()

    def gen_spec(self) -> dict:
        return GEN_SPECS[self.args.g_arch]

    def disc_spec(self) -> dict:
        return DISC_SPECS[self.args.d_arch]

    def _build(self, image_shape, generator):
        c, h, w = image_shape
        in_shape = (c + len(self.extras()), h, w)
        kw = dict(generator=generator, dtype=self.compute_dtype)
        return torch.nn.ModuleDict({
            "generator": SpecGenerator(self.gen_spec(), in_shape, **kw),
            "discriminator": SpecDiscriminator(self.disc_spec(), in_shape,
                                               **kw)})

    def prepare(self, batch: dict) -> dict:
        x = 2.0 * (batch["image"] - 0.5)
        y = 2.0 * (batch["depth"] - 0.5)
        crop = CROPS[self.args.g_arch]
        if crop is None:
            y = center_crop(y, 0.4769)
        else:
            oy, ox, size = crop
            y = crop_to_bounding_box(y, oy, ox, size, size)
        if self.extras():
            x = torch.cat([x] + [batch[k] for k in self.extras()], dim=1)
        return {"g_input": x, "y": y, "d_x": x}

    def g_forward(self, G, prep: dict, noise: dict):
        """G's output; under ``--g_sparsity`` the bottleneck is kept in
        ``prep["e_bottleneck"]`` for :meth:`extra_g_loss`."""
        if not getattr(self.args, "g_sparsity", False):
            return G(prep["g_input"], noise.get("z"))
        g, stats, prep["e_bottleneck"] = G(prep["g_input"], noise.get("z"),
                                           bottleneck=True)
        return g, stats

    def d_forward(self, D, prep: dict, depth):
        return D((prep["d_x"], depth))

    def extra_g_loss(self, g, prep: dict):
        g01 = (g + 1.0) / 2.0
        y01 = (prep["y"] + 1.0) / 2.0
        r = rmse(y01, g01)
        metrics = {"rmse": r, "l1": torch.mean(torch.abs(y01 - g01))}
        total = None
        if getattr(self.args, "g_rmse", False):
            total = r
        if getattr(self.args, "g_sparsity", False):
            sparsity = value_fraction(prep["e_bottleneck"].detach())
            metrics["sparsity_term"] = sparsity
            total = (0.0 if total is None else total) - 1.0 * sparsity
        return total, metrics

    # one batch per call: the D step, then the G step on the same batch
    def batches_per_train_call(self) -> int:
        return 1

    def n_substeps(self) -> int:
        return 2

    def substeps(self, stream):
        batch = next(stream)
        yield batch, self.d_step
        yield batch, self.g_step

    @torch.no_grad()
    def capture_activations(self, ts: common.TrainState, batch: dict) -> dict:
        """G's bottleneck on 8 rows (hemx's only recorded intermediate of
        these nets, ``generator/e_bottleneck``)."""
        prep = self.prepare({k: v[:8] for k, v in batch.items()})
        nz = self._noise(ts, common.REPORT, prep, None)
        _, _, e = ts.nets["generator"](prep["g_input"], nz.get("z"),
                                       bottleneck=True)
        return common.summarizable_stats(
            {"generator/e_bottleneck": common.nhwc(e)})

    def diag_noise(self, ts: common.TrainState, x: torch.Tensor) -> dict:
        """The diagnostic paths' draws for G's input ``x``: the row
        permutation ``perm``, the uniform [-1, 1) input ``x_noise``, and
        G's noise channel for each path, ``z_shuffled`` and ``z_noise``."""
        G = ts.nets["generator"]
        gen = common.generator(ts, common.DIAG, self.device)
        perm = torch.randperm(x.shape[0], generator=gen, device=gen.device)
        x_noise = torch.rand(x.shape, generator=gen, device=gen.device) * 2 - 1
        return {"perm": perm, "x_noise": x_noise,
                "z_shuffled": draw_noise(G, gen, x)["z"],
                "z_noise": draw_noise(G, gen, x)["z"]}

    def write_summaries(self, writer, step: int, ts: common.TrainState,
                        batch: dict, diag: dict | None = None) -> None:
        """The base's montages and sampler scalars, then G on the shuffled
        and on pure-noise inputs (``shuffled/*``, ``noise/*``). ``diag``
        replaces :meth:`diag_noise`'s draws (the equality tests' seam)."""
        super().write_summaries(writer, step, ts, batch)
        G = ts.nets["generator"]
        x = self.prepare(batch)["g_input"]
        d = diag if diag is not None else self.diag_noise(ts, x)
        d = {k: v.to(self.device) for k, v in d.items()}
        with torch.no_grad():
            g_shuf, _ = G(x[d["perm"]], d["z_shuffled"])
            g_noise, _ = G(d["x_noise"], d["z_noise"])
        n = min(getattr(self.args, "examples", 64), g_shuf.shape[0])
        g_shuf = numpy_nhwc((g_shuf + 1) / 2)[:n]
        g_noise = numpy_nhwc((g_noise + 1) / 2)[:n]
        writer.montage("shuffled/fake_depths", colorize(np.clip(g_shuf, 0, 1)),
                       step)
        writer.montage("noise/fake_depths", colorize(np.clip(g_noise, 0, 1)),
                       step)
        writer.scalar("shuffled/variance", float(g_shuf.var(axis=0).mean()),
                      step)
        writer.scalar("noise/variance", float(g_noise.var(axis=0).mean()),
                      step)
