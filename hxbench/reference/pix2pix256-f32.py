"""Plain reference of the pix2pix train call (Isola et al.,
arXiv:1611.07004, as hemx builds it for image -> depth), in the precision
its configuration states (:func:`hxbench.reference.plain.precision`:
float32 with TF32 products), no kernel of the program.

G, the U-Net: 4x4 stride-2 SAME convs + leaky relu 0.2 halve the square
input to 1x1, channels 64, 128, ... capped at 512 (no BN on the encoder);
4x4 stride-2 SAME transposed convs double it back, each + bias, BN and relu
(tanh on the last, to one channel), each but the last followed by the
concatenation of the encoder output of its size. D, the PatchGAN: four 4x4
stride-2 SAME convs (64-512) + leaky relu 0.2 and a 4x4 stride-2 conv to one
channel of logits, on the image and a depth concatenated. Every weight and
bias drawn from Normal(0, 0.02).

A train call: ``n_disc_train`` critic steps (sigmoid cross-entropy of the
real pair against 1 and of the fake pair against 0), then one generator
step (the fake pair's cross-entropy against 1), each on a fresh batch.
Images and depths rescaled [0, 1] -> [-1, 1]. Adam per network. Leaves
carry the program's parameter names (and its 0-d ``_`` buffer).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from hxbench.reference import plain

STD = 0.02


def _stages(cfg) -> int:
    return int(math.log2(cfg["inputs"]["image"][0]))


def _enc(n: int) -> list:
    return [min(64 * 2 ** i, 512) for i in range(n)]


def specs(cfg) -> list:
    """``(name, shape, init, trainable)`` of every parameter and buffer."""
    n = _stages(cfg)
    enc = _enc(n)
    c = cfg["inputs"]["image"][2]
    out = []

    def layer(name, w_shape, cout, bn=False):
        out.append((f"{name}_w", w_shape, ("normal", STD), True))
        out.append((f"{name}_b", (cout,), ("normal", STD), True))
        if bn:
            out.append((f"{name}_bn.beta", (cout,), ("zeros",), True))
            out.append((f"{name}_bn.mean", (cout,), ("zeros",), False))
            out.append((f"{name}_bn.var", (cout,), ("ones",), False))

    cin = c
    for i, cout in enumerate(enc):
        layer(f"generator.e{i + 1}", (cout, cin, 4, 4), cout)
        cin = cout
    for i in range(n):
        last = i == n - 1
        cout = 1 if last else min(64 * 2 ** (n - 2 - i), 512)
        layer(f"generator.d{i + 1}", (cin, cout, 4, 4), cout, bn=True)
        if not last:
            cin = cout + enc[n - 2 - i]
    cin = c + cfg["inputs"]["depth"][2]
    for i, cout in enumerate((64, 128, 256, 512, 1)):
        layer(f"discriminator.m{i + 1}", (cout, cin, 4, 4), cout)
        cin = cout
    out += [("generator._", (), ("zeros",), False),
            ("discriminator._", (), ("zeros",), False)]
    return out


def noise_spec(cfg, batch: int) -> list:
    """No noise site and no dropout: no draws in any substep."""
    return [{}] * (int(cfg["flags"]["n_disc_train"]) + 1)


def _unet(w, x, p):
    n = sum(1 for k in w if k.startswith("generator.e") and k.endswith("_w"))
    skips, y = [], x
    for i in range(n):
        y = plain.lrelu(plain.conv(y, w[f"generator.e{i + 1}_w"],
                                    w[f"generator.e{i + 1}_b"], 2, p,
                                    cast_bias=False))
        skips.append(y)
    for i in range(n):
        d = f"generator.d{i + 1}"
        y = plain.batch_norm(plain.deconv(y, w[f"{d}_w"], w[f"{d}_b"], 2, p,
                                          cast_bias=False),
                             w[f"{d}_bn.beta"])
        if i == n - 1:
            return torch.tanh(y)
        y = torch.cat([F.relu(y), skips[n - 2 - i]], dim=1)


def _patchgan(w, x, p):
    y = x
    for i in range(1, 5):
        y = plain.lrelu(plain.conv(y, w[f"discriminator.m{i}_w"],
                                    w[f"discriminator.m{i}_b"], 2, p,
                                    cast_bias=False))
    return plain.conv(y, w["discriminator.m5_w"], w["discriminator.m5_b"], 2,
                      p, cast_bias=False)


def train_call(params: dict, opt: dict, batches: list, noise: list,
               p: plain.Precision = plain.Precision()) -> dict:
    """One train call on ``batches`` (``{"image", "depth"}`` float32 NCHW
    on [0, 1] per substep), in precision ``p``; updates ``params`` and
    ``opt`` in place and returns the losses the call reports. Biases are
    added uncast, as hemx's networks add them."""
    gen = list(opt["generator"].mu)
    dis = list(opt["discriminator"].mu)
    for k in gen + dis:
        params[k].requires_grad_(True)
    out = {}
    for i, batch in enumerate(batches):
        gi = 2.0 * (batch["image"] - 0.5)
        y = 2.0 * (batch["depth"] - 0.5)
        if i < len(batches) - 1:
            with torch.no_grad():
                g = _unet(params, gi, p)
            real = _patchgan(params, torch.cat([gi, y], 1), p)
            fake = _patchgan(params, torch.cat([gi, g], 1), p)
            d_real = plain.sigmoid_xent(real, torch.ones_like(real)).mean()
            d_fake = plain.sigmoid_xent(fake, torch.zeros_like(fake)).mean()
            grads = torch.autograd.grad(d_real + d_fake,
                                        [params[k] for k in dis])
            opt["discriminator"].step(params, dict(zip(dis, grads)))
            out.update(d_loss=(d_real + d_fake).detach(),
                       d_real=d_real.detach(), d_fake=d_fake.detach())
        else:
            g = _unet(params, gi, p)
            fake = _patchgan(params, torch.cat([gi, g], 1), p)
            g_gan = plain.sigmoid_xent(fake, torch.ones_like(fake)).mean()
            grads = torch.autograd.grad(g_gan, [params[k] for k in gen])
            with torch.no_grad():
                diff = (y + 1.0) / 2.0 - (g + 1.0) / 2.0
                out.update(g_loss=g_gan.detach(), g_gan=g_gan.detach(),
                           l1=diff.abs().mean(),
                           rmse=torch.sqrt((diff * diff).mean()))
            opt["generator"].step(params, dict(zip(gen, grads)))
    return {k: float(v) for k, v in out.items()}
