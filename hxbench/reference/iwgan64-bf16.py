"""Plain reference of the IWGAN train call (Gulrajani et al., arXiv:1704.00028,
as hemx builds it), in the precision its configuration states
(:func:`hxbench.reference.plain.precision`: bf16 products with float32
parameters), no kernel of the program.

G: dense(latent -> 4*4*4L) + BN + relu, read as NHWC (4, 4, 4L), then 5x5
stride-2 SAME transposed convs halving the channels (+ BN + relu) and a last
one to C channels + tanh. D: three 5x5 stride-2 SAME convs + leaky relu 0.2
(no BN in the IWGAN), flattened in NHWC order, dense -> 1. BN: batch
statistics, eps 1e-3, biased variance, an offset and no scale.

A train call: ``n_disc_train`` critic steps, each on a fresh batch: the
Wasserstein loss of one pass over ``cat([x, G(z)])`` plus 10 times the
gradient penalty, whose slope is the norm of D's input gradient over the
WHOLE batch (hemx's form), differentiated twice; then one generator step on
another batch, ``-mean(D(G(z)))``, which also reports ``d_loss`` of the
current D. Images are rescaled [0, 1] -> [-1, 1]. Adam per network.
Leaves carry the program's parameter names, so the same initial tensors
load into both.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from hxbench.reference import plain


def _sizes(cfg):
    f = cfg["flags"]
    h, w, c = cfg["inputs"]["image"]
    return int(f["latent_size"]), h, c, int(f["n_disc_train"])


def specs(cfg) -> list:
    """``(name, shape, init, trainable)`` of every parameter and buffer,
    with hemx's initialisation: Xavier-uniform with TF's fans for kernels
    and biases, BN offsets 0, moving means 0 and variances 1."""
    latent, h, c, _ = _sizes(cfg)
    out = []

    def layer(name, w_shape, fans, cout, bn=None):
        out.append((f"{name}.w", w_shape, ("xavier", *fans), True))
        out.append((f"{name}.b", (cout,), ("xavier", cout, cout), True))
        if bn:
            out.append((f"{name}.{bn}.beta", (cout,), ("zeros",), True))
            out.append((f"{name}.{bn}.mean", (cout,), ("zeros",), False))
            out.append((f"{name}.{bn}.var", (cout,), ("ones",), False))

    top = 4 * 4 * 4 * latent
    layer("generator.fc1", (top, latent), (latent, top), top, "bn")
    n_up = int(math.log2(h // 4))
    ch = 4 * latent
    for i in range(n_up):
        last = i == n_up - 1
        cout = c if last else ch // 2
        layer(f"generator.dc{i + 1}", (ch, cout, 5, 5), (25 * cout, 25 * ch),
              cout, None if last else "norm0")
        ch = cout
    cin = c
    for i, cout in enumerate((latent, 2 * latent, 4 * latent)):
        layer(f"discriminator.c{i + 1}", (cout, cin, 5, 5),
              (25 * cin, 25 * cout), cout)
        cin = cout
    side = math.ceil(h / 8)
    flat = side * side * 4 * latent
    layer("discriminator.fc2", (1, flat), (flat, 1), 1)
    return out


def noise_spec(cfg, batch: int) -> list:
    """The draws of each substep of a call: ``z`` (batch, latent) normal
    and, in a critic step, the penalty's ``alpha`` (batch, 1) uniform."""
    latent, _, _, n_disc = _sizes(cfg)
    z = {"z": ((batch, latent), "normal")}
    return [dict(z, alpha=((batch, 1), "uniform"))] * n_disc + [z]


def _generator(w, z, p):
    n = z.shape[0]
    y = F.relu(plain.batch_norm(plain.dense(
        z, w["generator.fc1.w"], w["generator.fc1.b"], p),
        w["generator.fc1.bn.beta"]))
    y = y.reshape(n, 4, 4, -1).permute(0, 3, 1, 2)
    i = 1
    while f"generator.dc{i + 1}.w" in w:
        y = F.relu(plain.batch_norm(plain.deconv(
            y, w[f"generator.dc{i}.w"], w[f"generator.dc{i}.b"], 2, p),
            w[f"generator.dc{i}.norm0.beta"]))
        i += 1
    return torch.tanh(plain.deconv(y, w[f"generator.dc{i}.w"],
                                   w[f"generator.dc{i}.b"], 2, p))


def _critic(w, x, p):
    y = x
    for i in (1, 2, 3):
        y = plain.lrelu(plain.conv(y, w[f"discriminator.c{i}.w"],
                                    w[f"discriminator.c{i}.b"], 2, p))
    y = y.permute(0, 2, 3, 1).reshape(y.shape[0], -1)
    return plain.dense(y, w["discriminator.fc2.w"],
                       w["discriminator.fc2.b"], p).reshape(-1)


def train_call(params: dict, opt: dict, batches: list, noise: list,
               p: plain.Precision = plain.Precision()) -> dict:
    """One train call on ``batches`` (one ``{"image"}`` of float32 NCHW
    rows on [0, 1] per substep) with ``noise`` (one dict per substep), in
    precision ``p``; updates ``params`` and ``opt`` in place and returns
    the losses the call reports. Under a bf16 ``p`` G's images and D's
    scores come out in bf16 and ``cat([x, g])`` in float32, as in hemx."""
    gen = [k for k in opt["generator"].mu]
    dis = [k for k in opt["discriminator"].mu]
    for k in gen + dis:
        params[k].requires_grad_(True)
    out = {}
    for i, (batch, nz) in enumerate(zip(batches, noise)):
        x = 2.0 * (batch["image"] - 0.5)
        n = x.shape[0]
        if i < len(batches) - 1:
            with torch.no_grad():
                g = _generator(params, nz["z"], p)
            both = _critic(params, torch.cat([x, g]), p)
            loss = both[n:].mean() - both[:n].mean()
            a = nz["alpha"].reshape(-1, 1, 1, 1)
            interp = (x + a * (g - x)).requires_grad_(True)
            gx, = torch.autograd.grad(_critic(params, interp, p).sum(),
                                      interp, create_graph=True)
            loss = loss + 10.0 * (torch.sqrt((gx ** 2).sum()) - 1.0) ** 2
            grads = torch.autograd.grad(loss, [params[k] for k in dis])
            opt["discriminator"].step(params, dict(zip(dis, grads)))
        else:
            d_fake = _critic(params, _generator(params, nz["z"], p), p)
            g_loss = -d_fake.mean()
            grads = torch.autograd.grad(g_loss, [params[k] for k in gen])
            with torch.no_grad():
                d_loss = d_fake.mean() - _critic(params, x, p).mean()
            opt["generator"].step(params, dict(zip(gen, grads)))
            out = {"g_loss": g_loss.detach(), "d_loss": d_loss}
    return {k: float(v) for k, v in out.items()}
