"""Operations of one pix2pix train call: ``n_disc_train`` critic steps and
one generator step at the global batch.

Per sample, with ``G`` and ``D`` the forward multiply-adds of the U-Net
and the PatchGAN and ``e1``, ``m1`` those of their first layers:

* critic step: G forward (``G``), D on the real and on the fake pair
  (``2D``), D's weight gradients of both (``2D``) and their data gradients
  above ``m1`` (``2(D - m1)``). ``G + 6 D - 2 m1``;
* generator step: G forward (``G``), D on the fake pair (``D``), D's data
  gradients down to the depth channel (``D``), G's weight (``G``) and data
  gradients (``G - e1``). ``3 G + 2 D - e1``.

The skip concatenations, batch norms and losses are not products.
"""

from __future__ import annotations

import math

from hxbench.flops.layers import conv_macs, deconv_macs


def per_call(config: dict, traffic: dict) -> float:
    h, _, c = config["inputs"]["image"]
    n = int(math.log2(h))
    enc = [min(64 * 2 ** i, 512) for i in range(n)]
    e, cin, side = [], c, h
    for cout in enc:
        side //= 2
        e.append(conv_macs(side, 4, cin, cout))
        cin = cout
    g = sum(e)
    for i in range(n):
        last = i == n - 1
        cout = 1 if last else min(64 * 2 ** (n - 2 - i), 512)
        g += deconv_macs(side, 4, cin, cout)
        side *= 2
        if not last:
            cin = cout + enc[n - 2 - i]
    m, cin, side = [], c + config["inputs"]["depth"][2], h
    for cout in (64, 128, 256, 512, 1):
        side //= 2
        m.append(conv_macs(side, 4, cin, cout))
        cin = cout
    d = sum(m)
    critic = g + 6 * d - 2 * m[0]
    generator = 3 * g + 2 * d - e[0]
    batch = int(traffic["batch_size"]) * int(traffic["n_devices"])
    n_disc = int(config["flags"]["n_disc_train"])
    return 2.0 * batch * (n_disc * critic + generator)
