"""Operations of one IWGAN train call: ``n_disc_train`` critic steps and one
generator step at the global batch.

Per sample, with ``G`` and ``D`` the forward multiply-adds of the networks
and ``c1``, ``fc1``, ``fc2`` those of their first and last layers:

* critic step: G forward (``G``); D on ``cat([x, G(z)])`` (``2D``); the
  penalty's D forward on the interpolates (``D``) and its input gradient
  (``D``: every layer's data-gradient product); the backward of the loss:
  the Wasserstein pass's weight gradients (``2D``) and data gradients
  above ``c1`` (``2(D - c1)``), and through the input gradient, each
  layer's weight gradient (``D``) and the gradient of its incoming
  gradient (``D - fc2``: the top one's is a constant). ``G + 10 D - 2 c1 -
  fc2``;
* generator step: G forward (``G``), D on G's images (``D``), D's data
  gradients (``D``), G's weight (``G``) and data gradients (``G - fc1``),
  and D on the real batch for the reported loss (``D``). ``3 G + 3 D -
  fc1``.
"""

from __future__ import annotations

import math

from hxbench.flops.layers import conv_macs, deconv_macs, dense_macs, same_out


def per_call(config: dict, traffic: dict) -> float:
    f = config["flags"]
    latent, n_disc = int(f["latent_size"]), int(f["n_disc_train"])
    h, _, c = config["inputs"]["image"]
    fc1 = dense_macs(latent, 4 * 4 * 4 * latent)
    g, side, ch = fc1, 4, 4 * latent
    for i in range(int(math.log2(h // 4))):
        cout = c if side * 2 == h else ch // 2
        g += deconv_macs(side, 5, ch, cout)
        side, ch = side * 2, cout
    d, side, cin = 0, h, c
    layers = []
    for cout in (latent, 2 * latent, 4 * latent):
        side = same_out(side, 2)
        layers.append(conv_macs(side, 5, cin, cout))
        cin = cout
    fc2 = dense_macs(side * side * cin, 1)
    d = sum(layers) + fc2
    critic = g + 10 * d - 2 * layers[0] - fc2
    generator = 3 * g + 3 * d - fc1
    batch = int(traffic["batch_size"]) * int(traffic["n_devices"])
    return 2.0 * batch * (n_disc * critic + generator)
