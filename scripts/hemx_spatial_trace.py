#!/usr/bin/env python3
"""hemx's spatial mesh against one device, read from momentum's trace.

    JAX_PLATFORMS=cpu python3 scripts/hemx_spatial_trace.py [--model cnn]

Runs one train call of a hemx model (latent 16, 32x32x3, a global batch
of 8, ``--optimizer momentum``, lr 1e-3, momentum 0.5) on one CPU device
and on ``make_mesh(4, spatial=2)`` and ``make_mesh(4, model=2)`` of an
8-device CPU mesh, from the same weights and batch, and prints, per
kernel and bias, the ratio of the mesh's momentum trace to one device's
(after one call the trace is the gradient) and the largest relative
difference. hemx's own TP/SP tests train with sgd at lr 1e-3, whose
parameter updates sit under their tolerances whatever the gradient; the
trace shows the gradient itself.
"""

from __future__ import annotations

import argparse
import os
import sys
import types
from pathlib import Path

os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")
sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def _flat(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--model", default="cnn")
    a = p.parse_args()

    import jax
    jax.config.update("jax_platforms", "cpu")
    import numpy as np
    from flax import serialization

    from hemx.models.plugin import get_model
    from hemx.parallel.dp import shard_batch
    from hemx.parallel.mesh import make_mesh

    def one_call(devices, **axes):
        mesh = make_mesh(devices, **axes)
        data = mesh.shape.get("data", 1)
        args = types.SimpleNamespace(
            model=a.model, batch_size=8 // data, latent_size=16,
            synthetic_shape=[32, 32, 3], optimizer="momentum", lr=1e-3,
            momentum=0.5, decay=0.9, centered=False, beta1=0.9, beta2=0.999,
            n_disc_train=2, seed=42, dtype="float32", precision="default",
            check_numerics=False, loss="l1", vae_parity_loss=False,
            n_devices=devices, model_parallel=axes.get("model", 1),
            spatial_parallel=axes.get("spatial", 1), examples=4)
        rng = np.random.default_rng(3)
        model = get_model(a.model)(args, mesh)
        batches = [{"image": rng.random((8, 32, 32, 3), dtype=np.float32)}
                   for _ in range(model.batches_per_train_call())]
        ts = model.init_state(jax.random.PRNGKey(args.seed), batches[0])
        new, _ = model.train(ts, iter([shard_batch(b, mesh)
                                       for b in batches]))
        state = serialization.to_state_dict(jax.device_get(new["opt"]))
        return {"/".join(k): np.asarray(v) for k, v in _flat(state).items()
                if "trace" in k and np.size(v)}

    one = one_call(1)
    for label, axes in (("data 2 x spatial 2", {"spatial": 2}),
                        ("data 2 x model 2", {"model": 2})):
        mesh = one_call(4, **axes)
        print(f"{a.model}, {label} against one device (trace ratio, "
              f"largest |diff| / largest |one device|):")
        for k, v in one.items():
            ratio = np.abs(mesh[k]).sum() / max(np.abs(v).sum(), 1e-30)
            rel = np.abs(mesh[k] - v).max() / max(np.abs(v).max(), 1e-30)
            print(f"  {k:40s} {ratio:8.4f} {rel:10.3g}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
