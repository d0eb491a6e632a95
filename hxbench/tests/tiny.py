"""Cells of ``BENCHMARK.json`` cut to sizes a CPU test holds: the same
configuration, traffic and limits with small images, widths and batches,
products in float32 at full precision (so a sound run reads rounding
alone), run with ``device="cpu"``."""

from __future__ import annotations

from hxbench import spec

SIZES = {
    "iwgan64-bf16": ({"latent_size": 8, "n_disc_train": 2},
                     {"image": [16, 16, 3]}),
    "pix2pix256-f32": ({}, {"image": [32, 32, 3], "depth": [32, 32, 1]}),
}


def cell(name: str, dtype: str = "float32", devices: int = 1,
         batch: int = 8) -> dict:
    """``name`` cut to size: ``devices`` ranks (gloo), ``batch`` rows each
    and three calls' worth of cached rows, times four."""
    c = spec.cell(name)
    flags, inputs = SIZES[c["config"]["name"]]
    c["config"]["flags"].update(flags, dtype=dtype, precision="highest")
    c["config"]["inputs"] = inputs
    per_call = int(c["config"]["flags"]["n_disc_train"]) + 1
    c["traffic"] = {"batch_size": batch, "n_devices": devices,
                    "rows": 4 * 3 * per_call * batch * devices}
    c["chips"] = devices
    return c
