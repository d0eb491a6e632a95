#!/usr/bin/env python3
"""hemx's model and spatial axes over NCCL, one GPU per rank, against one
process.

    python3 scripts/axes_nccl.py [--gpus 4] [--out PATH]

Needs ``--gpus`` GPUs on one host. For each axis, ``torchrun
--nproc_per_node G -m hemx_torch.cli ... --<axis>_parallel 2`` (hemx's grid
data G/2 x axis 2, NCCL):

1. iwgan (``n_disc_train 2``) and cnn at ``chip_smoke.py`` phase 19 (b)'s
   size (latent 16, 32 px, batch 4 per data shard, ``--precision highest``,
   momentum), one call, against one process on ``cuda:0`` at the global
   batch, at phase 17 (a)'s tolerances (``chip_smoke._compare_runs``);
2. hemx's ``examples/multichip_scaling.config`` at full width (IWGAN,
   latent 200, 64x64x3, batch 128 per data shard, Adam, 5+1),
   ``--synthetic_count`` cut to 2,048, 4 calls, against one process on
   ``cuda:0`` at the same global batch: the median call time of each, and
   the rank-0 summary's axis collectives and bytes per call.

Prints one line per comparison and writes every summary line as JSON to
``--out``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as C  # noqa: E402

SMALL = {"iwgan": C.AXES_SMALL[0][1], "cnn": C.AXES_SMALL[1][1]}


def _run(cmd: list, timeout: int = 900) -> dict:
    """A command's last stdout line (the CLI's summary) as JSON."""
    r = subprocess.run(cmd, capture_output=True, text=True, timeout=timeout,
                       env={**os.environ, "PYTHONPATH": str(ROOT)}, cwd=ROOT)
    if r.returncode:
        raise SystemExit(f"{' '.join(cmd[:8])} ... failed ({r.returncode}):"
                         f"\n{r.stdout[-3000:]}\n{r.stderr[-3000:]}")
    return json.loads(r.stdout.strip().splitlines()[-1])


def _cli(argv: list) -> list:
    return [sys.executable, "-m", "hemx_torch.cli", *argv]


def _torchrun(gpus: int, argv: list) -> list:
    return [sys.executable, "-m", "torch.distributed.run", "--standalone",
            "--nproc_per_node", str(gpus), "-m", "hemx_torch.cli", *argv]


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--gpus", type=int, default=4)
    p.add_argument("--out", default="workspace/axes_nccl.json")
    a = p.parse_args()
    import torch
    if torch.cuda.device_count() < a.gpus:
        print(f"axes_nccl: {a.gpus} GPUs needed, {torch.cuda.device_count()} "
              f"found", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(card, flush=True)
    data = a.gpus // 2
    work = tempfile.mkdtemp(prefix="axes_nccl_")
    out = {"card": card, "gpus": a.gpus, "small": {}, "full": {}}

    def small(name, b, d, extra):
        return (["--dataset", "synthetic", "--synthetic_u8",
                 "--synthetic_count", "64", "--synthetic_eval_count", "16",
                 "--synthetic_shape", "32", "32", "3", "--epochs", "1",
                 "--epoch_size", "1", "--precision", "highest", "--seed",
                 "3", "--batch_size", str(b), "--dir", d]
                + SMALL[name] + extra)

    for name in SMALL:
        one = os.path.join(work, name, "one")
        out["small"][f"{name}_one"] = _run(_cli(small(
            name, 4 * data, one, ["--device", "cuda:0"])))
        for axis in C.AXES:
            d = os.path.join(work, name, axis)
            s = _run(_torchrun(a.gpus, small(name, 4, d,
                                             [f"--{axis}_parallel", "2"])))
            out["small"][f"{name}_{axis}"] = s
            worst = C._compare_runs(
                f"{name} {axis}", d, one, dict(rtol=2e-3, atol=2e-5),
                lambda phase, tag: 1e-3 if "grad_norm" in tag else 5e-4)
            print(f"{name}: {a.gpus} GPUs over NCCL as data {data} x {axis} 2"
                  f" vs one process at batch {4 * data}: max |diff| of the "
                  f"state {worst:.3g}, losses in tolerance; "
                  f"{s['axis']['collectives_per_call']:.0f} axis "
                  f"collectives, {s['axis']['bytes_per_call'] / 1e6:.2f} MB "
                  f"per call", flush=True)

    config = str(ROOT / "examples" / "multichip_scaling.config")

    def full(d, extra):
        return (["@" + config, "--synthetic_u8", "--synthetic_count", "2048",
                 "--synthetic_eval_count", "256", "--epochs", "1",
                 "--epoch_size", "4", "--seed", "0", "--dir", d,
                 "--spatial_parallel", "1"] + extra)

    one = _run(_cli(full(os.path.join(work, "full_one"),
                         ["--batch_size", str(128 * data), "--device",
                          "cuda:0"])))
    out["full"]["one"] = one
    for axis in C.AXES:
        s = _run(_torchrun(a.gpus, full(os.path.join(work, f"full_{axis}"),
                                        [f"--{axis}_parallel", "2"])))
        out["full"][axis] = s
        ax = s["axis"]
        print(f"multichip_scaling.config on {a.gpus} GPUs over NCCL as data "
              f"{data} x {axis} 2 (global batch {s['global_batch']}): median "
              f"call {s['median_call_s']:.4f} s after {s['first_call_s']:.3f}"
              f" s, {s['images_per_s']:.1f} images/s; one process on one GPU"
              f" at the same batch {one['median_call_s']:.4f} s, "
              f"{one['images_per_s']:.1f} images/s; per call "
              f"{ax['collectives_per_call']:.0f} axis collectives, "
              f"{ax['bytes_per_call'] / 1e9:.3f} GB; gradient all-reduces "
              f"{s['grad_all_reduce']['collectives'] / s['calls']:.1f} per "
              f"call, {s['grad_all_reduce']['bytes'] / s['calls'] / 1e6:.1f}"
              f" MB", flush=True)
    os.makedirs(os.path.dirname(a.out) or ".", exist_ok=True)
    with open(a.out, "w") as f:
        json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
