#!/usr/bin/env python3
"""Two or more hemx_torch trees, in turns, on one GPU machine: the host's
record paths and the train calls that ``chip_smoke.py`` times.

    python3 scripts/trees_ab.py TREE [TREE ...] [--kernel] [--out PATH]

Each TREE is the root of a checkout: this repository, or another commit
unpacked with ``git archive`` into a directory that ``.gitignore`` lists.
To compare two commits, give them in turns: ``old new new old``. Each
TREE runs in a process of its own that imports that tree's
``hemx_torch`` and ``chip_smoke``:

1. the host's record paths, with the native module (where the tree has
   one) built before the clock starts, or with ``--kernel`` in their
   place the tree's ``chip_smoke.phase_kernel`` (phase 2: the input
   kernel against its plain version, its CUDA-event time on 3,072 rows of
   64x64x3, and its device time with the L2 cache flushed on the short
   gathers and the height bands), so that two versions of the kernel are
   timed on one card in turns: the converters of
   ``chip_smoke.py``'s raw sets (phase 9's 5,120 floorplan PNGs of
   128x128, phase 16's celeb and coco JPEG trees; the raw files written
   once, by this tree's writers), and the median of 5 summaries of phase
   6's size through ``EventsWriter`` (two 64-image montages of 64x64x3
   and two histograms);
2. the train calls of phases 4, 6 and 8 through the tree's own phase
   functions, which check what they check in ``chip_smoke.py``: the
   IWGAN at full width in f32 and in bf16 (with its resume), then gan,
   wgan, cnn and vae in bf16 at BASELINE's widths; the median call of
   each is read from the lines they print.

Prints one JSON line per tree and writes them all to ``--out``; with
``--kernel``, then one line per gather: each tree's kernel time in the
order given, and its share of the bytes bound.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

FLOORPLAN = {"train": 4096, "validate": 512, "test": 512}
CELEB = {"train": 2048, "validate": 512, "test": 256}
COCO = {"train": 384, "validate": 64, "test": 64}
# the label of each train run: the start of the line its phase prints
RUNS = {"iwgan_f32": "IWGAN bs512 ", "iwgan_bf16": "IWGAN bf16 bs512 ",
        "gan_bf16": "gan bf16 ", "wgan_bf16": "wgan bf16 ",
        "cnn_bf16": "cnn bf16 ", "vae_bf16": "vae bf16 "}
MEDIAN = re.compile(r"median call ([0-9.]+) s")


def write_raw(raw: str) -> None:
    sys.path.insert(0, str(ROOT))
    import chip_smoke as C
    C.write_floorplan_raw(os.path.join(raw, "floorplan"), FLOORPLAN, 128,
                          seed=0)
    C.write_celeb_raw(os.path.join(raw, "celeb"), CELEB, seed=0)
    C.write_coco_raw(os.path.join(raw, "coco"), COCO, seed=0)


def record_paths(raw: str, work: str) -> dict:
    import numpy as np

    from hemx_torch.data.plugin import get_dataset
    from hemx_torch.summaries.crc32c import masked_crc32c
    from hemx_torch.summaries.events import EventsWriter
    masked_crc32c(b"")  # the native module's build, where there is one
    out = {}
    for name in ("floorplan", "celeb", "coco"):
        store = os.path.join(work, name)
        t0 = time.perf_counter()
        get_dataset(name).convert_to_tfrecord(os.path.join(raw, name), store)
        out[f"{name}_convert_s"] = time.perf_counter() - t0
        out[f"{name}_record_bytes"] = sum(
            os.path.getsize(os.path.join(store, f)) for f in os.listdir(store))
    rng = np.random.default_rng(0)
    x = rng.random((64, 64, 64, 3), dtype=np.float32)
    fake = np.clip(x * 0.5 + 0.25, 0, 1)
    w = EventsWriter(os.path.join(work, "events"))
    secs = []
    for step in range(5):
        t0 = time.perf_counter()
        w.montage("examples/inputs", x, step)
        w.montage("examples/fake", fake, step)
        w.histogram("examples/fakes_hist", fake, step)
        w.histogram("examples/real_hist", x, step)
        secs.append(time.perf_counter() - t0)
    w.close()
    out["summary_s"] = statistics.median(secs)
    out["summary_bytes"] = os.path.getsize(w.path) // 5
    return out


def kernel_times() -> dict:
    """The tree's phase 2: ms per gather (CUDA events for the 3,072-row
    call, device time for the rest) and each gather's bytes bound."""
    import torch

    import chip_smoke as C
    k = C.phase_kernel(torch, torch.device("cuda:0"))
    ms = {"3072x64x64x3 (events)": k["ms"]}
    bound = {"3072x64x64x3 (events)": k["bound_ms"]}
    for r in k["cold_rows"] + k["band_rows"]:
        name = r["rows"] + (" rows {}-{}".format(*r["band"]) if "band" in r
                            else "")
        ms[name], bound[name] = r["device_ms"], r["bound_ms"]
    return {"kernel_ms": ms, "kernel_bound_ms": bound}


def train_calls(work: str) -> str:
    """Phases 4, 6 and 8; returns the card's name and power limit."""
    import torch

    import chip_smoke as C
    dev = torch.device("cuda:0")
    card = C.phase_card(torch)
    run64 = C.synthetic_run(dev)
    C.phase_full_width(torch, dev, card, os.path.join(work, "f32"), run64)
    C.phase_bf16_run(torch, dev, card, os.path.join(work, "bf16"), run64)
    C.phase_zoo_bf16_runs(torch, dev, card, os.path.join(work, "zoo"), run64)
    return card


def child(tree: str, raw: str, work: str, kernel: bool) -> None:
    """One tree's run, in this process; its last line is the card and the
    record paths' (or the kernel's) figures as JSON."""
    sys.path.insert(0, tree)
    import chip_smoke
    import hemx_torch
    for mod in (chip_smoke, hemx_torch):
        if not mod.__file__.startswith(tree + os.sep):
            raise RuntimeError(f"{mod.__file__} is not under {tree}")
    paths = kernel_times() if kernel else record_paths(raw, work)
    card = train_calls(work)
    print(json.dumps({"card": card, **paths}), flush=True)


def medians(stdout: str) -> dict:
    out = {}
    for line in stdout.splitlines():
        m = MEDIAN.search(line)
        for name, start in RUNS.items():
            if line.startswith(start) and m and name not in out:
                out[name] = float(m.group(1))
    missing = sorted(set(RUNS) - set(out))
    if missing:
        raise RuntimeError(f"no median call printed for {missing}")
    return out


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("trees", nargs="*")
    p.add_argument("--kernel", action="store_true",
                   help="phase 2 in place of the record paths")
    p.add_argument("--out", default="")
    p.add_argument("--child", nargs=3, metavar=("TREE", "RAW", "WORK"),
                   help=argparse.SUPPRESS)
    a = p.parse_args()
    if a.child:
        child(*a.child, a.kernel)
        return 0
    if not a.trees:
        p.error("name at least one tree")
    lines = []
    with tempfile.TemporaryDirectory(prefix="trees_ab_") as tmp:
        raw = os.path.join(tmp, "raw")
        if not a.kernel:
            t0 = time.perf_counter()
            write_raw(raw)
            print(f"raw sets written in {time.perf_counter() - t0:.1f} s",
                  flush=True)
        for i, tree in enumerate(a.trees):
            tree = os.path.abspath(tree)
            r = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--child", tree,
                 raw, os.path.join(tmp, f"run{i}")]
                + (["--kernel"] if a.kernel else []), cwd=tree,
                capture_output=True, text=True, timeout=900)
            if r.returncode != 0:
                sys.stderr.write(r.stdout[-4000:] + r.stderr[-4000:])
                return 1
            line = {"tree": tree,
                    **json.loads(r.stdout.strip().splitlines()[-1]),
                    "median_call_s": medians(r.stdout)}
            print(json.dumps(line), flush=True)
            lines.append(line)
    if a.kernel:
        for name, bound in lines[0]["kernel_bound_ms"].items():
            ms = [line["kernel_ms"].get(name) for line in lines]
            print(f"{name}: ms {ms}, share of the {bound:.4f} ms bound "
                  f"{[round(bound / m, 3) if m else None for m in ms]}",
                  flush=True)
    if a.out:
        os.makedirs(os.path.dirname(os.path.abspath(a.out)), exist_ok=True)
        with open(a.out, "w") as f:
            json.dump(lines, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
