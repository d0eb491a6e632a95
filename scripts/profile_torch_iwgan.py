#!/usr/bin/env python3
"""Where the time goes in one hemx_torch train call on a GPU.

    python3 scripts/profile_torch_iwgan.py [--calls 3] [--out PATH] [hemx flags]

Defaults to the headline IWGAN configuration (latent 200, 64x64x3, batch
512, 5 critic + 1 generator step, Adam, synthetic uint8 data); hemx flags
given after it override it, ``--model`` included (``--model cnn
--batch_size 1024 --optimizer rmsprop --lr 1e-4`` profiles the CNN
autoencoder's call). After two warm-up
calls it records ``--calls`` train calls under ``torch.profiler`` and
reports the device time by kernel, the device-busy share of the profiled
window (union of kernel intervals over the host-clock window), and an
A/B of cuDNN's algorithm search (``torch.backends.cudnn.benchmark``) in
alternating blocks of untraced calls. Writes the full record as JSON to
``--out``.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

HEADLINE = ["--model", "iwgan", "--dataset", "synthetic", "--synthetic_u8",
            "--synthetic_count", "4096", "--synthetic_shape", "64", "64", "3",
            "--batch_size", "512", "--latent_size", "200",
            "--n_disc_train", "5", "--optimizer", "adam", "--lr", "1e-4",
            "--beta1", "0.5", "--beta2", "0.9", "--seed", "0"]


def _busy_share(events, window_us: float) -> float:
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    busy, end = 0.0, -1.0
    for s, e in spans:
        if e <= end:
            continue
        busy += e - max(s, end)
        end = e
    return busy / window_us


def main() -> int:
    import torch
    from torch.autograd import DeviceType
    from hemx_torch.config import parse_args
    from hemx_torch.data.pipeline import DeviceDataPipeline
    from hemx_torch.data.synthetic import SyntheticDataset
    from hemx_torch.models.plugin import get_model
    from hemx_torch.ops.layers import set_precision
    from hemx_torch.train.loop import _continuous_stream

    own = argparse.ArgumentParser(add_help=False)
    own.add_argument("--calls", type=int, default=3)
    own.add_argument("--out", default="profile_torch_iwgan.json")
    mine, rest = own.parse_known_args()
    args = parse_args(HEADLINE + rest)
    if not torch.cuda.is_available():
        print("profile_torch_iwgan: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device(args.device)
    set_precision(args.precision)
    model = get_model(args.model)(args, dev)
    split = SyntheticDataset.get_datasets(args)["train"]
    h, w, c = split.source.arrays["image"].shape[1:]
    ts = model.init_state((c, h, w), args.seed)
    pipe = DeviceDataPipeline.maybe(split, args.batch_size, device=dev,
                                    keys=model.batch_keys, seed=args.seed,
                                    group=model.batches_per_train_call())
    stream = _continuous_stream(pipe)

    def calls(n):
        t0 = time.perf_counter()
        for _ in range(n):
            model.train(ts, stream)
        torch.cuda.synchronize(dev)
        return (time.perf_counter() - t0) / n

    calls(2)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        calls(mine.calls)
        window_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    by_name: dict = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    total = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:30]

    ab = {False: [], True: []}
    for _ in range(3):
        for bench in (False, True):
            torch.backends.cudnn.benchmark = bench
            calls(1)  # lets a newly chosen algorithm settle outside the timing
            ab[bench].append(calls(3))
    torch.backends.cudnn.benchmark = False

    card = torch.cuda.get_device_name(dev)
    record = {
        "card": card, "model": args.model, "batch_size": args.batch_size,
        "dtype": args.dtype, "calls_profiled": mine.calls,
        "window_ms_per_call": window_us / 1e3 / mine.calls,
        "device_busy_share": _busy_share(kernels, window_us),
        "kernel_ms_per_call": total / 1e3 / mine.calls,
        "kernel_launches_per_call": len(kernels) / mine.calls,
        "top_kernels_ms_per_call": [(n, t / 1e3 / mine.calls) for n, t in top],
        "cudnn_benchmark_ab_s_per_call": {str(k): v for k, v in ab.items()},
    }
    print(f"card: {card}; {args.model} bs{args.batch_size} {args.dtype}; "
          f"profiled {mine.calls} calls: "
          f"{record['window_ms_per_call']:.1f} ms/call wall, "
          f"{record['kernel_ms_per_call']:.1f} ms/call kernel time, device "
          f"busy {100 * record['device_busy_share']:.1f} %, "
          f"{record['kernel_launches_per_call']:.0f} kernel launches/call")
    for n, t in record["top_kernels_ms_per_call"]:
        print(f"  {t:9.3f} ms  {100 * t * mine.calls * 1e3 / total:5.1f} %  "
              f"{n[:110]}")
    for k, v in ab.items():
        print(f"cudnn.benchmark={k}: s/call "
              f"{[round(x, 4) for x in v]} median {statistics.median(v):.4f}")
    os.makedirs(os.path.dirname(mine.out) or ".", exist_ok=True)
    with open(mine.out, "w") as f:
        json.dump(record, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
