#!/usr/bin/env python3
"""Bring-up smoke test of hemx_torch on one NVIDIA GPU.

    python3 chip_smoke.py        # from the root of a hemx checkout

Phases (each raises on failure, so the script exits nonzero and never
prints its last line):

1. Card: ``nvidia-smi`` name and power limit; torch / CUDA / cuDNN / Triton
   versions.
2. Kernel vs plain: the Triton gather+normalize kernel against its plain
   PyTorch version at the training path's shapes (a 4096x64x64x3 uint8
   dataset, a 3072-row index = 6 batches of 512, lo/hi (0,1) and (-1,1))
   and at an odd shape (37 rows of 5x7x3); max abs diff <= 1e-6 (at most
   one float32 ulp on [-1, 1]); median CUDA-event time of each over 25
   launches.
3. Card vs CPU at a small size (latent 16, 32 px, batch 8, --precision
   highest, sgd): one IWGAN train call from the same weights, batches and
   noise on cuda and on cpu; losses rtol 5e-4 / atol 1e-5, params and G's
   BN stats rtol 2e-3 / atol 2e-5 (tests/test_models.py:324-332).
4. The slice at full width through the CLI: IWGAN latent 200, 64x64x3,
   batch 512, 5 critic steps + 1 generator step per call, Adam, 8 calls
   on a 4096-image uint8 dataset (the stream crosses epoch tails). Checks
   finite losses, step == 8, changed G and D params, everything on cuda,
   and that the kernel launched once per batch group (plus once per tail
   batch). Prints the median call time and images/s beside the card name.

The line before the last is a JSON list of the kernels with their launch
counts from phase 4 and their phase-2 errors and times; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def phase_card(torch) -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(out, flush=True)
    import triton
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, cuDNN "
          f"{torch.backends.cudnn.version()}, Triton {triton.__version__}",
          flush=True)
    return out


def _median_ms(torch, fns: dict, n: int = 25, warmup: int = 3) -> dict:
    """Median CUDA-event time per launch of each fn, launched in turns."""
    for _ in range(warmup):
        for f in fns.values():
            f()
    torch.cuda.synchronize()
    events = {k: [] for k in fns}
    for _ in range(n):
        for k, f in fns.items():
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            f()
            e.record()
            events[k].append((s, e))
    torch.cuda.synchronize()
    return {k: statistics.median(s.elapsed_time(e) for s, e in v)
            for k, v in events.items()}


def phase_kernel(torch, dev) -> dict:
    from hemx_torch.ops import input_kernels as K
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    cases = []
    ds = torch.randint(0, 256, (4096, 64, 64, 3), dtype=torch.uint8,
                       device=dev, generator=g)
    idx = torch.randperm(4096, device=dev, generator=g)[:3072]
    for lo, hi in ((0.0, 1.0), (-1.0, 1.0)):
        cases.append((ds, idx, lo, hi))
    cases.append((ds, idx.to(torch.int32), 0.0, 1.0))
    odd = torch.randint(0, 256, (50, 5, 7, 3), dtype=torch.uint8, device=dev,
                        generator=g)
    odd_idx = torch.randint(0, 50, (37,), device=dev, generator=g)
    cases += [(odd, odd_idx, 0.0, 1.0), (odd, odd_idx, -1.0, 1.0)]
    max_err = 0.0
    for d, i, lo, hi in cases:
        a = K.gather_u8_normalize(d, i, lo, hi)
        b = K.gather_u8_normalize_ref(d, i, lo, hi)
        torch.cuda.synchronize()
        n, h, w, c = d.shape
        check(a.shape == (i.numel(), c, h, w) and a.dtype == torch.float32,
              f"kernel output {a.dtype} {tuple(a.shape)}")
        check(a.is_contiguous(memory_format=torch.channels_last),
              "kernel output is not channels_last")
        err = (a - b).abs().max().item()
        print(f"kernel vs plain: ds {tuple(d.shape)} idx {i.numel()} "
              f"{i.dtype} lo/hi ({lo}, {hi}): max abs diff {err:.3g}",
              flush=True)
        check(err <= 1e-6, f"kernel disagrees with plain version: {err}")
        max_err = max(max_err, err)
    ms = _median_ms(torch, {
        "kernel": lambda: K.gather_u8_normalize(ds, idx, 0.0, 1.0),
        "plain": lambda: K.gather_u8_normalize_ref(ds, idx, 0.0, 1.0)})
    moved = idx.numel() * 64 * 64 * 3 * 5  # uint8 in + float32 out
    print(f"gather_u8_normalize 3072x64x64x3: kernel {ms['kernel']:.4f} ms "
          f"({moved / ms['kernel'] / 1e6:.1f} GB/s), plain {ms['plain']:.4f} "
          f"ms (median of 25 CUDA-event timed launches)", flush=True)
    return {"max_abs_err": max_err, "ms": ms["kernel"],
            "plain_ms": ms["plain"]}


def _close(a, b, rtol, atol, what):
    import numpy as np
    a, b = np.asarray(a), np.asarray(b)
    ok = np.all(np.abs(a - b) <= atol + rtol * np.abs(b))
    check(bool(ok), f"{what}: cuda {a.ravel()[:4]} vs cpu {b.ravel()[:4]} "
                    f"(max abs diff {np.max(np.abs(a - b)):.3g})")


def phase_card_vs_cpu(torch, dev) -> None:
    from hemx_torch import convert
    from hemx_torch.config import parse_args
    from hemx_torch.data.pipeline import DeviceDataPipeline
    from hemx_torch.data.synthetic import SyntheticDataset
    from hemx_torch.models.gan import IwganModel
    from hemx_torch.ops.layers import set_precision

    args = parse_args(["--model", "iwgan", "--dataset", "synthetic",
                       "--synthetic_u8", "--synthetic_count", "64",
                       "--synthetic_shape", "32", "32", "3",
                       "--batch_size", "8", "--latent_size", "16",
                       "--n_disc_train", "5", "--optimizer", "sgd",
                       "--lr", "1e-3", "--precision", "highest",
                       "--seed", "0"])
    set_precision(args.precision)
    split = SyntheticDataset.get_datasets(args)["train"]
    g = torch.Generator()
    g.manual_seed(1)
    noise = [{"z": torch.randn((8, 16), generator=g),
              "alpha": torch.rand((8, 1), generator=g)} for _ in range(5)]
    noise.append({"z": torch.randn((8, 16), generator=g)})
    out = {}
    for d in ("cpu", dev):
        model = IwganModel(args, d)
        ts = model.init_state((3, 32, 32), args.seed)
        pipe = DeviceDataPipeline(split, 8, device=d, keys=("image",),
                                  seed=0, group=model.batches_per_train_call())
        batches = list(pipe.epoch(0))[:6]
        ts, metrics = model.train(ts, iter(batches), noise=noise)
        out[str(d)] = ({k: float(v) for k, v in metrics.items()},
                       convert.to_jax(ts.nets),
                       [b["image"].cpu() for b in batches])
    (m_gpu, (p_gpu, s_gpu), b_gpu), (m_cpu, (p_cpu, s_cpu), b_cpu) = (
        out[str(dev)], out["cpu"])
    for a, b in zip(b_gpu, b_cpu):
        check(torch.equal(a, b), "cuda and cpu batches differ")
    for k in m_cpu:
        _close(m_gpu[k], m_cpu[k], 5e-4, 1e-5, k)
    for tree_gpu, tree_cpu in ((p_gpu, p_cpu), (s_gpu, s_cpu)):
        fg = convert.flatten_tree(tree_gpu)
        fc = convert.flatten_tree(tree_cpu)
        check(sorted(fg) == sorted(fc), "parameter trees differ")
        for k in fc:
            _close(fg[k], fc[k], 2e-3, 2e-5, "/".join(k))
    print(f"card vs cpu (32px, latent 16, batch 8, highest, sgd): losses "
          f"cuda {m_gpu} cpu {m_cpu}; params and BN stats agree", flush=True)


def expected_launches(per_epoch: int, group: int, consumed: int) -> int:
    """Launches of the input kernel while a stream yields ``consumed``
    batches: one per full group, one per epoch-tail batch."""
    launches = got = 0
    while got < consumed:
        for _ in range(per_epoch // group):
            if got < consumed:
                launches, got = launches + 1, got + group
        for _ in range(per_epoch % group):
            if got < consumed:
                launches, got = launches + 1, got + 1
    return launches


def phase_full_width(torch, dev, card: str, *, count: int = 4096,
                     image: int = 64, batch: int = 512, latent: int = 200,
                     calls: int = 8) -> int:
    from hemx_torch import cli
    from hemx_torch.models.gan import IwganModel
    from hemx_torch.ops import input_kernels as K

    argv = ["--model", "iwgan", "--dataset", "synthetic", "--synthetic_u8",
            "--synthetic_count", str(count),
            "--synthetic_shape", str(image), str(image), "3",
            "--batch_size", str(batch), "--latent_size", str(latent),
            "--n_disc_train", "5", "--optimizer", "adam", "--lr", "1e-4",
            "--beta1", "0.5", "--beta2", "0.9", "--epochs", "1",
            "--epoch_size", str(calls), "--device", str(dev), "--seed", "0"]
    K.reset_launches()
    res = cli.run(argv)
    launches = K.LAUNCHES["gather_u8_normalize"]
    ts, hist, pipe = res["train_state"], res["history"], res["pipeline"]
    check(ts.step == calls, f"step {ts.step} != {calls}")
    check(all(math.isfinite(r[k]) for r in hist for k in ("g_loss", "d_loss")),
          f"non-finite loss in {hist}")
    want = expected_launches(count // batch, 6, calls * 6)
    check(launches == want, f"input kernel launched {launches} times, "
                            f"expected {want}")
    check(all(p.device == dev for p in ts.nets.parameters()),
          f"a parameter is not on {dev}")
    check(all(v.device == dev for v in pipe.ds.values()),
          f"the dataset is not on {dev}")
    check(all(b["image"].device == dev for b in pipe.epoch(0)),
          f"a batch is not on {dev}")
    init = IwganModel(res["args"], "cpu").init_state((3, image, image),
                                                     res["args"].seed)
    for net in ("generator", "discriminator"):
        moved = max((a.detach().cpu() - b).abs().max().item() for a, b in zip(
            ts.nets[net].parameters(), init.nets[net].parameters()))
        check(moved > 0, f"{net} params did not change")
    s = res["summary"]
    print(f"IWGAN bs{batch} {image}x{image}x3 latent {latent}, {calls} train "
          f"calls on {card}: "
          f"first call {s['first_call_s']:.4f} s, median call "
          f"{s['median_call_s']:.4f} s, {s['images_per_s']:.1f} images/s "
          f"(calls 2-{calls}, calls x {batch} / seconds); d_loss "
          f"{[round(r['d_loss'], 4) for r in hist]}", flush=True)
    return launches


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    try:
        import hemx_torch  # noqa: F401
    except ImportError:
        print("chip_smoke: hemx_torch not importable; run from the root of "
              "a hemx checkout", file=sys.stderr)
        return 1
    dev = torch.device("cuda:0")
    print("== phase 1: card", flush=True)
    card = phase_card(torch)
    print("== phase 2: kernel vs plain", flush=True)
    kern = phase_kernel(torch, dev)
    print("== phase 3: card vs cpu, small size", flush=True)
    phase_card_vs_cpu(torch, dev)
    print("== phase 4: the slice at full width", flush=True)
    launches = phase_full_width(torch, dev, card)
    print(json.dumps({"kernels": [{
        "name": "gather_u8_normalize", "route": "triton",
        "source": "hemx_torch/ops/input_kernels.py",
        "replaces": "hemx/ops/pallas_kernels.py:75",
        "launches": launches, **kern}]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
