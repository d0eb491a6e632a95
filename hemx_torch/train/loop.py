"""Training loop of the slice (counterpart of ``hemx.train.loop``).

Epochs of ``batches`` train calls over one continuous stream of device
batches (the reference's ``repeat()``): a model may pull several batches
per call, so an epoch is a number of calls, not of pipeline batches
(``--epoch_size`` caps it). Each call's losses and wall time are recorded;
the time is taken on the host clock around the call and a device
synchronize, so it covers the call's device work.

Not ported yet: checkpoints and resume, summaries, validation and test
passes, the streaming host pipeline, profiling.
"""

from __future__ import annotations

import statistics
import time

import torch

from hemx_torch.data.pipeline import DeviceDataPipeline


def _continuous_stream(pipeline: DeviceDataPipeline):
    e = 0
    while True:
        yield from pipeline.epoch(e)
        e += 1


def train(model, splits, args, device) -> dict:
    """Train ``model`` on ``splits["train"]`` per ``args``. Returns
    {"train_state", "history" (per call: losses and "seconds"),
    "pipeline"}."""
    device = torch.device(device)
    global_batch = args.batch_size
    split = splits["train"]
    batches = split.batches_per_epoch(global_batch)
    if args.epoch_size > 0:
        batches = min(batches, args.epoch_size)
    if batches == 0:
        raise ValueError(f"dataset ({split.count}) smaller than one global "
                         f"batch ({global_batch})")
    pipeline = None
    if args.device_data_cache:
        pipeline = DeviceDataPipeline.maybe(
            split, global_batch, device=device, keys=model.batch_keys,
            shuffle=args.shuffle, seed=args.seed,
            budget_mb=args.device_cache_mb,
            group=model.batches_per_train_call())
    if pipeline is None:
        raise NotImplementedError(
            "the dataset does not fit --device_cache_mb (or "
            "--no-device_data_cache was given); the streaming host pipeline "
            "is not ported to hemx_torch yet (ROADMAP queue 1 item 5)")

    h, w, c = split.source.arrays["image"].shape[1:]
    ts = model.init_state((c, h, w), args.seed)
    epochs = int(str(args.epochs).lstrip("+"))
    stream = _continuous_stream(pipeline)
    history = []
    for epoch in range(epochs):
        for _ in range(batches):
            t0 = time.perf_counter()
            ts, metrics = model.train(ts, stream)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            seconds = time.perf_counter() - t0
            history.append({**{k: float(v) for k, v in metrics.items()},
                            "seconds": seconds})
        recent = history[-batches:]
        losses = ", ".join(f"{k}={statistics.fmean(r[k] for r in recent):.5g}"
                           for k in recent[-1] if k != "seconds")
        med = statistics.median(r["seconds"] for r in recent)
        print(f"Epoch {epoch + 1:3d}: {losses}, median call {med:.4f} s "
              f"({device})", flush=True)
    return {"train_state": ts, "history": history, "pipeline": pipeline}


def summarize(result: dict, batch_size: int, device) -> dict:
    """Step count, median call time and images/s of a run. The first call
    (cuDNN algorithm selection, kernel compilation) is left out of both
    when there is more than one; images/s is calls x batch / seconds, as
    ``bench.py`` defines it."""
    secs = [r["seconds"] for r in result["history"]]
    steady = secs[1:] if len(secs) > 1 else secs
    return {"device": str(device), "step": result["train_state"].step,
            "calls": len(secs), "first_call_s": secs[0],
            "median_call_s": statistics.median(steady),
            "images_per_s": len(steady) * batch_size / sum(steady)}
