"""Training loop (counterpart of ``hemx.train.loop``).

Semantics, as in ``hemx``:

* ``--epochs n`` trains to epoch n; ``--epochs +n`` trains n more from the
  restored epoch; a ``--dir`` that holds checkpoints resumes from the
  latest;
* a baseline checkpoint and summary at step 0 before any training;
* summaries 10 times per epoch for the first 3 epochs, then 3 times
  (``--summary_freq`` overrides), plus one at each epoch end;
* one checkpoint per epoch, keyed by the epoch counter;
* a validation pass after every epoch, the test split at ``--test_epochs``;
* ``--check_numerics``: the first non-finite gradient raises
  FloatingPointError (the CLI exits nonzero, so a restart loop such as
  ``repeat.sh`` resumes from the last checkpoint);
* ``--profile``: a ``torch.profiler`` trace of up to ten calls of the first
  epoch, written under ``<dir>/profile``.

The data stream is continuous across epochs (the reference's ``repeat()``)
and restarts at the data epoch of the restored training epoch, as in
hemx: a model may pull several batches per call, so an epoch is a number of
calls (``--epoch_size`` caps it), not of pipeline batches.

Input, as in hemx: the device-resident cache when the train split
qualifies (``--device_data_cache``, in-memory arrays within
``--device_cache_mb``, no host ``batch_transform``), else the streaming
``Pipeline``, grouped by the model's batches per call. Validation and test
use the cache when their split qualifies and stream batch by batch
otherwise. The input shape and the summary batch come from the train
split's first host batch in order (after its host transform, e.g. NYUv2's
crop), placed on the device.

Data parallel (``--n_devices``, a process group of W ranks): the global
batch is ``batch_size * W``, as in hemx; it sets the batches per epoch and
images/s, and each rank trains on its rows of it. Under
``--model_parallel`` or ``--spatial_parallel`` K the global batch is
``batch_size * W / K`` (hemx's ``batch_size * data_axis_size``): the K
ranks of a data index share its rows (their slices of the kernels, or
their height bands of the images, which the feeders deliver alone). The
reported losses (history, summaries, validation and test) are their mean
over the ranks (``hemx_torch.parallel.dp.reduce_metrics``), the same on
every rank. Only rank 0 writes options, checkpoints, summaries and console
lines; its summaries see the whole global summary batch, computed on rank
0 alone (``dp.local``), with every kernel whole
(``hemx_torch.parallel.tp.full_weights``). Every rank restores the same
checkpoint on resume.

Each call's losses and wall time are recorded; the time is taken on the
host clock around the train call and a device synchronize, so it covers the
call's device work and nothing else (summaries, checkpoints and validation
are timed apart, in ``timings``, with the train split's host
materialization: records read, decoded and stacked).
"""

from __future__ import annotations

import os
import statistics
import time

import torch

from hemx_torch import convert
from hemx_torch.config import init_working_dir
from hemx_torch.data.pipeline import DeviceDataPipeline, Pipeline, place_batch
from hemx_torch.models import common
from hemx_torch.ops.input_kernels import LAUNCHES
from hemx_torch.parallel import dp, tp
from hemx_torch.summaries.events import SummaryWriterSet
from hemx_torch.train.checkpoint import CheckpointManager
from hemx_torch.utils import terminal as term
from hemx_torch.utils.terminal import MovingAverage

try:
    from tqdm import tqdm
except ImportError:  # pragma: no cover
    tqdm = None


def _continuous_stream(pipeline, start_epoch: int = 0):
    e = start_epoch
    while True:
        yield from pipeline.epoch(e)
        e += 1


def global_batch(args) -> int:
    """``--batch_size`` rows per data index, times the data indices."""
    return args.batch_size * dp.data_axis_size()


def check_spatial(model, split, args) -> None:
    """hemx's refusal of an input height ``--spatial_parallel`` does not
    divide (``hemx/train/loop.py:115-123``), for a model that runs on
    bands."""
    s = dp.spatial_axis_size()
    if s == 1 or not model.band_input:
        return
    host = next(split.iter_epoch(global_batch(args), shuffle=False))
    for k, v in host.items():
        if model.batch_keys and k not in model.batch_keys:
            continue
        shp = v.shape
        if len(shp) >= 3 and (shp[1] < s or shp[1] % s):
            raise ValueError(
                f"--spatial_parallel {s} does not divide the height "
                f"{shp[1]} of input '{k}' {tuple(shp[1:])}; the input "
                f"would silently shard data-parallel only, wasting the "
                f"spatial axis. Pick a dividing height or drop "
                f"--spatial_parallel.")


def _cached(split, args, device, model, *, shuffle: bool, seed: int,
            group: int = 1):
    """The split's DeviceDataPipeline, or None when it must stream."""
    if not args.device_data_cache:
        return None
    return DeviceDataPipeline.maybe(
        split, global_batch(args), device=device, keys=model.batch_keys,
        shuffle=shuffle, seed=seed, budget_mb=args.device_cache_mb,
        group=group, bands=model.band_input)


def _pipeline(split, args, device, model, *, group: int):
    """The train feeder: the device cache, or the streaming Pipeline with
    one group of ``group`` batches (one train call's) per transfer."""
    pipeline = _cached(split, args, device, model, shuffle=args.shuffle,
                       seed=args.seed, group=group)
    if pipeline is not None:
        term.message("Input: device-resident dataset cache (batches "
                     "gathered on the device, no per-step H2D)")
        return pipeline
    term.message(f"Input: streaming pipeline ({group} batch(es) per H2D "
                 f"copy)")
    return Pipeline(split, global_batch(args), device=device,
                    keys=model.batch_keys, shuffle=args.shuffle,
                    seed=args.seed, group=group, bands=model.band_input)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def train(model, splits, args, device) -> dict:
    """Train ``model`` on ``splits`` per ``args``. Returns {"train_state",
    "epoch", "history" (per call of this run: losses and "seconds"),
    "pipeline" (the train feeder), "resumed" (None, or the restored
    checkpoint's path, epoch and step), "timings" (seconds of each
    checkpoint save, restore and summary write, checkpoint bytes, and the
    train split's materialization seconds, None for a source that was in
    memory), "input_kernel_launches", "grad_all_reduce" and
    "axis_collectives" (this run's launches of the input kernel, the
    collectives and bytes of its gradient all-reduces, and those of the
    model or spatial axis's layers and checkpoint and summary gathers;
    "call_axis_collectives" those of the train calls alone)}."""
    device = torch.device(device)
    launches, reductions = dict(LAUNCHES), dict(dp.GRAD_REDUCTIONS)
    axis = dict(tp.COLLECTIVES)
    split = splits["train"]
    check_spatial(model, split, args)
    batches = split.batches_per_epoch(global_batch(args))
    if args.epoch_size > 0:
        batches = min(batches, args.epoch_size)
    if batches == 0:
        raise ValueError(f"dataset ({split.count}) smaller than one global "
                         f"batch ({global_batch(args)})")
    pipeline = _pipeline(split, args, device, model,
                         group=model.batches_per_train_call())
    if dp.is_primary():
        init_working_dir(args)
    ckpt = CheckpointManager(args.dir, args.max_to_keep)
    writers = SummaryWriterSet(args.dir)
    try:
        result = _train(model, splits, args, device, pipeline, batches, ckpt,
                        writers)
    finally:
        writers.close()
    # this run's own, not the process's (experimental trains twice)
    result["input_kernel_launches"] = {k: v - launches[k]
                                       for k, v in LAUNCHES.items()}
    result["grad_all_reduce"] = {k: v - reductions[k]
                                 for k, v in dp.GRAD_REDUCTIONS.items()}
    result["axis_collectives"] = {k: v - axis[k]
                                  for k, v in tp.COLLECTIVES.items()}
    return result


def _train(model, splits, args, device, pipeline, batches, ckpt, writers):
    split = splits["train"]
    timings = {"save_s": [], "restore_s": [], "summary_s": [],
               "checkpoint_bytes": [],
               "materialize_s": getattr(split.source, "materialize_s", None)}
    primary = dp.is_primary()
    host_batch = next(split.iter_epoch(global_batch(args), shuffle=False))
    summary_batch = (place_batch(host_batch, split, device, model.batch_keys)
                     if primary else None)
    ts = model.init_state(model.input_shape(host_batch), args.seed)

    def save(epoch: int) -> None:
        t0 = time.perf_counter()
        path = ckpt.save(convert.to_checkpoint(ts, epoch), epoch)
        if path:  # rank 0 wrote it
            timings["save_s"].append(time.perf_counter() - t0)
            timings["checkpoint_bytes"].append(os.path.getsize(path))

    current_epoch, resumed = 0, None
    latest = ckpt.latest()
    if latest:
        t0 = time.perf_counter()
        current_epoch = convert.load_checkpoint(ts, ckpt.restore(latest))
        _sync(device)
        timings["restore_s"].append(time.perf_counter() - t0)
        resumed = {"path": latest, "epoch": current_epoch, "step": ts.step}
        term.message(f"Resumed from {latest} (epoch {current_epoch}, step "
                     f"{ts.step})")
    # no rank reads the directory after rank 0 may write to it
    dp.barrier(device)
    epochs = str(args.epochs)
    max_epochs = (current_epoch + int(epochs[1:]) if epochs.startswith("+")
                  else int(epochs))
    stream = _continuous_stream(pipeline, current_epoch)

    def write_train_summary(step: int, metrics: dict | None = None,
                            end_of_epoch: bool = False) -> None:
        with tp.full_weights(ts.nets):
            if primary:
                with dp.local():
                    _write_train_summary(step, metrics, end_of_epoch)

    def _write_train_summary(step: int, metrics: dict | None,
                             end_of_epoch: bool) -> None:
        t0 = time.perf_counter()
        wr = writers["train"]
        if metrics:
            wr.scalars({f"losses/{k}": v for k, v in metrics.items()
                        if k != "grad_finite"}, step)
        model.write_summaries(wr, step, ts, summary_batch)
        if args.summarize_activations:
            stats = model.capture_activations(ts, summary_batch)
            if stats:
                common.write_stat_summaries(wr, step, stats, "activations")
        if args.summarize_gradients:
            stats = model.grad_report(ts, summary_batch)
            if stats:
                common.write_stat_summaries(wr, step, stats, "gradients")
        if end_of_epoch and args.summarize_weights:
            params, _ = convert.to_jax(ts.nets)
            for path, leaf in convert.flatten_tree(params).items():
                name = "/".join(path)
                wr.histogram(f"weights/{name}", leaf, step)
                wr.scalar(f"weights_mean/{name}", float(leaf.mean()), step)
        timings["summary_s"].append(time.perf_counter() - t0)

    if ts.step == 0 and current_epoch == 0:
        term.message("Generating baseline summaries and checkpoint...")
        save(0)
        write_train_summary(0)

    prof = None
    history = []
    call_axis = {k: 0 for k in tp.COLLECTIVES}  # the train calls' own
    term.message("Starting training...")
    for epoch in range(current_epoch, max_epochs):
        iterator = range(batches)
        show = tqdm is not None and primary
        if show:
            iterator = tqdm(iterator, desc=f"Epoch {epoch + 1:3d}",
                            unit="batch", leave=False)
        avg, shown, running = MovingAverage(), {}, {}
        per_epoch = args.summary_freq or (10 if epoch < 3 else 3)
        cadence = max(batches // per_epoch, 1)
        # hemx fetches losses every few calls (each fetch is a round trip
        # to its TPU) and averages only those; the port reads every call
        # for its history but averages the same calls
        fetch_every = 1 if args.check_numerics else min(cadence, 4)
        prof_start = min(10, max(batches - 2, 0))
        prof_stop = min(prof_start + 10, batches - 1)
        for i in iterator:
            if (args.profile and primary and epoch == current_epoch
                    and i == prof_start):
                prof = _start_profile(device)
            t0 = time.perf_counter()
            before = dict(tp.COLLECTIVES)
            ts, metrics = model.train(ts, stream)
            _sync(device)
            seconds = time.perf_counter() - t0
            for k, v in tp.COLLECTIVES.items():
                call_axis[k] += v - before[k]
            if prof is not None and i == prof_stop:
                _stop_profile(prof, args.dir)
                prof = None
            host = common.host_scalars(dp.reduce_metrics(metrics))
            if args.check_numerics:
                common.raise_on_bad_grads(host)
            losses = {k: v for k, v in host.items() if k != "grad_finite"}
            history.append({**losses, "seconds": seconds})
            if i % fetch_every == 0 or i % cadence == 0 or i == batches - 1:
                running = avg.update(losses)
                if show:
                    iterator.set_postfix(term.delta_postfix(running, shown))
                    shown = dict(running)
            if i % cadence == 0:
                write_train_summary(ts.step, host)
        recent = history[-batches:]
        med = statistics.median(r["seconds"] for r in recent)
        term.message(f"Epoch {epoch + 1:3d}: " + ", ".join(
            f"{k}={v:.5g}" for k, v in running.items())
            + f", median call {med:.4f} s ({device})")
        write_train_summary(ts.step, running, end_of_epoch=True)
        save(epoch + 1)
        if "validate" in splits:
            inference(model, ts, splits["validate"], args, device,
                      writers["validate"], ts.step, label="Validation")
        if (epoch + 1) in (args.test_epochs or []) and "test" in splits:
            inference(model, ts, splits["test"], args, device,
                      writers["test"], ts.step, label="Test")
    return {"train_state": ts, "epoch": max_epochs, "history": history,
            "pipeline": pipeline, "resumed": resumed, "timings": timings,
            "call_axis_collectives": call_axis}


def _start_profile(device: torch.device):
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    return prof


def _stop_profile(prof, workdir: str) -> None:
    prof.stop()
    out = os.path.join(workdir, "profile")
    os.makedirs(out, exist_ok=True)
    prof.export_chrome_trace(os.path.join(out, "trace.json"))


def inference(model, ts, split, args, device, writer, step: int, *,
              label: str = "Validation") -> dict:
    """Average eval losses over a split's batches (in order) and write one
    summary. The batches come from the device cache when the split
    qualifies, else host batch by host batch (in a process group, this
    rank's rows of each global batch; the losses are the ranks' mean)."""
    feeder = _cached(split, args, device, model, shuffle=False, seed=0)
    if feeder is not None:
        batches = feeder.epoch(0)
    else:
        batches = (place_batch(dp.host_slice(b, bands=model.band_input),
                               split, device, model.batch_keys)
                   for b in split.iter_epoch(global_batch(args),
                                             shuffle=False))
    avg, running = MovingAverage(), {}
    for batch in batches:
        running = avg.update(common.host_scalars(
            dp.reduce_metrics(model.eval_losses(ts, batch))))
    if running:
        writer.scalars({f"losses/{k}": v for k, v in running.items()}, step)
        term.message(f"{label}: " + ", ".join(f"{k}={v:.5g}"
                                              for k, v in running.items()))
    return running


def summarize(result: dict, batch_size: int, device) -> dict:
    """Step count, median call time and images/s of a run. The first call
    (cuDNN algorithm selection, kernel compilation) is left out of both
    when there is more than one; images/s is calls x batch / seconds, as
    ``bench.py`` defines it, ``batch_size`` the global batch. It counts the
    input kernel's launches of this run (none on the CPU, where its plain
    version runs), and in a process group the gradient all-reduces this
    rank ran in it and their bytes, and under a model or spatial axis the
    collectives and bytes of its layers."""
    secs = [r["seconds"] for r in result["history"]]
    out = {"device": str(device), "step": result["train_state"].step,
           "epoch": result["epoch"], "calls": len(secs),
           "global_batch": batch_size, "processes": dp.world_size(),
           "input_kernel_launches": result["input_kernel_launches"]}
    if dp.active():
        out["grad_all_reduce"] = result["grad_all_reduce"]
    if dp.axis_kind():
        calls = max(len(result["history"]), 1)
        out["axis"] = {"kind": dp.axis_kind(), "size": dp.axis_size(),
                       "data": dp.data_axis_size(),
                       **result["axis_collectives"],
                       **{f"{k}_per_call": v / calls for k, v in
                          result["call_axis_collectives"].items()}}
    if secs:
        steady = secs[1:] if len(secs) > 1 else secs
        out.update(first_call_s=secs[0],
                   median_call_s=statistics.median(steady),
                   images_per_s=len(steady) * batch_size / sum(steady))
    return out
