"""One run of a training cell against the program (``hemx_torch``).

Set-up, timed as ``setup_s`` from the process's start to the first timed
call: the cell's rows and initial tensors made from the seed on the
device; the program built through its CLI's ``build`` from the
configuration's flags, with the rows as its train split; the initial
tensors loaded into its train state; its device-resident feeder; the
compared calls (:mod:`hxbench.judge`), then :data:`WARMUP` calls as the
window makes them.

The window: train calls as ``hemx_torch.train.loop`` makes them, each the
call, a device synchronize and the losses read to the host (reduced over
the ranks, checked for non-finite gradients where the configuration says
so), as many as fill ``seconds`` at the fastest warm-up call's pace
(:func:`plan`, fixed before the window opens, so that ranks agree with no
collective of the harness's inside it). Under ``trace`` the first calls
of the window run under ``torch.profiler`` (:func:`window`).

Afterwards the program's state is freed and the reference follows the
compared calls (:func:`hxbench.judge.reference`).
"""

from __future__ import annotations

import gc
import math
import statistics
import time

import torch

from hxbench import data, judge, spec
from hxbench import trace as tr
from hxbench.reference import plain

WARMUP = 2
TRACE_S = 3.0
TRACE_CALLS = 4
HOST_CALLS = 2


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def plan(seconds: float, call_s: float, trace: bool) -> dict:
    """The window's calls, from the fastest warm-up call's ``call_s``:
    ``calls``, enough for ``seconds``; under ``trace`` the first
    ``device`` of them (at least :data:`TRACE_S` seconds and
    :data:`TRACE_CALLS` calls) traced on the device alone, the next
    :data:`HOST_CALLS` with the host too."""
    out = {"calls": max(1, math.ceil(seconds / call_s))}
    if trace:
        out["device"] = max(TRACE_CALLS, math.ceil(TRACE_S / call_s))
        out["calls"] = max(out["calls"], out["device"] + HOST_CALLS)
    return out


def agree(counts: dict, device) -> dict:
    """Rank 0's :func:`plan` ``counts`` on every rank, in one broadcast
    before the window, so that every rank makes the same calls."""
    import torch.distributed as dist
    if not dist.is_initialized():
        return counts
    box = [counts]
    dist.broadcast_object_list(box, 0, device=device)
    return box[0]


def _stream(pipeline):
    epoch = 0
    while True:
        yield from pipeline.epoch(epoch)
        epoch += 1


def _moments(ts) -> dict:
    """The optimizers' first moments by leaf name (``generator.<name>``,
    ``discriminator.<name>``)."""
    nets = {"g": "generator", "d": "discriminator"}
    out = {}
    for key, opt in ts.opt.items():
        mu = next(s["mu"] for s in opt.state.values()
                  if isinstance(s, dict) and "mu" in s)
        out.update({f"{nets[key]}.{k}": v for k, v in mu.items()})
    return out


class Program:
    """The program's train state, feeder and call, built for a cell."""

    def __init__(self, cell: dict, seed: int, device: str,
                 override: dict | None = None):
        from hemx_torch import cli
        from hemx_torch.data.pipeline import (ArraySource, DeviceDataPipeline,
                                              Split, U8Normalize)
        from hemx_torch.train import loop
        cfg, traffic = cell["config"], cell["traffic"]
        self.ref = spec.module("reference", cfg["name"], cell["here"])
        host = {k: v.cpu().numpy()
                for k, v in data.rows(cfg, traffic, seed, device).items()}
        split = Split(ArraySource(host), name="train",
                      device_transform=U8Normalize(keys=tuple(sorted(host))))
        self.args, self.device, self.model, _ = cli.build(
            data.argv(cfg, traffic, seed, device, override),
            splits={"train": split})
        self.per_call = self.model.batches_per_train_call()
        data.check(cfg, traffic, self.per_call)
        h, w, c = cfg["inputs"]["image"]
        self.specs = self.ref.specs(cfg)
        self.start = plain.init_state(self.specs, seed, self.device)
        self.ts = self.model.init_state((c, h, w), self.args.seed)
        self.ts.nets.load_state_dict(self.start, strict=True)
        self.pipeline = DeviceDataPipeline.maybe(
            split, loop.global_batch(self.args), device=self.device,
            keys=self.model.batch_keys, shuffle=self.args.shuffle,
            seed=self.args.seed, budget_mb=self.args.device_cache_mb,
            group=self.per_call, bands=self.model.band_input)
        if self.pipeline is None:
            raise RuntimeError("the cell's rows do not qualify for the "
                               "program's device-resident cache")
        self.stream = _stream(self.pipeline)
        self.cell, self.seed = cell, seed

    def call(self, noise=None) -> dict:
        """One train call as the loop makes it: the call, a synchronize,
        the losses on the host (a non-finite gradient raises
        FloatingPointError under ``--check_numerics``)."""
        from hemx_torch.models import common
        from hemx_torch.parallel import dp
        with torch.profiler.record_function(tr.CALL):
            self.ts, metrics = self.model.train(self.ts, self.stream,
                                                noise=noise)
        with torch.profiler.record_function(tr.SYNC):
            sync(self.device)
        with torch.profiler.record_function(tr.READ):
            host = common.host_scalars(dp.reduce_metrics(metrics))
            if self.args.check_numerics:
                common.raise_on_bad_grads(host)
        return {k: v for k, v in host.items() if k != "grad_finite"}

    def compared(self) -> dict:
        """The compared calls, with the noise of each handed in through
        the seam; returns the program's readings (:mod:`hxbench.judge`)."""
        gb = data.global_batch(self.cell["traffic"])
        noise_spec = self.ref.noise_spec(self.cell["config"], gb)
        out = {"losses": []}
        for call in range(data.COMPARED):
            nz = data.noise(noise_spec, self.seed, call, self.device)
            out["losses"].append(self.call(nz))
            if call == 0:
                out["moment"] = judge.norms(_moments(self.ts))
        params = dict(self.ts.nets.named_parameters())
        out["change"] = judge.norms({k: params[k].detach() - self.start[k]
                                     for k in out["moment"]})
        del self.start
        return out

    def close(self) -> None:
        """Free the program's state on the device."""
        for k in ("ts", "model", "pipeline", "stream"):
            setattr(self, k, None)
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


def _profiler(device, host: bool):
    acts = [torch.profiler.ProfilerActivity.CUDA] if device.type == "cuda" \
        else []
    if host or not acts:
        acts.append(torch.profiler.ProfilerActivity.CPU)
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    return prof


def window(prog: Program, counts: dict, trace: bool) -> dict:
    """The train calls of :func:`plan`'s ``counts``: ``calls``, ``wall_s``
    (first call's start to last call's end) and ``call_s`` (each call).
    Under ``trace`` the first ``counts["device"]`` calls trace the device alone (``trace``,
    :func:`hxbench.trace.read`; ``traced_calls``, ``traced_s``), the next
    :data:`HOST_CALLS` the host too (``host_trace``)."""
    out = {}
    prof = _profiler(prog.device, host=False) if trace else None
    times = []
    start = time.perf_counter()
    for i in range(1, counts["calls"] + 1):
        t0 = time.perf_counter()
        prog.call()
        end = time.perf_counter()
        times.append(end - t0)
        if trace and i == counts["device"]:
            prof.stop()
            out.update(traced_calls=i, traced_s=end - start)
            device, prof = prof, _profiler(prog.device, host=True)
            span = torch.profiler.record_function(tr.WINDOW)
            span.__enter__()
        elif trace and i == counts["device"] + HOST_CALLS:
            span.__exit__(None, None, None)
            prof.stop()
    out.update(calls=len(times), wall_s=end - start, call_s=times,
               per_call=prog.per_call)
    if trace:  # read once the window has closed
        out.update(trace=tr.read(device, out["traced_s"]),
                   host_trace=tr.read(prof))
    return out


def p95(values: list) -> float:
    """95th percentile (``statistics.quantiles``, exclusive method; a
    single value is its own)."""
    if len(values) < 2:
        return values[0]
    return statistics.quantiles(values, n=20)[18]
