"""Reading the traced parts of a window: device operations and host spans
from ``torch.profiler``, and the interval arithmetic the per-layer metrics
share (busy union, idle gaps). Kernels are classified by name
here and nowhere else.

Times are microseconds on the profiler's clock. The device metrics come
from a trace of the device alone, whose cost to the host is small; the
host's spans and operators, which cost the host several microseconds each,
from a short second trace that only names the idle gaps (its window is the
benchmark's span :data:`WINDOW`).
"""

from __future__ import annotations

import re
from collections import defaultdict

import numpy as np

#: the benchmark's spans, recorded around the calls into the program
WINDOW, CALL, SYNC, READ = ("hxbench.window", "hxbench.call", "hxbench.sync",
                            "hxbench.read_losses")

SPANS = "hxbench."

_GEMM = re.compile(r"gemm|xmma|cutlass|nvjet|convolve|fprop|dgrad|wgrad|"
                   r"winograd|fft", re.I)


def classify(name: str) -> str:
    """``input`` (the port's input kernel), ``nccl``, ``gemm`` (a cuDNN
    or cuBLAS convolution or matrix product), ``memory`` (a copy or set
    the runtime issues) or ``elementwise`` (every other kernel)."""
    if "gather_u8_normalize" in name:
        return "input"
    if "nccl" in name.lower():
        return "nccl"
    if name.startswith(("Memcpy", "Memset")):
        return "memory"
    if _GEMM.search(name):
        return "gemm"
    return "elementwise"


def union(intervals) -> list:
    """Sorted, merged ``(start, end)`` intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return [tuple(x) for x in out]


def length(intervals) -> float:
    return sum(e - s for s, e in union(intervals))


def clip(intervals, lo: float, hi: float) -> list:
    return [(max(s, lo), min(e, hi)) for s, e in intervals
            if e > lo and s < hi]


def gaps(intervals, lo: float, hi: float) -> list:
    """The idle ``(start, end)`` stretches of ``[lo, hi]`` between busy
    intervals."""
    out, t = [], lo
    for s, e in union(clip(intervals, lo, hi)):
        if s > t:
            out.append((t, s))
        t = max(t, e)
    if hi > t:
        out.append((t, hi))
    return out


def read(prof, wall_s: float | None = None) -> dict:
    """What a finished profiler recorded: ``device`` ``[(name, start,
    end)]`` of every device operation and ``host`` ``[(name, start, end)]``
    of every host span and operator, in ``window`` ``(start, end)``: the
    :data:`WINDOW` span, or where the trace holds no host spans (a
    device-only trace of calls that each end in a synchronize) the
    ``wall_s`` seconds from its first device operation."""
    from torch.autograd import DeviceType
    device, host = [], []
    for e in prof.events():
        item = (e.name, float(e.time_range.start), float(e.time_range.end))
        if e.device_type != DeviceType.CUDA:
            host.append(item)
        elif not e.name.startswith(SPANS):  # the spans' device-side copies
            device.append(item)
    spans = [h for h in host if h[0] == WINDOW]
    if spans:
        lo, hi = spans[0][1], spans[0][2]
    elif wall_s is not None:
        lo = min((s for _, s, _ in device), default=0.0)
        hi = lo + wall_s * 1e6
    else:
        raise RuntimeError(f"the trace holds no '{WINDOW}' span")
    return {"window": (lo, hi),
            "device": [d for d in device if d[2] > lo and d[1] < hi],
            "host": [h for h in host if h[2] > lo and h[1] < hi]}


def busy(trace: dict) -> float:
    """Microseconds of the window in which some device operation ran."""
    lo, hi = trace["window"]
    return length(clip([(s, e) for _, s, e in trace["device"]], lo, hi))


def kernel_time(trace: dict, kind: str) -> float:
    """Summed device time of the kernels of class ``kind``."""
    return sum(e - s for n, s, e in trace["device"] if classify(n) == kind)


def breakdown(device: dict, host: dict, top: int = 10) -> dict:
    """``device_ops``: the device operations of trace ``device`` with the
    most time, summed by name; ``idle_gaps``: the idle time of trace
    ``host``'s window summed by what the host was doing (the innermost
    host span or operator around each gap's middle), longest first.
    Seconds."""
    by_name = defaultdict(float)
    for n, s, e in device["device"]:
        by_name[n[:160]] += (e - s) / 1e6
    lo, hi = host["window"]
    idle = gaps([(s, e) for _, s, e in host["device"]], lo, hi)
    names = [h[0] for h in host["host"]]
    start = np.array([h[1] for h in host["host"]])
    end = np.array([h[2] for h in host["host"]])
    by_host = defaultdict(float)
    for s, e in sorted(idle, key=lambda g: g[0] - g[1])[:200]:
        mid = (s + e) / 2
        inner = np.flatnonzero((start <= mid) & (end >= mid))
        name = (names[inner[np.argmin(end[inner] - start[inner])]]
                if inner.size else "no host span")
        by_host[name[:160]] += (e - s) / 1e6
    rest = sum(e - s for s, e in idle) / 1e6 - sum(by_host.values())
    if rest > 1e-9:
        by_host["shorter gaps"] += rest

    def ranked(d):
        return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])
                [:top]]
    return {"device_ops": ranked(by_name), "idle_gaps": ranked(by_host)}
