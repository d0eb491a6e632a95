"""The benchmark of ``hemx_torch``, the PyTorch and CUDA port of hemx:

    python3 -m hxbench.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

runs one cell of ``BENCHMARK.json`` on the card(s) of this machine and
prints one JSON line last on standard output: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics, or with ``--trace
1`` its per-layer ones), ``device``, with ``--trace 1`` ``breakdown``, and
last ``checks``, each number ``correct`` compared beside its limit (also
the last lines on standard error). No result, and a nonzero exit, without
CUDA or with fewer cards than the cell asks for, or when JAX, flax or the
JAX package hemx was loaded.

A four-card cell runs one process per card: this one is rank 0 and starts
ranks 1-3 (``--rank``), which join it over NCCL at a localhost port.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import threading
import time

T0 = time.perf_counter()  # the run's start, for setup_s (torch not loaded)

#: top-level modules no run may load, compared whole
FORBIDDEN = ("jax", "jaxlib", "flax", "hemx")


def leaked() -> list:
    """Loaded modules whose top-level name is in :data:`FORBIDDEN`."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def _parse(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--rank", type=int, default=0, help=argparse.SUPPRESS)
    p.add_argument("--port", type=int, default=0, help=argparse.SUPPRESS)
    return p.parse_args(argv)


def run_rank(cell: dict, seed: int, seconds: float, trace: bool,
             device: str = "cuda", rank: int = 0, port: int = 0,
             t0: float = T0) -> dict | None:
    """One rank's run of ``cell``; rank 0 returns the result line's
    object, other ranks None."""
    import torch

    from hxbench import judge, session
    from hxbench import trace as tr
    world = cell["chips"]
    if world > 1:
        from hemx_torch.parallel import dp, mesh
        mesh.TIMEOUT_S = 300
        mesh.initialize_distributed(f"localhost:{port}", world, rank,
                                    device=device)
    marks = [("start", t0), ("import", time.perf_counter())]
    prog = session.Program(cell, seed, device)
    dev = prog.device
    marks.append(("build", time.perf_counter()))
    readings = prog.compared()
    marks.append(("compared calls", time.perf_counter()))
    warm = []
    for _ in range(session.WARMUP):
        t = time.perf_counter()
        prog.call()
        warm.append(time.perf_counter() - t)
    counts = session.agree(session.plan(seconds, min(warm), trace), dev)
    if world > 1:
        dp.barrier(dev)  # the ranks' windows start together
    session.sync(dev)
    marks.append(("warm-up calls", time.perf_counter()))
    if rank == 0:
        print("set-up: " + ", ".join(
            f"{name} {b - a:.2f} s" for (_, a), (name, b)
            in zip(marks, marks[1:])), file=sys.stderr)
    cuda = dev.type == "cuda"
    setup_peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    reductions = {}
    if world > 1:
        reductions = dict(dp.GRAD_REDUCTIONS)
    setup_s = time.perf_counter() - t0
    win = session.window(prog, counts, trace)
    window_peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    if world > 1:
        per_call = {k: (v - reductions[k]) / win["calls"]
                    for k, v in dp.GRAD_REDUCTIONS.items()}
        if rank == 0:
            print(f"gradient all-reduce per call: {per_call['collectives']} "
                  f"collectives, {per_call['bytes']:.0f} bytes",
                  file=sys.stderr)
    prog.close()
    t = time.perf_counter()
    nums = judge.numbers(readings, judge.reference(cell, seed, dev))
    if rank == 0:
        print(f"reference: {time.perf_counter() - t:.2f} s", file=sys.stderr)
    mine = {"numbers": nums,
            "busy_s": tr.busy(win["trace"]) / 1e6 if trace else None,
            "traced_s": win.get("traced_s"),
            "peak": max(setup_peak, window_peak), "window_peak": window_peak,
            "leaked": leaked()}
    ranks = [mine]
    if world > 1:
        import torch.distributed as dist
        ranks = [None] * world
        dist.all_gather_object(ranks, mine)
        dist.barrier()
        mesh.shutdown()
    if rank:
        return None
    return _result(cell, win, setup_s, ranks, trace, dev)


def _result(cell, win, setup_s, ranks, trace, dev) -> dict:
    import torch

    from hxbench import data, judge, session, spec
    from hxbench import trace as tr
    limits = cell["limits"]
    nums = {k: max(r["numbers"][k] for r in ranks) for k in judge.NUMBERS}
    peak = max(r["peak"] for r in ranks)
    device = {"platform": "gpu" if dev.type == "cuda" else dev.type,
              "kind": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                       else "cpu"),
              "count": cell["chips"], "memory_peak_bytes": peak}
    gb = data.global_batch(cell["traffic"])
    out = {"correct": judge.verdict(nums, limits),
           "attempted": win["calls"], "failed": 0, "metrics": {}}
    if not trace:
        values = {"train_images_per_s": gb * win["calls"] / win["wall_s"],
                  "call_ms_p95": 1e3 * session.p95(win["call_s"]),
                  "setup_s": setup_s}
        for m in cell["end_to_end"]:
            out["metrics"][m["name"]] = {"value": values[m["name"]],
                                         "unit": m["unit"]}
    else:
        t = win["trace"]
        busy_s = sum(r["busy_s"] for r in ranks) / len(ranks)
        window_s = sum(r["traced_s"] for r in ranks) / len(ranks)
        record = {"config": cell["config"], "traffic": cell["traffic"],
                  "chips": cell["chips"], "trace": t,
                  "traced_calls": win["traced_calls"],
                  "calls": win["calls"], "wall_s": win["wall_s"],
                  "per_call": win["per_call"],
                  "busy_s": busy_s, "window_s": window_s,
                  "window_peak_bytes": max(r["window_peak"] for r in ranks),
                  "flops": spec.module("flops", cell["config"]["name"],
                                       cell["here"]),
                  "peaks": spec.read_json(cell["here"] / "peaks.json"),
                  "platform": device["platform"]}
        for m in cell["per_layer"]:
            value = spec.module("metrics", m["name"], cell["here"]).read(
                record)
            if value is not None:
                out["metrics"][m["name"]] = {"value": value,
                                             "unit": m["unit"]}
        device.update(busy_s=busy_s, window_s=window_s)
        out["breakdown"] = tr.breakdown(t, win["host_trace"])
    out["device"] = device
    out["checks"] = {k: {"value": nums[k], "limit": limits[k]}
                     for k in judge.NUMBERS}
    out["leaked"] = sorted({m for r in ranks for m in r["leaked"]})
    return out


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _emit(out: dict) -> int:
    """Print the result (the checks last on standard error too), unless a
    forbidden module was loaded."""
    bad = sorted(set(out.pop("leaked")) | set(leaked()))
    if bad:
        print(f"ERROR: loaded modules named {bad}; no result",
              file=sys.stderr)
        return 3
    checks = out.pop("checks")
    out["checks"] = checks
    for k, v in checks.items():
        print(f"check {k}: {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


def _watch(children) -> None:
    """End the run when a rank fails, rather than wait in a collective for
    it."""
    while True:
        for c in children:
            code = c.poll()
            if code:
                print(f"ERROR: rank {children.index(c) + 1} exited with "
                      f"{code}", file=sys.stderr)
                for other in children:
                    if other.poll() is None:
                        other.kill()
                        other.wait()
                os._exit(1)
        if all(c.poll() == 0 for c in children):
            return
        time.sleep(0.5)


def launch(module: str, own: list, chips: int, rank0):
    """``rank0(port)`` in this process as rank 0, after starting ranks
    1..``chips - 1`` as ``python -m <module> <own> --rank r --port p``
    (their standard output goes to standard error). Returns what
    ``rank0`` returned, or None when a rank failed."""
    port = _free_port() if chips > 1 else 0
    children = []
    try:
        for r in range(1, chips):
            children.append(subprocess.Popen(
                [sys.executable, "-m", module, *own, "--rank", str(r),
                 "--port", str(port)], stdout=sys.stderr))
        if children:
            threading.Thread(target=_watch, args=(children,),
                             daemon=True).start()
        out = rank0(port)
        codes = [c.wait(timeout=120) for c in children]
    finally:
        for c in children:
            if c.poll() is None:
                c.kill()
                c.wait()
    if any(codes):
        print(f"ERROR: ranks exited with {codes}", file=sys.stderr)
        return None
    return out


def main(argv=None) -> int:
    a = _parse(argv)
    from hxbench import spec
    cell = spec.cell(a.workload)
    import torch
    if a.rank:
        run_rank(cell, a.seed, a.seconds, bool(a.trace), rank=a.rank,
                 port=a.port)
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(3 if leaked() else 0)
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < cell["chips"]:
        print(f"ERROR: {a.workload} needs {cell['chips']} CUDA device(s); "
              f"this machine has {have}", file=sys.stderr)
        return 2
    own = ["--workload", a.workload, "--seed", str(a.seed), "--seconds",
           str(a.seconds), "--trace", str(a.trace)]
    out = launch("hxbench.run", own, cell["chips"],
                 lambda port: run_rank(cell, a.seed, a.seconds,
                                       bool(a.trace), port=port))
    return 1 if out is None else _emit(out)


if __name__ == "__main__":
    sys.exit(main())
