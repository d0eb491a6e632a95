"""The readings the limits of ``correct`` are set from (``hxbench/limits``),
on the card at the cell's own size; no benchmark run runs this:

    python3 -m hxbench.calibrate --workload <cell> --seeds 1 2 ... \\
        --control_seeds 1 2 3 [--out FILE]

For each of ``--seeds``: the numbers of the program's compared calls
against the reference (the lower reading is their largest). For each of
``--control_seeds``: the numbers of the control, and of the faults a
training cell can have, planted in the reference put in the program's
place (the upper reading is the least that fails):

* ``control``: the configuration's ``control``: the program with some flags
  changed (``{"flags": {...}}``: its own lower-precision path), or the
  reference with the operands of every product rounded
  (``{"round": "fp8_e4m3"}``);
* ``half``: the mean taken over half of every batch;
* ``alone`` (cells on several cards): each step on one card's rows alone,
  the exchange between the cards left out.

A state left unchanged reads 1 in ``change`` and needs no run. One JSON
line per reading on standard output, and all of them in ``--out``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def _leaves(prog: dict, ref: dict) -> dict:
    """Each leaf's reference norms and gaps, for a look at which leaves
    drive a number."""
    return {k: [ref["moment"][k], prog["moment"][k] - ref["moment"][k],
                ref["change"][k], prog["change"][k] - ref["change"][k]]
            for k in ref["moment"]}


def readings(cell: dict, seeds: list, control_seeds: list, rank: int = 0,
             port: int = 0, device: str = "cuda") -> list:
    from hxbench import judge, session
    from hxbench.reference import plain
    world = cell["chips"]
    if world > 1:
        from hemx_torch.parallel import mesh
        mesh.TIMEOUT_S = 600
        mesh.initialize_distributed(f"localhost:{port}", world, rank,
                                    device=device)
    control = cell["config"]["control"]
    out = []

    def emit(kind, seed, nums, seconds, raw=None):
        if rank == 0:
            line = {"kind": kind, "seed": seed, "seconds": seconds, **nums,
                    **({"losses": raw} if raw else {})}
            print(json.dumps(line), flush=True)
            out.append(line)

    def program(seed, override=None):
        t = time.perf_counter()
        prog = session.Program(cell, seed, device, override)
        dev = prog.device
        mine = prog.compared()
        prog.close()
        ref = judge.reference(cell, seed, dev)
        nums = judge.numbers(mine, ref)
        raw = {"program": mine["losses"], "reference": ref["losses"],
               "leaves": _leaves(mine, ref)}
        if world > 1:
            import torch.distributed as dist
            every = [None] * world
            dist.all_gather_object(every, nums)
            nums = {k: max(n[k] for n in every) for k in judge.NUMBERS}
        return nums, time.perf_counter() - t, dev, raw

    dev = None
    for seed in seeds:
        nums, s, dev, raw = program(seed)
        emit("program", seed, nums, s, raw)
    for seed in control_seeds:
        if "flags" in control:
            nums, s, dev, raw = program(seed, control["flags"])
            emit("control", seed, nums, s, raw)
        if rank:
            continue
        ref = judge.reference(cell, seed, dev)
        runs = [("half", {"fault": "half"})]
        if "round" in control:
            runs.insert(0, ("control", {"round": getattr(
                plain, control["round"])}))
        if world > 1:
            runs.append(("alone", {"fault": "alone", "rows_of": world}))
        for kind, kw in runs:
            t = time.perf_counter()
            other = judge.reference(cell, seed, dev, **kw)
            emit(kind, seed, judge.numbers(other, ref),
                 time.perf_counter() - t,
                 {"program": other["losses"], "reference": ref["losses"],
                  "leaves": _leaves(other, ref)})
    if world > 1:
        import torch.distributed as dist
        dist.barrier()
        mesh.shutdown()
    return out


def main(argv=None) -> int:
    from hxbench import run, spec
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control_seeds", type=int, nargs="*", default=[])
    p.add_argument("--out", default=None)
    p.add_argument("--rank", type=int, default=0, help=argparse.SUPPRESS)
    p.add_argument("--port", type=int, default=0, help=argparse.SUPPRESS)
    a = p.parse_args(argv)
    cell = spec.cell(a.workload)
    if a.rank:
        readings(cell, a.seeds, a.control_seeds, a.rank, a.port)
        sys.stdout.flush()
        os._exit(0)
    own = ["--workload", a.workload, "--seeds", *map(str, a.seeds),
           "--control_seeds", *map(str, a.control_seeds)]
    lines = run.launch("hxbench.calibrate", own, cell["chips"],
                       lambda port: readings(cell, a.seeds, a.control_seeds,
                                             port=port))
    if lines is None:
        return 1
    if a.out:
        with open(a.out, "w") as f:
            json.dump(lines, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
