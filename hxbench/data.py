"""The traffic of a training cell, made from the seed: the cached uint8
rows, the noise of the compared calls, the flags the program runs with, and
the order in which the program's feeder walks the rows, worked out again
for the reference. Both sides take their inputs from here; neither takes
anything the other made.

A traffic file (``hxbench/traffic/<traffic>.json``) holds:

* ``batch_size``: rows per device and step (hemx's ``--batch_size``);
* ``n_devices``: devices of the data axis (hemx's ``--n_devices``); the
  global batch is their product;
* ``rows``: rows cached on each device; a multiple of one call's global
  batches, so every call gathers one group, and at least the compared
  calls' batches, so those see no row twice.
"""

from __future__ import annotations

import numpy as np
import torch

#: train calls that set-up runs through the noise seam and the reference
#: follows
COMPARED = 3


def sub_seed(seed: int, stream: int) -> int:
    """A 64-bit seed of stream ``stream`` of the run's ``seed`` (any
    integer)."""
    return int(np.random.SeedSequence([seed % 2 ** 64, stream])
               .generate_state(1, np.uint64)[0])


def program_seed(seed: int) -> int:
    """The program's ``--seed``: its data order and its own noise."""
    return seed % 2 ** 63


def global_batch(traffic: dict) -> int:
    return int(traffic["batch_size"]) * int(traffic["n_devices"])


def check(config: dict, traffic: dict, per_call: int) -> None:
    """Refuse a traffic whose rows are not whole calls, or too few for the
    compared calls to see distinct rows."""
    group = global_batch(traffic) * per_call
    rows = int(traffic["rows"])
    if rows % group or rows < COMPARED * group:
        raise ValueError(f"traffic rows {rows}: not a multiple of one "
                         f"call's {group} rows, or under {COMPARED} calls")


def rows(config: dict, traffic: dict, seed: int, device) -> dict:
    """``{key: (rows, H, W, C) uint8}`` on ``device``, uniform from the
    seed, one draw per key of the configuration's ``inputs`` in name
    order."""
    gen = torch.Generator(device=device)
    gen.manual_seed(sub_seed(seed, 2))
    n = int(traffic["rows"])
    return {k: torch.randint(0, 256, (n, *config["inputs"][k]),
                             dtype=torch.uint8, generator=gen, device=device)
            for k in sorted(config["inputs"])}


def argv(config: dict, traffic: dict, seed: int, device: str,
         override: dict | None = None) -> list:
    """The program's command line: the configuration's flags (``override``
    replacing some), the traffic's batch and devices, the seed and the
    device."""
    flags = dict(config["flags"], **(override or {}))
    out = []
    for k, v in flags.items():
        if v is True:
            out.append(f"--{k}")
        elif v is not False:
            out += [f"--{k}", str(v)]
    return out + ["--batch_size", str(traffic["batch_size"]),
                  "--n_devices", str(traffic["n_devices"]),
                  "--seed", str(program_seed(seed)), "--device", device]


def call_indices(seed: int, traffic: dict, per_call: int, call: int) -> list:
    """The global batches (row indices) of train call ``call``: hemx's
    order, batch after batch of the epoch's permutation from
    ``SeedSequence([seed, epoch])``, ``per_call`` batches a call."""
    n, b = int(traffic["rows"]), global_batch(traffic)
    order = np.random.default_rng(np.random.SeedSequence(
        [program_seed(seed), 0])).permutation(n)
    first = call * per_call * b
    return [order[first + i * b:first + (i + 1) * b] for i in range(per_call)]


def noise(spec: list, seed: int, call: int, device) -> list:
    """The draws of each substep of compared call ``call``, for the global
    batch: ``spec`` is the reference's ``noise_spec`` (``{name: (shape,
    "normal" | "uniform")}`` per substep)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(sub_seed(seed, 100 + call))
    draw = {"normal": torch.randn, "uniform": torch.rand}
    return [{k: draw[kind](shape, generator=gen, device=device)
             for k, (shape, kind) in sorted(step.items())} for step in spec]
