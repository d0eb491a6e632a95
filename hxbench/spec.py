"""What a cell is made of, found by name: ``BENCHMARK.json`` at the root of
the checkout names each cell's configuration and traffic, and every piece
lies in a file of its own under ``hxbench/``:

* ``configs/<config>.json``: the configuration as it runs (the program's
  flags, the inputs' shapes, the peak its arithmetic runs at);
* ``traffic/<traffic>.json``: a traffic mix (batch, devices, cached rows);
* ``limits/<cell>.json``: the limits of the numbers ``correct`` compares;
* ``reference/<config>.py``: the configuration's plain reference;
* ``flops/<config>.py``: its operations per train call;
* ``metrics/<metric>.py``: the reader of one per-layer metric.

A later cell, configuration or metric is new files and new entries in
``BENCHMARK.json``; nothing here names one.
"""

from __future__ import annotations

import importlib.util
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> dict:
    return read_json(root / "BENCHMARK.json")


def module(kind: str, name: str, here: Path = HERE):
    """``hxbench/<kind>/<name>.py`` loaded as a module (names hold dots
    and dashes, so by path)."""
    key = f"hxbench_{kind}_{name}".replace(".", "_").replace("-", "_")
    if key in sys.modules:
        return sys.modules[key]
    path = here / kind / f"{name}.py"
    loaded = importlib.util.spec_from_file_location(key, path)
    if loaded is None or not path.is_file():
        raise FileNotFoundError(f"no {kind} file {path}")
    mod = importlib.util.module_from_spec(loaded)
    sys.modules[key] = mod
    loaded.loader.exec_module(mod)
    return mod


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell(name: str, root: Path = ROOT) -> dict:
    """The cell ``name`` of ``BENCHMARK.json``: its entry, its
    configuration (``config``), traffic (``traffic``) and limits
    (``limits``), and the end-to-end and per-layer metrics it reports."""
    bench = benchmark(root)
    here = root / "hxbench"
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload '{name}' in BENCHMARK.json; there are "
                       f"{[w['name'] for w in bench['workloads']]}")
    config = dict(read_json(here / "configs" / f"{entry['config']}.json"),
                  name=entry["config"])
    traffic = read_json(here / "traffic" / f"{entry['traffic']}.json")
    return {"name": name, "chips": int(entry["chips"]), "config": config,
            "traffic": traffic,
            "limits": read_json(here / "limits" / f"{name}.json"),
            "end_to_end": [m for m in bench["end_to_end"]
                           if _applies(m, name)],
            "per_layer": [m for m in bench["per_layer"] if _applies(m, name)],
            "here": here}
