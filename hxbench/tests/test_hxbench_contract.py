"""``BENCHMARK.json`` and the result line keep to the benchmark's
contract, and the harness and the references load neither JAX nor the
JAX package hemx."""

from __future__ import annotations

import io
import json
import re
import subprocess
import sys
import time
from contextlib import redirect_stdout
from pathlib import Path

import pytest

from hxbench import run, spec
from hxbench.tests import tiny

ROOT = Path(__file__).resolve().parents[2]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
WIDTH = re.compile(r"(_dim|_rank)$|hidden|intermediate|latent|state|"
                   r"projection|head|expansion|experts_per")


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_benchmark_json():
    b = spec.benchmark()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert len(b["command"]) <= 32 and all(_line(w) for w in b["command"])
    assert 1 <= len(b["paths"]) <= 16
    for p in b["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p) and ".." not in p
        assert (ROOT / p).is_dir()
    assert 1 <= b["run_seconds"] <= 51
    names = [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    assert len(names) == len(set(names)) and all(map(NAME.match, names))
    cells = {w["name"]: w for w in b["workloads"]}
    configs = {c["name"]: c for c in b["configs"]}
    assert len(cells) == len(b["workloads"])
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["why"])
        assert _line(c["source"]) and (ROOT / c["file"]).is_file()
        assert c["file"].startswith(tuple(p + "/" for p in b["paths"]))
        assert not any(WIDTH.search(k) for k in c["reduced"])
        assert any(w["config"] == c["name"] for w in cells.values())
        assert sorted(json.loads((ROOT / c["file"]).read_text())["reduced"]
                      ) == sorted(c["reduced"])
    pairs = {(w["config"], w["traffic"]) for w in cells.values()}
    assert len(pairs) == len(cells)
    assert sum(w["chips"] == 4 for w in cells.values()) <= max(
        1, len(cells) // 4)
    for w in cells.values():
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in configs and w["chips"] in (1, 4)
        assert _line(w["why"]) and NAME.match(w["traffic"])
        cell = spec.cell(w["name"])
        e2e = {m["name"] for m in cell["end_to_end"]}
        assert "setup_s" in e2e and len(e2e) >= 2 and cell["per_layer"]
        for m in cell["per_layer"]:
            assert m["moves"] in e2e
            assert (spec.HERE / "metrics" / f"{m['name']}.py").is_file()
    for m in b["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in b["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert _line(m["layer"])
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert set(m.get("workloads", cells)) <= set(cells)
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_last_line():
    """The result is the last line of standard output, one JSON object
    with the driver's keys, ``checks`` last, each number beside its
    limit."""
    out = run.run_rank(tiny.cell("pix2pix256-bs64-f32"), 2 ** 31 + 7, 0.5,
                       False, device="cpu", t0=time.perf_counter())
    buf = io.StringIO()
    with redirect_stdout(buf):
        assert run._emit(out) == 0
    line = json.loads(buf.getvalue().strip().splitlines()[-1])
    assert list(line)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(
        line)
    assert set(line["metrics"]) == {"train_images_per_s", "call_ms_p95",
                                    "setup_s"}
    assert all(set(v) == {"value", "unit"} for v in line["metrics"].values())
    assert set(line["device"]) >= {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    assert all(set(v) == {"value", "limit"} for v in line["checks"].values())


def test_forbidden_module_refuses_the_result(capsys):
    out = {"correct": True, "leaked": ["jax"], "checks": {}}
    assert run._emit(out) != 0
    assert capsys.readouterr().out == ""


def test_no_cuda_no_result():
    """Without a card the command prints no result and exits nonzero."""
    p = subprocess.run([sys.executable, "-m", "hxbench.run", "--workload",
                        "iwgan64-bs512-bf16", "--seed", "1", "--seconds",
                        "1", "--trace", "0"], cwd=ROOT, capture_output=True,
                       text=True, timeout=300)
    if p.returncode == 0:
        pytest.skip("this machine has a card")
    assert p.stdout.strip() == ""


def test_loads_no_jax_and_the_reference_no_program():
    """A fresh interpreter that imports the harness and loads every
    reference, flops and metric file holds no module whose top-level name
    is jax, jaxlib, flax or hemx; the references and the flops load
    nothing of hemx_torch."""
    code = (
        "import sys, json\n"
        "from hxbench import spec\n"
        "for kind in ('reference', 'flops'):\n"
        "    for f in sorted((spec.HERE / kind).glob('*.py')):\n"
        "        if f.stem != '__init__':\n"
        "            spec.module(kind, f.stem)\n"
        "top = {m.split('.')[0] for m in sys.modules}\n"
        "import hxbench.run, hxbench.session, hxbench.judge\n"
        "import hxbench.calibrate, hxbench.trace\n"
        "for f in sorted((spec.HERE / 'metrics').glob('*.py')):\n"
        "    spec.module('metrics', f.stem)\n"
        "print(json.dumps([sorted(top), sorted({m.split('.')[0] for m in "
        "sys.modules})]))\n")
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr
    ref_top, all_top = json.loads(p.stdout.strip().splitlines()[-1])
    assert "hemx_torch" not in ref_top
    assert not set(all_top) & {"jax", "jaxlib", "flax", "hemx"}


def test_a_run_loads_no_jax():
    """A whole run of a cell (on the CPU) loads no JAX and no hemx, and
    the names are compared whole: hemx_torch is not hemx."""
    code = ("import sys, time\n"
            "from hxbench import run\n"
            "from hxbench.tests import tiny\n"
            "run.run_rank(tiny.cell('iwgan64-bs512-bf16'), 5, 0.3, True, "
            "device='cpu', t0=time.perf_counter())\n"
            "print(run.leaked(), 'hemx_torch' in sys.modules)\n")
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr
    assert p.stdout.strip().splitlines()[-1] == "[] True"
