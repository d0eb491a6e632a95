"""A configuration, a traffic mix, a cell and a per-layer metric added as
new files (and new entries in ``BENCHMARK.json``) in a copy of the
benchmark are found by name and run, with no existing file edited."""

from __future__ import annotations

import hashlib
import json
import shutil
import time
from pathlib import Path

from hxbench import run, spec

ROOT = Path(__file__).resolve().parents[2]


def _hashes(root: Path) -> dict:
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes())
            .hexdigest() for p in sorted(root.rglob("*")) if p.is_file()
            and "__pycache__" not in p.parts}


def test_new_files_are_found(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "hxbench", tmp_path / "hxbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = _hashes(tmp_path)
    here = tmp_path / "hxbench"
    cfg = json.loads((here / "configs" / "iwgan64-bf16.json").read_text())
    cfg["flags"].update(latent_size=8, n_disc_train=1, dtype="float32",
                        precision="highest")
    cfg["inputs"] = {"image": [8, 8, 3]}
    (here / "configs" / "small-iwgan.json").write_text(json.dumps(cfg))
    for kind in ("reference", "flops"):
        shutil.copy(here / kind / "iwgan64-bf16.py",
                    here / kind / "small-iwgan.py")
    (here / "traffic" / "bs4-rows96.json").write_text(json.dumps(
        {"batch_size": 4, "n_devices": 1, "rows": 96}))
    (here / "limits" / "small-iwgan-bs4.json").write_text(json.dumps(
        {"loss": 1e-3, "grad": 1e-3, "change": 1e-3, "change_max": 1e-2}))
    (here / "metrics" / "traced_calls.py").write_text(
        '"""Calls in the device trace. calls."""\n\n\n'
        'def read(rec):\n    return rec["traced_calls"]\n')
    old = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench = json.loads(json.dumps(old))
    bench["configs"].append({"name": "small-iwgan", "source": "x",
                             "file": "hxbench/configs/small-iwgan.json",
                             "reduced": ["dataset"], "why": "a test"})
    bench["workloads"].append({"name": "small-iwgan-bs4",
                               "config": "small-iwgan",
                               "traffic": "bs4-rows96", "chips": 1,
                               "why": "a test"})
    bench["per_layer"].append({"name": "traced_calls", "unit": "calls",
                               "better": "higher", "source": "device_trace",
                               "layer": "train loop",
                               "moves": "train_images_per_s",
                               "workloads": ["small-iwgan-bs4"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    after = _hashes(tmp_path)
    assert all(after[k] == v for k, v in before.items()
               if k != "BENCHMARK.json")
    assert all(bench[k][:len(v)] == v for k, v in old.items()
               if isinstance(v, list) and k != "command" and k != "paths")

    cell = spec.cell("small-iwgan-bs4", root=tmp_path)
    assert cell["here"] == here
    assert [m["name"] for m in cell["per_layer"]] == ["traced_calls"]
    out = run.run_rank(cell, 31, 0.3, True, device="cpu",
                       t0=time.perf_counter())
    assert out["correct"]
    assert out["metrics"]["traced_calls"]["value"] >= 1
    out = run.run_rank(cell, 32, 0.3, False, device="cpu",
                       t0=time.perf_counter())
    assert set(out["metrics"]) == {"train_images_per_s", "setup_s"}
