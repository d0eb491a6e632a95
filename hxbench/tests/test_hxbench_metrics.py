"""The arithmetic of the metrics on hand-made event lists, and the
operation counts."""

from __future__ import annotations

import json
import statistics
from pathlib import Path

import pytest
import torch

from hxbench import data, judge, run, session, spec
from hxbench import trace as tr

ROOT = Path(__file__).resolve().parents[2]
GEMM = "sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwc_cudnn"
EW = "void at::native::vectorized_elementwise_kernel<4, CUDAFunctor_add>"
NCCL = "ncclDevKernel_AllReduce_Sum_f32_RING_LL(ncclDevKernelArgsStorage)"
INPUT = "gather_u8_normalize_kernel(unsigned char const*, ...)"


def _trace():
    # window 0-100 us; busy 10-40 (gemm 10-30, ew 20-40), 50-70 (nccl
    # 50-70, overlapped by ew 60-65), 80-90 (input)
    return {"window": (0.0, 100.0),
            "device": [(GEMM, 10.0, 30.0), (EW, 20.0, 40.0),
                       (NCCL, 50.0, 70.0), (EW, 60.0, 65.0),
                       (INPUT, 80.0, 90.0), ("Memcpy DtoD", 92.0, 93.0)],
            "host": [("hxbench.window", 0.0, 100.0),
                     ("hxbench.call", 1.0, 95.0),
                     ("aten::item", 40.0, 50.0)]}


def test_classify():
    assert [tr.classify(n) for n, _, _ in _trace()["device"]] == [
        "gemm", "elementwise", "nccl", "elementwise", "input", "memory"]
    assert tr.classify("void convolve_common_engine_float_NHWC<>") == "gemm"
    assert tr.classify("nvjet_hsh_128x256_64x4_2x1_v_bz_coopB_TNT") == "gemm"
    assert tr.classify("void at::native::direct_copy_kernel_cuda") == \
        "elementwise"


def test_busy_union_and_gaps():
    t = _trace()
    assert tr.busy(t) == 30 + 20 + 10 + 1
    assert tr.gaps([(s, e) for _, s, e in t["device"]], 0, 100) == [
        (0, 10), (40, 50), (70, 80), (90, 92), (93, 100)]
    assert tr.union([(3, 4), (0, 2), (1, 3)]) == [(0, 4)]


def test_breakdown_names_gaps_by_the_host():
    b = tr.breakdown(_trace(), _trace())
    assert b["device_ops"][0] == [EW[:160], 25e-6]
    names = dict(b["idle_gaps"])
    assert names["aten::item"] == pytest.approx(10e-6)
    assert names["hxbench.call"] == pytest.approx((10 + 10 + 2) * 1e-6)
    assert names["hxbench.window"] == pytest.approx(7e-6)


def _record(**over):
    cell = spec.cell("iwgan64-bs512-bf16")
    traffic = dict(cell["traffic"], batch_size=256, n_devices=4)
    rec = {"config": cell["config"], "traffic": traffic, "chips": 4, "trace": _trace(), "traced_calls": 2, "calls": 10,
           "wall_s": 5.0, "busy_s": 61e-6, "window_s": 100e-6,
           "per_call": 6, "window_peak_bytes": 3 * 2 ** 30,
           "flops": spec.module("flops", "iwgan64-bf16"),
           "peaks": json.loads((spec.HERE / "peaks.json").read_text()),
           "platform": "gpu"}
    rec.update(over)
    return rec


def _read(name, rec):
    return spec.module("metrics", name).read(rec)


def test_readers():
    rec = _record()
    assert _read("elementwise_ms_per_call", rec) == pytest.approx(
        (20 + 5) / 1e3 / 2)
    assert _read("launches_per_call", rec) == 5 / 2
    assert _read("idle_share", rec) == pytest.approx(39.0)
    assert _read("peak_mem_gib", rec) == 3.0
    flops = rec["flops"].per_call(rec["config"], rec["traffic"])
    assert _read("mfu.train", rec) == pytest.approx(
        100 * flops * 10 / 5.0 / (989e12 * 4))
    # one launch a call of 256 * 6 rows of 64x64x3: u8 read, f32 written,
    # int32 indices, over 10 us at 3.35 TB/s
    rows = 256 * 6
    assert _read("gather_u8_normalize_roofline", rec) == pytest.approx(
        100 * rows * (5 * 64 * 64 * 3 + 4) / 10e-6 / 3.35e12)


def test_readers_find_nothing():
    empty = dict(_trace(), device=[])
    rec = _record(trace=empty, platform="cpu")
    for name in ("elementwise_ms_per_call", "launches_per_call",
                 "gather_u8_normalize_roofline", "idle_share", "mfu.train",
                 "peak_mem_gib"):
        assert _read(name, rec) is None, name


def test_rate_and_tail_over_the_whole_window():
    """images/s is every call's global batch over the window's wall time
    (gaps between calls included); the tail is the 95th percentile of
    every call."""
    cell = spec.cell("pix2pix256-bs64-f32")
    calls = [0.09] * 190 + [0.2] * 10
    win = {"calls": 200, "wall_s": 30.0, "call_s": calls}
    nums = {"numbers": dict.fromkeys(judge.NUMBERS, 0), "peak": 0,
            "window_peak": 0, "leaked": []}
    out = run._result(cell, win, 12.5, [nums], False, torch.device("cpu"))
    m = out["metrics"]
    assert m["train_images_per_s"]["value"] == 64 * 200 / 30.0
    assert m["call_ms_p95"]["value"] == pytest.approx(
        1e3 * statistics.quantiles(calls, n=20)[18])
    assert m["setup_s"]["value"] == 12.5


def test_plan_fills_the_window():
    """The window's calls are fixed before it opens, from the fastest
    warm-up call; a traced run traces at least 3 s and 4 calls of the
    device, then 2 with the host."""
    assert session.plan(30, 0.465, False) == {"calls": 65}
    assert session.plan(30, 0.0896, True) == {"calls": 335, "device": 34}
    assert session.plan(0.1, 1.0, True) == {"calls": 6, "device": 4}


def _macs_iwgan(latent=200, h=64, c=3):
    g = [latent * 16 * 4 * latent, 4 * 4 * 25 * 800 * 400,
         8 * 8 * 25 * 400 * 200, 16 * 16 * 25 * 200 * 100,
         32 * 32 * 25 * 100 * 3]
    d = [32 * 32 * 25 * 3 * 200, 16 * 16 * 25 * 200 * 400,
         8 * 8 * 25 * 400 * 800, 8 * 8 * 800]
    return sum(g), sum(d), g[0], d[0], d[-1]


def test_iwgan_flops():
    """The count by hand, and against XLA's cost analysis of hemx's call
    (53.014 TFLOP at batch 512, ``artifacts/perf_analysis.json``): ours
    counts no dilation zeros but the GP's whole double backward; PERF.md
    gives the difference by step."""
    cell = spec.cell("iwgan64-bs512-bf16")
    f = spec.module("flops", "iwgan64-bf16")
    ours = f.per_call(cell["config"], cell["traffic"])
    g, d, fc1, c1, fc2 = _macs_iwgan()
    critic = g + 10 * d - 2 * c1 - fc2
    gen = 3 * g + 3 * d - fc1
    assert ours == 2 * 512 * (5 * critic + gen)
    xla = json.loads((ROOT / "artifacts" / "perf_analysis.json").read_text())
    assert xla["batch"] == 512
    assert ours / (xla["train_call_flops_T"] * 1e12) == pytest.approx(
        1.122, abs=0.005)


def test_flops_follow_the_global_batch():
    for cell in ("iwgan64-bs512-bf16", "pix2pix256-bs64-f32"):
        c = spec.cell(cell)
        f = spec.module("flops", c["config"]["name"])
        one = f.per_call(c["config"], {"batch_size": 1, "n_devices": 1})
        assert f.per_call(c["config"], {"batch_size": 8, "n_devices": 4}) \
            == 32 * one
    c = spec.cell("pix2pix256-bs64-f32")
    assert spec.module("flops", "pix2pix256-f32").per_call(
        c["config"], c["traffic"]) == pytest.approx(4.757213e12, rel=1e-6)


def test_traffic_rows_are_whole_calls():
    for w in spec.benchmark()["workloads"]:
        c = spec.cell(w["name"])
        data.check(c["config"], c["traffic"],
                   int(c["config"]["flags"]["n_disc_train"]) + 1)
    with pytest.raises(ValueError):
        data.check({}, {"batch_size": 4, "n_devices": 1, "rows": 30}, 2)
