"""The readers of the program's spans (``source: program_span``) on
hand-made call records, on a program without spans, and in a traced run
on the CPU."""

from __future__ import annotations

import sys
import time

import pytest

from hxbench import run, session, spec
from hxbench.tests import tiny

P = "hemx_torch."
DEVICE = ("critic_ms_per_call", "generator_ms_per_call",
          "backward_ms_per_call", "optimizer_ms_per_call")
HOST = ("input_host_ms_per_call", "call_host_ms_per_call")


def _call(scale):
    """One call's spans, (host s, device s), summed by name."""
    return {"spans": {P + "call": (0.030 * scale, 0.460 * scale),
                      P + "input.order": (0.001 * scale, 0.0),
                      P + "input.assemble": (0.0002 * scale, 0.0001),
                      P + "step.critic": (0.020 * scale, 0.380 * scale),
                      P + "step.generator": (0.005 * scale, 0.070 * scale),
                      P + "backward": (0.010 * scale, 0.270 * scale),
                      P + "optimizer": (0.004 * scale, 0.006 * scale)},
            "counters": {}}


@pytest.fixture
def calls(monkeypatch):
    """The program's record replaced by ``box[0]``: two traced calls, then
    one host-traced call the readers leave out."""
    from hemx_torch.utils import tracing
    box = [[_call(1.0), _call(3.0), _call(100.0)]]
    monkeypatch.setattr(tracing, "calls", lambda: box[0])
    return box


def _read(name, **over):
    rec = {"traced_calls": 2, "platform": "gpu", **over}
    return spec.module("metrics", name).read(rec)


def test_readers(calls):
    ms = {"critic_ms_per_call": 380, "generator_ms_per_call": 70,
          "backward_ms_per_call": 270, "optimizer_ms_per_call": 6,
          "input_host_ms_per_call": 1.2, "call_host_ms_per_call": 30}
    for name, one in ms.items():  # calls of scale 1 and 3: twice one
        assert _read(name) == pytest.approx(2 * one), name
    calls[0][0]["spans"][P + "input.wait"] = (0.004, None)
    assert _read("input_host_ms_per_call") == pytest.approx(2 * 1.2 + 2)


def test_readers_find_nothing(calls, monkeypatch):
    for name in DEVICE:
        assert _read(name, platform="cpu") is None, name
    for name in HOST:
        assert _read(name, platform="cpu") is not None, name
    calls[0] = [{"spans": {P + "call": (0.03, None)}, "counters": {}}]
    for name in DEVICE:  # no such span, or no device time
        assert _read(name) is None, name
    assert _read("input_host_ms_per_call") is None
    calls[0] = []
    for name in DEVICE + HOST:
        assert _read(name) is None, name
    import hemx_torch.utils
    monkeypatch.delattr(hemx_torch.utils, "tracing")
    monkeypatch.setitem(sys.modules, "hemx_torch.utils.tracing", None)
    calls[0] = [_call(1.0)]
    for name in DEVICE + HOST:  # a program with no spans
        assert _read(name) is None, name


def test_traced_run_reads_the_host_spans(monkeypatch):
    """A traced run on the CPU (its device-traced stretch cut to the
    fewest calls) reports the host readers and leaves out the device
    readers."""
    from hemx_torch.utils import tracing
    monkeypatch.setattr(session, "TRACE_S", 0.0)
    tracing.reset()
    out = run.run_rank(tiny.cell("iwgan64-bs512-bf16"), 2 ** 31 + 11, 0.3,
                       True, device="cpu", t0=time.perf_counter())
    tracing.reset()
    assert out["correct"]
    m = out["metrics"]
    assert not set(DEVICE) & set(m)
    assert 0 < m["input_host_ms_per_call"]["value"] < m[
        "call_host_ms_per_call"]["value"]
    assert m["call_host_ms_per_call"]["unit"] == "ms"
