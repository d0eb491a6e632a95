"""hemx_torch.utils.tracing: the train call's spans and counters.

* With no profiler recording a train call records nothing, opens no
  profiler range and makes no CUDA event.
* Under ``torch.profiler`` (CPU) the IWGAN's, the vanilla GAN's and
  pix2pix's calls record every span at its place (parent, call index), on
  the device-resident feeder and on the streaming one; each is a host
  event of the profiler, none a user annotation.
* In a process group the gradient all-reduce is a span inside the
  optimizer's.
* The counters are the modules' dicts under their old names, and each
  call's record holds their change over the call.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from hemx_torch import cli  # noqa: E402
from hemx_torch.data.pipeline import (ArraySource, Split,  # noqa: E402
                                      U8Normalize)
from hemx_torch.ops import input_kernels as K  # noqa: E402
from hemx_torch.parallel import dp, tp  # noqa: E402
from hemx_torch.train import loop  # noqa: E402
from hemx_torch.utils import tracing  # noqa: E402

P = tracing.PREFIX
GAN = ["--dataset", "synthetic", "--synthetic_u8", "--synthetic_count", "24",
       "--synthetic_shape", "16", "16", "3", "--batch_size", "4",
       "--latent_size", "8", "--device", "cpu", "--seed", "3"]
CASES = {
    "iwgan": ["--model", "iwgan", "--n_disc_train", "2"] + GAN,
    "gan": ["--model", "gan"] + GAN,
    "iwgan_streaming": ["--model", "iwgan", "--n_disc_train", "2",
                        "--no-device_data_cache"] + GAN,
    "pix2pix": ["--model", "pix2pix", "--batch_size", "2", "--device", "cpu",
                "--seed", "3", "--dataset", "synthetic"],
}


def _pix2pix_split():
    rng = np.random.default_rng(0)
    rows = {"image": rng.integers(0, 256, (12, 32, 32, 3), np.uint8),
            "depth": rng.integers(0, 256, (12, 32, 32, 1), np.uint8)}
    return Split(ArraySource(rows), name="train",
                 device_transform=U8Normalize(keys=("depth", "image")))


def _program(case):
    """(model, train state, stream) of a tiny run of ``case``."""
    splits = ({"train": _pix2pix_split()} if case == "pix2pix" else None)
    args, device, model, splits = cli.build(CASES[case], splits=splits)
    split = splits["train"]
    host = next(split.iter_epoch(loop.global_batch(args), shuffle=False))
    ts = model.init_state(model.input_shape(host), args.seed)
    pipe = loop._pipeline(split, args, device, model,
                          group=model.batches_per_train_call())
    return model, ts, loop._continuous_stream(pipe)


@pytest.fixture
def fresh():
    tracing.reset()
    yield
    tracing.reset()


def _profiled(model, ts, stream, calls):
    prof = torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])
    prof.start()
    for _ in range(calls):
        ts, _ = model.train(ts, stream)
    prof.stop()
    return prof


def test_off_records_nothing(fresh, monkeypatch):
    model, ts, stream = _program("iwgan")

    def refused(*a, **k):
        raise AssertionError("a span acted with no profiler recording")
    monkeypatch.setattr(tracing, "_RANGE", refused)
    monkeypatch.setattr(torch.cuda, "Event", refused)
    for _ in range(3):  # crosses a data epoch
        ts, _ = model.train(ts, stream)
    assert tracing.spans() == [] and tracing.calls() == []
    assert tracing.span("backward") is tracing.span("optimizer")


# the spans of one call in order, (name, parent) without the prefix; the
# first call of a run starts the feeder's first epoch
def _expected(case, first):
    feed = (["input.wait"] if case == "iwgan_streaming"
            else ["input.order"] * first + ["input.assemble"])
    out = [("call", None)] + [(n, "call") for n in feed]
    if case == "gan":  # one fused step, two backward passes
        return out + [("step.generator", "call")] + [
            ("backward", "step.generator")] * 2 + [
            ("optimizer", "step.generator")] * 2
    critic = [("step.critic", "call"), ("backward", "step.critic"),
              ("optimizer", "step.critic")]
    n_critic = 1 if case == "pix2pix" else 2
    return out + critic * n_critic + [
        ("step.generator", "call"), ("backward", "step.generator"),
        ("optimizer", "step.generator")]


@pytest.mark.parametrize("case", sorted(CASES))
def test_spans_of_a_call(fresh, case):
    model, ts, stream = _program(case)
    prof = _profiled(model, ts, stream, 2)
    got = [(s.call, s.name[len(P):],
            s.parent[len(P):] if s.parent else None)
           for s in tracing.spans()]
    want = [(call, n, p) for call in range(2)
            for n, p in _expected(case, first=call == 0)]
    assert got == want
    assert all(s.events is None and s.end_ns >= s.start_ns
               for s in tracing.spans())
    calls = tracing.calls()
    assert len(calls) == 2
    assert {n for c in calls for n in c["spans"]} == {P + n for _, n, _ in
                                                      want}
    assert all(d is None for c in calls for _, d in c["spans"].values())
    assert all(c["spans"][tracing.CALL][0] >= c["spans"][P + "backward"][0]
               for c in calls)
    events = [e for e in prof.events() if e.name.startswith(P)]
    assert sorted(e.name for e in events) == sorted(s.name for s in
                                                    tracing.spans())
    assert not any(e.is_user_annotation for e in events)
    assert all(e.device_type == torch.autograd.DeviceType.CPU
               for e in events)


def test_all_reduce_span(fresh, monkeypatch):
    """The all-reduce's span, in a process group (its collective replaced:
    the CPU test has no group), sits inside the optimizer's."""
    from hemx_torch.train import optimizers
    opt = optimizers.Optimizer(torch.nn.Linear(2, 2), optimizers.adam(0.1))
    monkeypatch.setattr(dp, "active", lambda: True)
    monkeypatch.setattr(dp, "grad_group", lambda: (None, 1))
    monkeypatch.setattr(dp.dist, "all_reduce", lambda t, **k: None)
    prof = torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])
    prof.start()
    opt.step([torch.ones(2, 2), torch.ones(2)])
    prof.stop()
    assert [(s.name, s.parent, s.call) for s in tracing.spans()] == [
        (P + "optimizer", None, None),
        (P + "dp.all_reduce", P + "optimizer", None)]


def test_counters_per_call(fresh, monkeypatch):
    assert tracing._counters["launches"] is K.LAUNCHES
    assert tracing._counters["grad_reductions"] is dp.GRAD_REDUCTIONS
    assert tracing._counters["collectives"] is tp.COLLECTIVES
    model, ts, stream = _program("iwgan")
    from hemx_torch.data import pipeline
    from hemx_torch.train import optimizers
    gather, step = pipeline.gather_u8_normalize, optimizers.Optimizer.step

    def counted_gather(*a, **k):  # the CPU runs the kernel's plain version
        K.LAUNCHES["gather_u8_normalize"] += 1
        return gather(*a, **k)

    def counted_step(self, grads):
        dp.GRAD_REDUCTIONS["collectives"] += 1
        dp.GRAD_REDUCTIONS["bytes"] += 8
        tp.COLLECTIVES["bytes"] += 2
        return step(self, grads)
    monkeypatch.setattr(pipeline, "gather_u8_normalize", counted_gather)
    monkeypatch.setattr(optimizers.Optimizer, "step", counted_step)
    before = {k: dict(c) for k, c in tracing._counters.items()}
    _profiled(model, ts, stream, 2)
    ts, _ = model.train(ts, stream)  # not recorded
    recorded = tracing.calls()
    assert [c["counters"] for c in recorded] == [
        {"launches": {"gather_u8_normalize": 1},
         "grad_reductions": {"collectives": 3, "bytes": 24},
         "collectives": {"collectives": 0, "bytes": 6}}] * 2
    for name, c in tracing._counters.items():  # counted always
        assert {k: v - before[name][k] for k, v in c.items()} == {
            k: 3 * v for k, v in recorded[0]["counters"][name].items()}


def test_reset_empties_the_record(fresh):
    model, ts, stream = _program("iwgan")
    _profiled(model, ts, stream, 1)
    assert tracing.spans() and tracing.calls()
    tracing.reset()
    assert tracing.spans() == [] and tracing.calls() == []
    _profiled(model, ts, stream, 1)
    assert [s.call for s in tracing.spans()] == [0] * 11
