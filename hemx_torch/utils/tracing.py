"""Spans and counters of the train call.

Tracing is on exactly while a ``torch.profiler`` records (the CLI's
``--profile``, or any caller's profiler): there is no flag and no
environment variable. Each span checks the profiler's own switch
(``torch.autograd.profiler._is_profiler_enabled``) and, when it is off,
does nothing else: no range, no CUDA event, no record.

While it is on, a span named ``hemx_torch.<layer>.<what>``

* marks the profiler's timeline with a host range of FUNCTION scope
  (``torch._C._profiler._RecordFunctionFast``), on the clock of the
  device's events; unlike ``torch.profiler.record_function`` it puts no
  copy of itself on the device's timeline;
* is recorded here: its name, the span it opened inside, the train call it
  belongs to, its host start and end (``time.perf_counter_ns``) and, in a
  call on a CUDA device, two timing events recorded on the current stream
  at its start and end. Their elapsed time is read only when
  :func:`calls` asks, after the work has been synchronized; a span never
  synchronizes.

The spans (each train call's are inside its ``hemx_torch.call``):

* ``call``: a model's ``train`` (:func:`call`, applied once for every model
  by ``hemx_torch.models.plugin.ModelPlugin``); opens the call's record;
* ``input.assemble``, ``input.order``, ``input.wait``: the device-resident
  feeder's gather of a group, its index order at an epoch start, and the
  streaming feeder's wait on its worker (``hemx_torch.data.pipeline``);
* ``step.critic``, ``step.generator``: one substep of the GANs and the
  conditional GANs (``hemx_torch.models.gan``,
  ``hemx_torch.models.conditional``);
* ``backward``: each ``torch.autograd.grad`` of those substeps;
* ``optimizer``: ``hemx_torch.train.optimizers.Optimizer.step``;
* ``dp.all_reduce``: the gradient all-reduce in a process group
  (``hemx_torch.parallel.dp.all_reduce_grads``).

Counters (:func:`counter`) are dicts that their modules add to always,
whether or not a profiler records; a call's record holds each counter's
change over the call.

Spans are entered from the thread that makes the train call; the
feeder's worker thread enters none.
"""

from __future__ import annotations

import contextlib
import functools
import time

import torch
from torch.autograd import profiler as _profiler

PREFIX = "hemx_torch."
CALL = PREFIX + "call"

_RANGE = torch._C._profiler._RecordFunctionFast

_counters: dict = {}   # name -> the counter's dict
_spans: list = []      # every recorded span, in the order they opened
_calls: list = []      # per call: {"counters": {name: {key: change}}}
_open: list = []       # the spans open now, innermost last
_call = None           # the open call's Span, or None


def counter(name: str, *keys: str) -> dict:
    """A new counter ``{key: 0}`` registered as ``name``; its module keeps
    the dict and adds to it."""
    c = _counters[name] = dict.fromkeys(keys, 0)
    return c


class Span:
    """One span (a context manager): ``name``, ``parent`` (the name of the
    span it opened inside, or None), ``call`` (the index of its train call
    in :func:`calls`, or None outside a call), ``start_ns``, ``end_ns`` and
    ``events`` (the start and end CUDA events, or None)."""

    __slots__ = ("name", "parent", "call", "start_ns", "end_ns", "events",
                 "_range", "_device", "_before")

    def __init__(self, name: str, device: torch.device | None = None):
        self.name = name
        self._device = device  # a call's CUDA device

    def _event(self):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record(torch.cuda.current_stream(_call._device))
        return ev

    def __enter__(self):
        global _call
        self._range = _RANGE(self.name)
        self._range.__enter__()
        self.parent = _open[-1].name if _open else None
        if self.name == CALL:
            _call = self
            self.call = len(_calls)
            self._before = {k: dict(c) for k, c in _counters.items()}
            _calls.append({"counters": {}})
        else:
            self.call = None if _call is None else _call.call
        cuda = _call is not None and _call._device is not None
        self.events = (self._event(), None) if cuda else None
        _spans.append(self)
        _open.append(self)
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        global _call
        self.end_ns = time.perf_counter_ns()
        if self.events is not None:
            self.events = (self.events[0], self._event())
        _open.pop()
        if _call is self:
            _calls[self.call]["counters"] = {
                k: {key: v - self._before[k][key] for key, v in c.items()}
                for k, c in _counters.items()}
            _call = None
        self._range.__exit__(None, None, None)
        return False


_OFF = contextlib.nullcontext()  # what :func:`span` hands out while off


def span(what: str):
    """A span ``hemx_torch.<what>`` for a ``with`` block."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return Span(PREFIX + what)


def spanned(what: str):
    """Decorator: each call of the function inside a span
    ``hemx_torch.<what>``."""
    name = PREFIX + what

    def wrap(fn):
        @functools.wraps(fn)
        def traced(*args, **kwargs):
            if not _profiler._is_profiler_enabled:
                return fn(*args, **kwargs)
            with Span(name):
                return fn(*args, **kwargs)
        return traced
    return wrap


def call(train):
    """Decorator of a model's ``train(self, ...)``: each call inside a
    ``hemx_torch.call`` span that opens the call's record (with CUDA
    events on ``self.device`` when it is a CUDA device)."""
    @functools.wraps(train)
    def traced(model, *args, **kwargs):
        if not _profiler._is_profiler_enabled:
            return train(model, *args, **kwargs)
        cuda = model.device.type == "cuda"
        with Span(CALL, model.device if cuda else None):
            return train(model, *args, **kwargs)
    return traced


def spans() -> list:
    """Every recorded :class:`Span`, in the order they opened."""
    return list(_spans)


def calls() -> list:
    """Per recorded train call, in the order they ran: ``{"spans": {name:
    (host_s, device_s)}, "counters": {counter: {key: change}}}``, each
    span name's times summed over the call's spans of that name;
    ``device_s`` is None where a span has no CUDA events. Waits for the
    spans' end events."""
    out = [{"spans": {}, "counters": c["counters"]} for c in _calls]
    for s in _spans:
        if s.call is None:
            continue
        host = (s.end_ns - s.start_ns) / 1e9
        dev = None
        if s.events is not None:
            s.events[1].synchronize()
            dev = s.events[0].elapsed_time(s.events[1]) / 1e3
        into = out[s.call]["spans"]
        if s.name in into:
            h, d = into[s.name]
            into[s.name] = (h + host, None if dev is None else d + dev)
        else:
            into[s.name] = (host, dev)
    return out


def reset() -> None:
    """Forget every recorded span and call (outside a train call)."""
    global _call
    _spans.clear()
    _calls.clear()
    _open.clear()
    _call = None
