"""Terminal helpers (copy of ``hemx.utils.terminal``'s ``message``,
``MovingAverage`` and ``delta_postfix``)."""

from __future__ import annotations

import sys

from hemx_torch.parallel import dp


def message(text: str, stream=None) -> None:
    """Print ``text``, bold green on a terminal; in a process group only
    rank 0 prints."""
    if not dp.is_primary():
        return
    stream = stream or sys.stdout
    if stream.isatty():
        text = f"\033[1m\033[32m{text}\033[0m"
    print(text, file=stream, flush=True)


class MovingAverage:
    """Running mean of a dict of scalars, each key over its own
    observations (reference: hem/util/misc.py:62-69)."""

    def __init__(self):
        self.totals: dict = {}
        self.counts: dict = {}

    def update(self, values: dict) -> dict:
        for k, v in values.items():
            self.totals[k] = self.totals.get(k, 0.0) + float(v)
            self.counts[k] = self.counts.get(k, 0) + 1
        return {k: t / self.counts[k] for k, t in self.totals.items()}


def delta_postfix(values: dict, prev: dict) -> dict:
    """Loss values with a +/-/~ marker for rose/fell/flat against the last
    display (reference: util.py:196-212; the first display has none)."""
    out = {}
    for k, v in values.items():
        if k not in prev:
            out[k] = f"{v:.4g}"
            continue
        diff = float(v) - float(prev[k])
        sym = "+" if diff > 0 else "-" if diff < 0 else "~"
        out[k] = f"{v:.4g}({sym})"
    return out
