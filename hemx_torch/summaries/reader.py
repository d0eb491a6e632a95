"""tfevents reader (copy of the scalar path of ``hemx.summaries.reader``):
scalar series with the reference's dedup by step (latest wall time wins)."""

from __future__ import annotations

import glob
import os
import struct
from typing import Iterator

from hemx_torch.summaries import proto


def _iter_records(path: str) -> Iterator[bytes]:
    with open(path, "rb") as f:
        while True:
            header = f.read(8)
            if len(header) < 8:
                return
            (length,) = struct.unpack("<Q", header)
            f.read(4)  # length crc (unchecked on read, like TF's default)
            record = f.read(length)
            if len(record) < length:
                return
            f.read(4)  # data crc
            yield record


def iter_events(path: str) -> Iterator[dict]:
    """Yield {'wall_time', 'step', 'values': [{tag, value kind...}]} per
    event."""
    for rec in _iter_records(path):
        ev = {"wall_time": 0.0, "step": 0, "values": []}
        for field, wt, v in proto.iter_fields(rec):
            if field == 1:
                ev["wall_time"] = v
            elif field == 2:
                ev["step"] = v
            elif field == 5:
                ev["values"] = _parse_summary(v)
        yield ev


def _parse_summary(buf: bytes) -> list[dict]:
    values = []
    for field, wt, v in proto.iter_fields(buf):
        if field != 1:
            continue
        item: dict = {}
        for f2, wt2, v2 in proto.iter_fields(v):
            if f2 == 1:
                item["tag"] = v2.decode("utf-8")
            elif f2 == 2:
                item["simple_value"] = v2
            elif f2 == 4:
                item["image"] = v2
            elif f2 == 5:
                item["histo"] = v2
        values.append(item)
    return values


def event_files(logdir: str) -> list[str]:
    return sorted(glob.glob(os.path.join(logdir, "**", "events.out.tfevents.*"),
                            recursive=True))


def get_all_events(logdir: str) -> dict[str, list[tuple[float, int, float]]]:
    """{tag: [(wall_time, step, value), ...]} for all scalar tags under
    logdir."""
    out: dict[str, list] = {}
    for path in event_files(logdir):
        for ev in iter_events(path):
            for v in ev["values"]:
                if "simple_value" in v:
                    out.setdefault(v["tag"], []).append(
                        (ev["wall_time"], ev["step"], v["simple_value"]))
    for tag in out:
        out[tag].sort(key=lambda t: (t[1], t[0]))
    return out


def get_tag_values(logdir: str, tag: str,
                   events: dict | None = None) -> list[tuple[int, float]]:
    """Scalar series for one tag, deduped by step favoring the latest wall
    time. Pass ``events`` (one get_all_events result) to serve many tags
    from one parse of the logdir's event files."""
    rows = (events if events is not None else get_all_events(logdir)).get(tag, [])
    by_step: dict[int, tuple[float, float]] = {}
    for wall, step, value in rows:
        if step not in by_step or wall >= by_step[step][0]:
            by_step[step] = (wall, value)
    return [(s, v) for s, (w, v) in sorted(by_step.items())]
