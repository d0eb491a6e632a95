"""tfevents reader (copy of ``hemx.summaries.reader``): scalar series,
histograms and images, each deduped by step (the latest wall time wins: a
resumed run re-emits the steps after its checkpoint), the tag index of a
logdir in one pass, and the percentile fan of a histogram tag. matplotlib
is imported only by :func:`render_histogram_plot`."""

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
    return _dedup_by_step(
        (events if events is not None else get_all_events(logdir)).get(tag, []))


def get_scalar_tags(logdir: str, events: dict | None = None) -> list[str]:
    return sorted((events if events is not None
                   else get_all_events(logdir)).keys())


def decode_histo(buf: bytes) -> dict:
    """Decode a HistogramProto; its bucket fields come packed (one
    length-delimited run of doubles) or unpacked (one double each)."""
    out = {"min": 0.0, "max": 0.0, "num": 0.0, "sum": 0.0,
           "sum_squares": 0.0, "bucket_limit": [], "bucket": []}
    names = {1: "min", 2: "max", 3: "num", 4: "sum", 5: "sum_squares"}
    for field, wt, v in proto.iter_fields(buf):
        if field in names:
            out[names[field]] = v
        elif field in (6, 7):
            key = "bucket_limit" if field == 6 else "bucket"
            if wt == 2:  # packed doubles
                out[key] = list(struct.unpack(f"<{len(v)//8}d", v))
            else:
                out[key].append(v)
    return out


def _dedup_by_step(rows) -> list[tuple[int, object]]:
    """(wall_time, step, payload) rows deduped by step, the latest wall
    time winning, in step order: a resumed run re-emits already-logged
    steps into a new events file."""
    by_step: dict[int, tuple[float, object]] = {}
    for wall, step, payload in rows:
        if step not in by_step or wall >= by_step[step][0]:
            by_step[step] = (wall, payload)
    return [(s, p) for s, (w, p) in sorted(by_step.items())]


def get_histogram_values(logdir: str, tag: str) -> list[tuple[int, dict]]:
    """[(step, decoded HistogramProto)] for a tag under logdir, deduped by
    step (latest wall-time wins, like the scalar path)."""
    rows = []
    for path in event_files(logdir):
        for ev in iter_events(path):
            for v in ev["values"]:
                if v.get("tag") == tag and "histo" in v:
                    rows.append((ev["wall_time"], ev["step"],
                                 decode_histo(v["histo"])))
    return _dedup_by_step(rows)


def decode_image(buf: bytes) -> bytes:
    """Encoded PNG bytes from a Summary.Value Image submessage (field 4,
    ``encoded_image_string``)."""
    for f, wt, v in proto.iter_fields(buf):
        if f == 4:
            return v
    return b""


def get_image_values(logdir: str, tag: str) -> list[tuple[int, bytes]]:
    """[(step, png_bytes)] for an image tag under logdir, deduped by step
    (latest wall-time wins, like the scalar path)."""
    rows = []
    for path in event_files(logdir):
        for ev in iter_events(path):
            for v in ev["values"]:
                if v.get("tag") == tag and "image" in v:
                    rows.append((ev["wall_time"], ev["step"],
                                 decode_image(v["image"])))
    return _dedup_by_step(rows)


def get_image_tags(logdir: str) -> list[str]:
    tags = set()
    for path in event_files(logdir):
        for ev in iter_events(path):
            for v in ev["values"]:
                if "image" in v and "tag" in v:
                    tags.add(v["tag"])
    return sorted(tags)


def get_histogram_tags(logdir: str) -> list[str]:
    tags = set()
    for path in event_files(logdir):
        for ev in iter_events(path):
            for v in ev["values"]:
                if "histo" in v and "tag" in v:
                    tags.add(v["tag"])
    return sorted(tags)


def get_tag_index(logdir: str) -> dict[str, list[str]]:
    """{'scalars': [...], 'histograms': [...], 'images': [...]} from ONE
    pass over the logdir's event files (get_scalar_tags +
    get_histogram_tags + get_image_tags each re-parse everything; page
    renderers should use this instead)."""
    kinds = {"simple_value": set(), "histo": set(), "image": set()}
    for path in event_files(logdir):
        for ev in iter_events(path):
            for v in ev["values"]:
                if "tag" not in v:
                    continue
                for key, bucket in kinds.items():
                    if key in v:
                        bucket.add(v["tag"])
    return {"scalars": sorted(kinds["simple_value"]),
            "histograms": sorted(kinds["histo"]),
            "images": sorted(kinds["image"])}


def _histo_percentiles(h: dict, qs) -> list[float]:
    """Approximate percentiles of one HistogramProto by linear interpolation
    across its (exponential) buckets."""
    counts = list(h.get("bucket", []))
    limits = list(h.get("bucket_limit", []))
    total = sum(counts)
    if total <= 0 or not limits:
        return [h.get("min", 0.0)] * len(qs)
    lowers = [h["min"]] + limits[:-1]
    uppers = [min(l, h["max"]) for l in limits]
    out = []
    for q in qs:
        target = total * q / 100.0
        cum = 0.0
        val = h["max"]
        for lo, hi, c in zip(lowers, uppers, counts):
            if cum + c >= target:
                frac = 0.0 if c == 0 else (target - cum) / c
                val = lo + frac * (hi - lo)
                break
            cum += c
        out.append(max(h["min"], min(val, h["max"])))
    return out


def get_histogram_plot_data(logdir: str, tag: str,
                            qs=(0, 7, 25, 50, 75, 93, 100)):
    """(steps, {q: [values...]}): the TensorBoard-style percentile fan of
    a histogram tag."""
    rows = get_histogram_values(logdir, tag)
    steps = [s for s, _ in rows]
    series = {q: [] for q in qs}
    for _, h in rows:
        vals = _histo_percentiles(h, qs)
        for q, v in zip(qs, vals):
            series[q].append(v)
    return steps, series


def render_histogram_plot(logdir: str, tag: str, out_path: str) -> str:
    """Render one histogram tag's evolution as a shaded percentile-fan PNG
    (matplotlib, imported here)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    steps, series = get_histogram_plot_data(logdir, tag)
    if not steps:
        raise ValueError(f"no histogram events for tag {tag!r} in {logdir}")
    fig, ax = plt.subplots(figsize=(8, 4.5))
    bands = [(0, 100, 0.12), (7, 93, 0.22), (25, 75, 0.35)]
    for lo, hi, alpha in bands:
        ax.fill_between(steps, series[lo], series[hi], alpha=alpha,
                        color="C0", linewidth=0)
    ax.plot(steps, series[50], color="C0", linewidth=1.5, label="median")
    ax.set_xlabel("step")
    ax.set_title(tag)
    ax.grid(alpha=0.3)
    fig.savefig(out_path, bbox_inches="tight", dpi=110)
    plt.close(fig)
    return out_path
