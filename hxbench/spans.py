"""Reading the program's own spans for the per-layer metrics whose source
is ``program_span``: ``hemx_torch.utils.tracing.calls()``, the first
``traced_calls`` of them. The program records spans only while a
profiler records, so those are the window's calls traced on the device
alone (the compared and warm-up calls run without a profiler; the two
host-traced calls come after them).

A span's device time is the interval between the CUDA events recorded on
the stream at its start and its end, so it holds whatever stalls the
device inside the span; its host time is the host clock's. Nothing
(None) where the program has no such module, recorded no call, or no span
of the names asked for."""

from __future__ import annotations


def ms_per_call(rec: dict, want: str, device: bool):
    """Summed time per call, in ms, of the spans named ``want`` (every
    span under it where it ends in a dot): their device time with
    ``device`` (None off a GPU), else their host time."""
    if device and rec["platform"] != "gpu":
        return None
    try:
        from hemx_torch.utils import tracing
    except ImportError:
        return None
    calls = tracing.calls()[:rec["traced_calls"]]
    total, found = 0.0, False
    for c in calls:
        for name, (host_s, device_s) in c["spans"].items():
            if name == want or (want.endswith(".") and name.startswith(want)):
                value = device_s if device else host_s
                if value is None:
                    return None
                total += value
                found = True
    return 1e3 * total / len(calls) if found else None
