"""Kernel launches per call in rank 0's traced calls (copies and sets the
runtime issues are not kernels). launches."""

from hxbench import trace


def read(rec):
    if not rec["trace"]["device"]:
        return None
    n = sum(1 for name, _, _ in rec["trace"]["device"]
            if trace.classify(name) != "memory")
    return n / rec["traced_calls"]
