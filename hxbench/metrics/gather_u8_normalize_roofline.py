"""The input kernel's share of its bandwidth bound in rank 0's traced
calls: the bytes its gathers need, over its device time, over the HBM
bandwidth (``hxbench/peaks.json``). A gather of R rows of an H x W x C
uint8 input reads R*H*W*C bytes and R 4-byte indices and writes R*H*W*C
float32 values, once each, whatever implements it; one launch per input
and call (the traffic caches whole calls of rows). None without a launch
in the trace. %."""

import math

from hxbench import trace


def read(rec):
    t = rec["trace"]
    launches = sum(1 for n, _, _ in t["device"]
                   if trace.classify(n) == "input")
    if not launches:
        return None
    inputs = rec["config"]["inputs"]
    rows = int(rec["traffic"]["batch_size"]) * rec["per_call"]
    per_group = sum(rows * (5 * math.prod(s) + 4) for s in inputs.values())
    seconds = trace.kernel_time(t, "input") / 1e6
    bound = rec["peaks"]["hbm_tb_per_s"] * 1e12
    return 100.0 * per_group * launches / len(inputs) / seconds / bound
