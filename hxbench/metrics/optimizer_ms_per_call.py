"""Device time per call of the program's optimizer steps (its
``hemx_torch.optimizer`` spans: gradient all-reduce, transform, in-place
adds), in rank 0's traced calls. ms."""

from hxbench import spans


def read(rec):
    return spans.ms_per_call(rec, "hemx_torch.optimizer", device=True)
