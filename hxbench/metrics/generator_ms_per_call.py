"""Device time per call of the program's generator substeps (its
``hemx_torch.step.generator`` spans), in rank 0's traced calls. ms."""

from hxbench import spans


def read(rec):
    return spans.ms_per_call(rec, "hemx_torch.step.generator", device=True)
