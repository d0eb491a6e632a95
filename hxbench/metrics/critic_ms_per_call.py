"""Device time per call of the program's critic substeps (its
``hemx_torch.step.critic`` spans), in rank 0's traced calls. ms."""

from hxbench import spans


def read(rec):
    return spans.ms_per_call(rec, "hemx_torch.step.critic", device=True)
