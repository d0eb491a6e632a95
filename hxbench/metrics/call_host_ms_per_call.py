"""Host time per call of the program's train call (its ``hemx_torch.call``
span: the host's enqueue of the call, before the synchronize), in rank
0's traced calls. ms."""

from hxbench import spans


def read(rec):
    return spans.ms_per_call(rec, "hemx_torch.call", device=False)
