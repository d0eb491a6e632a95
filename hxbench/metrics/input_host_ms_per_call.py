"""Host time per call of the program's input spans (``hemx_torch.input.*``:
the feeder's gather launches, index order and wait on its worker), in
rank 0's traced calls. ms."""

from hxbench import spans


def read(rec):
    return spans.ms_per_call(rec, "hemx_torch.input.", device=False)
