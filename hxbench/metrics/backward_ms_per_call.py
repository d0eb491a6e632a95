"""Device time per call of the program's backward passes (its
``hemx_torch.backward`` spans, each ``torch.autograd.grad`` of a
substep; the IWGAN's includes the gradient penalty's double backward), in
rank 0's traced calls. ms."""

from hxbench import spans


def read(rec):
    return spans.ms_per_call(rec, "hemx_torch.backward", device=True)
