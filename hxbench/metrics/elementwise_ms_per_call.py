"""Device time per call of the kernels that are no cuDNN or cuBLAS
convolution or product, no input kernel and no NCCL (``elementwise`` in
``hxbench.trace.classify``), in rank 0's traced calls. ms."""

from hxbench import trace


def read(rec):
    t = rec["trace"]
    if not t["device"]:
        return None
    return trace.kernel_time(t, "elementwise") / 1e3 / rec["traced_calls"]
