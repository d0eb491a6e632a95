"""Global-batch semantics over a process group (counterpart of
``hemx.parallel.dp``).

hemx's jit with sharding computes every batch-level quantity over the
GLOBAL batch. A rank here sees only its rows, so each place where hemx
reduces over the batch, other than a plain per-sample mean, reduces over
the group:

* :func:`global_sum` / :func:`global_mean` — differentiable
  (``torch.distributed.nn.functional.all_reduce``, whose backward
  all-reduces the incoming gradient): BN statistics, the GP's whole-batch
  norm, ``rmse``, the sum-reduced VAE losses;
* :func:`all_reduce_grads` — the gradients averaged over ranks in place,
  in flat buckets (one collective per bucket);
* :func:`reduce_metrics` — the reported value of every metric, the mean
  over ranks (a per-sample mean of equal shards is then the global mean; a
  value that is already global stays), ``grad_finite`` flags ANDed;
* :func:`slice_rows` — this rank's rows of a tensor drawn for the global
  batch (noise), :func:`host_slice` the same for a host batch.

Together they make one rank's loss a term whose mean over ranks is hemx's
loss, and the averaged gradient hemx's gradient. Every collective is an
``all_reduce`` or a ``broadcast``: gloo runs both on CUDA tensors.

Without a group every helper is the identity and the plain code runs.
Inside :func:`local` the helpers act as if there were no group: rank 0
uses it to compute summaries of the whole global summary batch alone.
"""

from __future__ import annotations

import contextlib
import contextvars

import torch
import torch.distributed as dist

#: largest bucket of :func:`all_reduce_grads`, bytes
BUCKET_BYTES = 32 << 20

#: collectives and bytes :func:`all_reduce_grads` has run in this process
GRAD_REDUCTIONS = {"collectives": 0, "bytes": 0}

_local = contextvars.ContextVar("hemx_torch_dp_local", default=False)


def active() -> bool:
    """A group exists and :func:`local` is not in force."""
    return dist.is_initialized() and not _local.get()


@contextlib.contextmanager
def local():
    """Within the block, this process computes as if it were alone."""
    token = _local.set(True)
    try:
        yield
    finally:
        _local.reset(token)


def world_size() -> int:
    return dist.get_world_size() if active() else 1


def rank() -> int:
    return dist.get_rank() if active() else 0


def is_primary() -> bool:
    """Rank 0, or no group: the process that writes checkpoints, summaries,
    options and console lines."""
    return not dist.is_initialized() or dist.get_rank() == 0


def host_slice(batch):
    """This rank's rows ``[pi*per : (pi+1)*per]`` of a GLOBAL host batch
    (a dict of arrays, or one array), as hemx slices it."""
    pc = world_size()
    if pc == 1:
        return batch
    pi = rank()

    def sl(x):
        if x.shape[0] % pc:
            raise ValueError(
                f"global batch {x.shape[0]} is not divisible by "
                f"{pc} processes — the remainder rows would silently "
                f"belong to no process")
        per = x.shape[0] // pc
        return x[pi * per:(pi + 1) * per]

    if isinstance(batch, dict):
        return {k: sl(v) for k, v in batch.items()}
    return sl(batch)


def slice_rows(t: torch.Tensor) -> torch.Tensor:
    """This rank's rows of a tensor drawn for the global batch."""
    return host_slice(t)


def global_sum(t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over ranks, differentiably (the backward sums the
    incoming gradients of every rank)."""
    if not active():
        return t
    from torch.distributed.nn.functional import all_reduce
    return all_reduce(t, op=dist.ReduceOp.SUM)


def global_mean(t: torch.Tensor) -> torch.Tensor:
    """The mean of every element of ``t`` over the global batch (equal
    shards)."""
    if not active():
        return torch.mean(t)
    return global_sum(torch.sum(t)) / (t.numel() * world_size())


def mean_over_ranks(t: torch.Tensor) -> torch.Tensor:
    """A rank's value averaged over ranks, differentiably."""
    return global_sum(t) / world_size() if active() else t


def _buckets(tensors):
    """Consecutive runs of same-dtype tensors of at most BUCKET_BYTES (one
    tensor may exceed it alone)."""
    run, size = [], 0
    for t in tensors:
        nbytes = t.numel() * t.element_size()
        if run and (t.dtype != run[0].dtype or size + nbytes > BUCKET_BYTES):
            yield run
            run, size = [], 0
        run.append(t)
        size += nbytes
    if run:
        yield run


def all_reduce_grads(grads) -> None:
    """Average ``grads`` over ranks in place: each bucket is flattened
    into one buffer, all-reduced once and copied back."""
    if not active():
        return
    w = world_size()
    for bucket in _buckets([g for g in grads if g is not None]):
        flat = torch.cat([g.reshape(-1) for g in bucket])
        dist.all_reduce(flat, op=dist.ReduceOp.SUM)
        GRAD_REDUCTIONS["collectives"] += 1
        GRAD_REDUCTIONS["bytes"] += flat.numel() * flat.element_size()
        flat.div_(w)
        offset = 0
        for g in bucket:
            n = g.numel()
            g.copy_(flat[offset:offset + n].view_as(g))
            offset += n


def reduce_metrics(metrics: dict) -> dict:
    """Metrics (0-d tensors, ``grad_finite`` a dict of 0-d bools) as their
    mean over ranks, the flags ANDed, in one collective."""
    if not active() or not metrics:
        return metrics
    flags = metrics.get("grad_finite", {})
    keys = [k for k in metrics if k != "grad_finite"]
    vals = [metrics[k].detach().float().reshape(()) for k in keys]
    vals += [(~f).float().reshape(()) for f in flags.values()]
    if not vals:
        return metrics
    buf = torch.stack(vals)
    dist.all_reduce(buf, op=dist.ReduceOp.SUM)
    out = {k: buf[i] / world_size() for i, k in enumerate(keys)}
    if flags:
        out["grad_finite"] = {n: buf[len(keys) + i] == 0
                              for i, n in enumerate(flags)}
    return out


def barrier(device) -> None:
    """Wait for every rank (an all-reduce of one element)."""
    if active():
        dist.all_reduce(torch.zeros(1, device=device))


def broadcast_bytes(data: bytes, device) -> bytes:
    """Rank 0's ``data`` on every rank (two broadcasts: length, bytes)."""
    if not active():
        return data
    n = torch.tensor([len(data)], dtype=torch.int64, device=device)
    dist.broadcast(n, 0)
    buf = torch.zeros(int(n.item()), dtype=torch.uint8, device=device)
    if dist.get_rank() == 0:
        buf.copy_(torch.frombuffer(bytearray(data), dtype=torch.uint8))
    dist.broadcast(buf, 0)
    return bytes(buf.cpu().numpy().tobytes())
