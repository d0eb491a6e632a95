"""Global-batch semantics over a process group (counterpart of
``hemx.parallel.dp`` and of the shardings its ``jit_step`` gives a mesh).

hemx's jit with sharding computes every batch-level quantity over the
GLOBAL batch. A rank here sees only its rows, so each place where hemx
reduces over the batch, other than a plain per-sample mean, reduces over
the group.

hemx's grid is ``[data, spatial, model]`` with at most one of the last two
above 1 (:func:`set_axis`): rank ``r`` of a world of ``N`` with an axis of
size ``K`` has data index ``r // K`` and axis index ``r % K``. The ranks of
one data index (consecutive) form an *axis group*; the ranks of one axis
index form a *data group*. Under ``model`` (``hemx_torch.parallel.tp``)
the ranks of an axis group hold the same rows and the slices of every
kernel; under ``spatial`` (``hemx_torch.parallel.sp``) they hold the height
bands of the same rows and the whole model. So:

* :func:`global_sum` / :func:`global_mean` — differentiable
  (``torch.distributed.nn.functional.all_reduce``, whose backward
  all-reduces the incoming gradient) over the ranks that hold distinct
  rows or bands (:func:`batch_group`): the data group, or every rank while
  the tensors are spatial bands (``sp.banded``). BN statistics, the GP's
  whole-batch norm, ``rmse``, the sum-reduced VAE losses;
* :func:`all_reduce_grads` — the gradients averaged in place over the
  ranks that hold the same parameters (the data group under ``model``, so
  no rank averages two different slices of a kernel; every rank
  otherwise), in flat buckets (one collective per bucket);
* :func:`reduce_metrics` — the reported value of every metric, the mean
  over every rank (a per-sample mean of equal shards or bands is then the
  global mean; a value the ranks of an axis group share, or that is
  already global, stays), ``grad_finite`` flags ANDed over every rank, so
  a non-finite value in any slice of a kernel shows;
* :func:`slice_rows` — this rank's rows of a tensor drawn for the global
  batch (noise; the same on every rank of a data index), :func:`host_slice`
  the same for a host batch, with the spatial band of each image leaf
  when asked.

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
from typing import Optional

import torch
import torch.distributed as dist

from hemx_torch.utils import tracing

#: largest bucket of :func:`all_reduce_grads`, bytes
BUCKET_BYTES = 32 << 20

#: collectives and bytes :func:`all_reduce_grads` has run in this process
GRAD_REDUCTIONS = tracing.counter("grad_reductions", "collectives", "bytes")

_local = contextvars.ContextVar("hemx_torch_dp_local", default=False)

# hemx's second mesh axis: its name ("model" or "spatial"), its size, and
# this rank's axis group and data group (set_axis)
_axis: dict = {"kind": None, "size": 1, "axis": None, "data": None}


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


def set_axis(kind: Optional[str], size: int = 1) -> None:
    """Lay the group out as hemx's grid ``[data, kind]`` with ``kind``
    (``"model"`` or ``"spatial"``) of ``size`` (which divides the group;
    ``mesh.make_axes`` checks) the inner axis, and make its sub-groups;
    ``None`` (or size 1) for data parallelism alone. Every rank calls it,
    with the same arguments (``dist.new_group`` is collective)."""
    _axis.update(kind=None, size=1, axis=None, data=None)
    size = max(int(size), 1)
    if kind is None or size == 1 or not dist.is_initialized():
        return
    world, r = dist.get_world_size(), dist.get_rank()
    axis = [dist.new_group(list(range(d * size, (d + 1) * size)))
            for d in range(world // size)]
    data = [dist.new_group(list(range(a, world, size)))
            for a in range(size)]
    _axis.update(kind=kind, size=size, axis=axis[r // size],
                 data=data[r % size])


def axis_kind() -> Optional[str]:
    """``"model"``, ``"spatial"``, or None (no second axis, or inside
    :func:`local`)."""
    return _axis["kind"] if active() else None


def axis_size() -> int:
    return _axis["size"] if axis_kind() else 1


def model_axis_size() -> int:
    """hemx's ``model_axis_size``: ranks that share one data shard's kernels
    as slices."""
    return axis_size() if axis_kind() == "model" else 1


def spatial_axis_size() -> int:
    """hemx's ``spatial_axis_size``: ranks that share one data shard's
    images as height bands."""
    return axis_size() if axis_kind() == "spatial" else 1


def axis_index() -> int:
    """This rank's index on the second axis (its slice or its band)."""
    return rank() % axis_size()


def axis_group():
    """The ranks of this rank's data index (one per slice or band)."""
    return _axis["axis"]


def data_axis_size() -> int:
    """hemx's ``data_axis_size``: ranks that hold distinct rows."""
    return world_size() // axis_size()


def data_rank() -> int:
    return rank() // axis_size()


def data_group():
    """The ranks of this rank's axis index (the whole group without a
    second axis)."""
    return _axis["data"] if axis_kind() else dist.group.WORLD


def batch_group():
    """``(group, size)`` of the ranks holding distinct parts of the global
    batch: every rank while the tensors are spatial bands, else the data
    group."""
    from hemx_torch.parallel import sp
    if sp.banded():
        return dist.group.WORLD, world_size()
    return data_group(), data_axis_size()


def band_rows(h: int, bands: bool = True) -> Optional[tuple[int, int]]:
    """Rows ``[h0, h1)`` of this rank's spatial band of a leaf of height
    ``h``, or None when the leaf is not banded: hemx's ``batch_spec`` bands
    a leaf of rank >= 3 whose height the axis divides (the caller checks
    the rank)."""
    s = spatial_axis_size() if bands else 1
    if s == 1 or h < s or h % s:
        return None
    a = axis_index()
    return a * h // s, (a + 1) * h // s


def is_primary() -> bool:
    """Rank 0, or no group: the process that writes checkpoints, summaries,
    options and console lines."""
    return not dist.is_initialized() or dist.get_rank() == 0


def host_slice(batch, bands: bool = False):
    """This rank's rows ``[pi*per : (pi+1)*per]`` of a GLOBAL host batch
    (a dict of arrays, or one array), as hemx slices it over its ``data``
    axis (``pi`` the data index); with ``bands``, on a spatial axis, also
    this rank's band of each NHWC leaf hemx bands (:func:`band_rows`)."""
    pc = data_axis_size()
    pi = data_rank()

    def sl(x):
        if x.shape[0] % pc:
            raise ValueError(
                f"global batch {x.shape[0]} is not divisible by "
                f"{pc} processes — the remainder rows would silently "
                f"belong to no process")
        per = x.shape[0] // pc
        x = x[pi * per:(pi + 1) * per]
        rows = band_rows(x.shape[1], bands) if x.ndim >= 3 else None
        return x if rows is None else x[:, rows[0]:rows[1]]

    if isinstance(batch, dict):
        return {k: sl(v) for k, v in batch.items()}
    return sl(batch)


def slice_rows(t: torch.Tensor) -> torch.Tensor:
    """This rank's rows of a tensor drawn for the global batch."""
    return host_slice(t)


def global_sum(t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over the ranks of :func:`batch_group`, differentiably
    (the backward sums the incoming gradients of those ranks)."""
    if not active():
        return t
    group, size = batch_group()
    if size == 1:
        return t
    from torch.distributed.nn.functional import all_reduce
    return all_reduce(t, op=dist.ReduceOp.SUM, group=group)


def global_mean(t: torch.Tensor) -> torch.Tensor:
    """The mean of every element of ``t`` over the global batch (equal
    shards)."""
    if not active():
        return torch.mean(t)
    return global_sum(torch.sum(t)) / (t.numel() * batch_group()[1])


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


def grad_group():
    """``(group, size)`` of the ranks holding the same parameters: the data
    group under ``model`` (each axis index holds other slices), every rank
    otherwise."""
    if axis_kind() == "model":
        return data_group(), data_axis_size()
    return dist.group.WORLD, world_size()


def all_reduce_grads(grads) -> None:
    """Average ``grads`` over the ranks of :func:`grad_group` in place:
    each bucket is flattened into one buffer, all-reduced once and copied
    back."""
    if not active():
        return
    group, w = grad_group()
    with tracing.span("dp.all_reduce"):
        for bucket in _buckets([g for g in grads if g is not None]):
            flat = torch.cat([g.reshape(-1) for g in bucket])
            dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
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
