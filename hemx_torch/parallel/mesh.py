"""The process group behind ``--n_devices``, ``--model_parallel`` and
``--spatial_parallel`` (counterpart of ``hemx.parallel.mesh``).

hemx lays its devices out as a mesh and lets XLA place the collectives.
Here each device is one process. Without a second axis, rank ``r`` of a
world of ``W`` holds rows ``[r*B : (r+1)*B]`` of every global batch of
``W*B`` rows (``--batch_size`` is per device, as in hemx). With
``--model_parallel M`` or ``--spatial_parallel S`` (at most one; ``K`` its
size) the world is hemx's grid ``[data, K]``: rank ``r`` holds rows of
data index ``r // K`` and slice or band ``r % K``, and the global batch is
``batch_size * W / K`` (hemx's ``batch_size * data_axis_size``).
``hemx_torch.parallel.dp`` keeps the sub-groups and the global-batch
collectives, ``tp`` and ``sp`` the two axes' layers. The group is NCCL on
CUDA and gloo on the CPU (gloo on CUDA tensors too, when several ranks
share one card).

* :func:`check_axes` and :func:`worker_count` refuse what hemx's
  ``make_mesh`` refuses, in its words; :func:`make_axes` makes the grid's
  sub-groups once the group exists;
* :func:`initialize_distributed` joins a group: a ``tcp://`` address, or
  ``env://`` under ``torchrun``;
* :func:`spawn` starts ``n`` local workers, one per device, each in the
  group, and fails when any of them fails (a group timeout keeps a rank
  from waiting forever on one that hangs).
"""

from __future__ import annotations

import datetime
import os
import socket
import sys
from typing import Callable, Optional

import torch
import torch.distributed as dist

from hemx_torch.parallel import dp

#: seconds a rank waits in a collective before the group gives up on it
TIMEOUT_S = 1800

# the device of this process's rank, set when it joins a group
_device: Optional[torch.device] = None


def check_axes(model: int = 1, spatial: int = 1,
               n_devices: Optional[int] = None) -> None:
    """Refuse what hemx's ``make_mesh`` refuses, in its words: both axes
    at once, and an axis that does not divide the ``n_devices`` the run
    has."""
    model, spatial = max(int(model), 1), max(int(spatial), 1)
    if model > 1 and spatial > 1:
        raise ValueError(
            "--spatial_parallel and --model_parallel cannot be combined: "
            "XLA's SPMD partitioner produces wrong conv weight gradients "
            "when channel- and height-sharding compose in one backward "
            "pass (see make_mesh docstring). Use one axis with data "
            "parallelism instead.")
    if n_devices is not None and model * spatial > 1 \
            and n_devices % (model * spatial):
        asked = " x ".join(f"--{n} {v}" for n, v in
                           (("spatial_parallel", spatial),
                            ("model_parallel", model)) if v > 1)
        raise ValueError(f"{asked} does not divide {n_devices} device(s)")


def make_axes(model: int = 1, spatial: int = 1) -> None:
    """hemx's grid over the group this process joined
    (``dp.set_axis``); data parallelism alone when both are 1."""
    check_axes(model, spatial, dist.get_world_size())
    if model > 1:
        dp.set_axis("model", model)
    elif spatial > 1:
        dp.set_axis("spatial", spatial)
    else:
        dp.set_axis(None)


def local_device_count(device: str) -> int:
    """Devices ``--n_devices 0`` means: every GPU of the host for a bare
    ``cuda``, one for the CPU or a device with an index."""
    d = torch.device(device)
    if d.type == "cuda" and d.index is None:
        return torch.cuda.device_count()
    return 1


def worker_count(n_devices: int, device: str) -> int:
    """Processes of a run: ``n_devices`` (0 = :func:`local_device_count`).
    On the CPU any count runs (gloo processes); on CUDA at most the host's
    GPUs (``hemx.parallel.mesh.make_mesh``'s refusal)."""
    n = int(n_devices or 0)
    if n <= 0:
        return max(local_device_count(device), 1)
    available = torch.cuda.device_count()
    if torch.device(device).type == "cuda" and n > available:
        raise ValueError(
            f"requested {n} devices but only {available} available")
    return n


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def under_launcher() -> bool:
    """True in a process that ``torchrun`` started (``RANK`` and
    ``WORLD_SIZE`` in its environment)."""
    return "RANK" in os.environ and "WORLD_SIZE" in os.environ


def initialize_distributed(coordinator: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None, *,
                           device: str = "cuda",
                           backend: Optional[str] = None) -> torch.device:
    """Join the group (``hemx.parallel.mesh.initialize_distributed``):
    ``coordinator`` ``host:port`` with ``num_processes`` and
    ``process_id``, or ``env://`` (``torchrun``'s variables) when they are
    None. NCCL for a CUDA ``device``, gloo otherwise, unless ``backend``
    says. A bare ``cuda`` becomes ``cuda:<local rank>``. Returns this
    rank's device."""
    global _device
    d = torch.device(device)
    if d.type == "cuda" and d.index is None:
        local = (process_id if coordinator is not None
                 else int(os.environ.get("LOCAL_RANK", 0)))
        d = torch.device("cuda", local)
    if d.type == "cuda":
        torch.cuda.set_device(d)
    backend = backend or ("nccl" if d.type == "cuda" else "gloo")
    timeout = datetime.timedelta(seconds=TIMEOUT_S)
    if coordinator is None:
        dist.init_process_group(backend, init_method="env://",
                                timeout=timeout)
    else:
        dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                                world_size=num_processes, rank=process_id,
                                timeout=timeout)
    _device = d
    return d


def shutdown() -> None:
    global _device
    dp.set_axis(None)
    if dist.is_initialized():
        dist.destroy_process_group()
    _device = None


def rank_device(default: str) -> torch.device:
    """This rank's device in a group, else ``default``."""
    return _device if dist.is_initialized() and _device is not None \
        else torch.device(default)


def _worker(index: int, fn: Callable, nprocs: int, port: int, device: str,
            backend: Optional[str], fn_args: tuple) -> None:
    # the host's cores shared out, not each rank's threads on all of them
    torch.set_num_threads(max(torch.get_num_threads() // nprocs, 1))
    dev = initialize_distributed(f"localhost:{port}", nprocs, index,
                                 device=device, backend=backend)
    try:
        fn(*fn_args)
        # leave together: a rank that tears its connections down while
        # another still holds them can abort that one
        dp.barrier(dev)
    finally:
        shutdown()
    # skip the interpreter's teardown, whose destructors of the store's
    # and gloo's threads have aborted a finished worker (SIGABRT,
    # "terminate called without an active exception")
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(0)


def spawn(fn: Callable, nprocs: int, *, device: str,
          backend: Optional[str] = None, args: tuple = ()) -> None:
    """Run ``fn(*args)`` in ``nprocs`` new processes (spawned, so ``fn``
    and ``args`` are pickled by import path), rank ``i`` on ``cuda:i`` for
    a bare ``cuda``, on ``device`` itself otherwise (several gloo ranks may
    share ``cuda:0``). Returns when all have ended; a rank that fails ends
    the others, and the failure is raised here
    (``torch.multiprocessing.ProcessRaisedException`` or
    ``ProcessExitedException``)."""
    import torch.multiprocessing as mp
    mp.spawn(_worker, args=(fn, nprocs, free_port(), device, backend, args),
             nprocs=nprocs, join=True)
