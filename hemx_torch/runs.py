"""Loading a finished run for the post-training tools (counterpart of the
run loading in hemx's ``paper_metrics.py:92-106``, ``paper_fullimage.py``
and ``visualize.py:42-55``).

A tool rebuilds the model from the run's ``options.json`` (one written by
hemx or by the port), restores a checkpoint into it and works at hemx's
global batch: ``batch_size * (n_devices or 1)``. hemx's tools build
``make_mesh(n_devices or 1)``, so ``n_devices 0`` is one device here (not
every device, as the trainer reads it), and a host with fewer devices
than the run asks for is refused in hemx's words. On the CPU any count
runs in one process and equals hemx on an N-device CPU mesh.
"""

from __future__ import annotations

import os
import types

import torch

from hemx_torch import convert
from hemx_torch.cli import CliError
from hemx_torch.config import load_options
from hemx_torch.data.plugin import get_dataset_tensors
from hemx_torch.models.plugin import get_model
from hemx_torch.ops.layers import set_precision
from hemx_torch.parallel.mesh import worker_count
from hemx_torch.train.checkpoint import CheckpointManager


def check_device(name: str) -> torch.device:
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise CliError(f"--device {name}: no CUDA device is available (use "
                       f"--device cpu to run on the CPU)")
    return device


def global_batch(args, device) -> int:
    """The batch hemx's tools evaluate a run at: ``batch_size`` per device
    times ``n_devices or 1`` devices; on CUDA no more devices than the host
    has (``hemx.parallel.mesh.make_mesh``'s refusal)."""
    n = int(getattr(args, "n_devices", 0) or 0) or 1
    try:
        worker_count(n, str(device))
    except ValueError as e:
        raise CliError(str(e)) from None
    return args.batch_size * n


def restore_run(directory: str, device, epoch: int | None = None):
    """(args, splits, model, train state, host batch, checkpoint path) of
    the run in ``directory``: checkpoint ``epoch`` when the run has it,
    else its latest. The host batch is the train split's first unshuffled
    global batch."""
    args = types.SimpleNamespace(**load_options(
        os.path.join(directory, "options.json")))
    args.dir = directory
    batch = global_batch(args, device)
    set_precision(getattr(args, "precision", "default"))
    splits = get_dataset_tensors(args)
    cls = get_model(args.model)
    if cls is None:
        raise CliError(f"model '{args.model}' of {directory} is not in "
                       f"hemx_torch", code=2)
    model = cls(args, device)
    host_batch = next(splits["train"].iter_epoch(batch, shuffle=False))
    ts = model.init_state(model.input_shape(host_batch), args.seed)
    mgr = CheckpointManager(directory)
    path = dict(mgr.checkpoints()).get(epoch) or mgr.latest()
    if path is None:
        raise CliError(f"no checkpoint in {directory}")
    convert.load_checkpoint(ts, mgr.restore(path))
    return args, splits, model, ts, host_batch, path
