"""hemx_torch training CLI (counterpart of ``train.py``).

    python -m hemx_torch.cli --model iwgan --dataset synthetic --synthetic_u8 \\
        --dtype bfloat16 --dir workspace/iwgan
    python -m hemx_torch.cli ... --dir workspace/iwgan --epochs +1   # resume

``--model`` is one of ``cnn`` (the default, as in ``train.py``), ``vae``,
``gan``, ``wgan``, ``iwgan`` and the thesis depth models (``paper_cgan``,
``paper_sampler``, ``paper_noise``, ``paper_baseline_sampler``,
``paper_standalone``, ``paper_baseline_standalone``, ``sampler_gan``;
``python -m hemx_torch.paper_train`` adds their dataset depth moments),
the second generation (``improved_sampler``, ``mean_depth_estimator``,
``experimental_sampler``), ``pix2pix``, ``artist``, ``info_gan`` and the
no-op ``test``: hemx's whole zoo. Flags may come from hemx's config files
(``@examples/pix2pix.config``); ``--dataset`` one of ``floorplan`` (the
default), ``mnist``, ``cifar``, ``nyuv2``, ``celeb``, ``coco`` and
``synthetic``. A dataset whose records are not in ``--dataset_dir`` is
converted from its raw files in ``--raw_dataset_dir`` first:

    python -m hemx_torch.cli --model cnn --dataset mnist \
        --raw_dataset_dir <raw> --dataset_dir <records> [--no-device_data_cache]

``--n_devices N`` trains data parallel in N processes (one per GPU; gloo
ones with ``--device cpu``) at hemx's global batch, ``batch_size * N``;
under ``torchrun`` the processes join its group. ``--model_parallel M``
(every kernel sliced over M ranks) or ``--spatial_parallel S`` (every
image's height banded over S ranks) makes the N ranks hemx's grid
``[N/K, K]``, at the global batch ``batch_size * N / K``:

    python -m hemx_torch.cli ... --n_devices 2 --device cpu
    python -m hemx_torch.cli ... --n_devices 4 --model_parallel 2 --device cpu
    python -m torch.distributed.run --nproc_per_node 2 -m hemx_torch.cli ...

Flags are ``hemx``'s (see ``hemx_torch.config``) plus ``--device``
(default ``cuda``); the workspace (checkpoints, events, options) has
``train.py``'s layout and formats. The last line of standard output is a
JSON summary: device, final step and epoch, call count, median call time
and images/s. A non-finite gradient under ``--check_numerics`` exits 255,
as ``train.py`` does.
"""

from __future__ import annotations

import json
import sys

import torch
import torch.distributed as dist


class CliError(Exception):
    def __init__(self, message: str, code: int = 1):
        super().__init__(message)
        self.code = code


def build(argv=None, splits=None, axes: bool = True):
    """Parse the flags and build what a run trains: ``(args, device, model,
    splits)``. Checks the mesh flags, the device, then the model (exit
    code 2 when it is unknown), then the dataset, before any data is
    loaded. In a process group this rank's device is taken, and rank 0's
    seed and ``--dir`` are every rank's; a dataset whose records are
    missing is converted by one rank while the others wait on its lock,
    outside any collective (``prepare_dataset``). ``splits``: the
    dataset's splits for these flags when the caller holds them already
    (runs in one process over the same data), made here otherwise.
    ``axes``: lay the group out as ``--model_parallel`` /
    ``--spatial_parallel`` ask (``train.py``); the other entry points
    (``paper_train``, ``experimental``) ignore both flags, as hemx's
    build a data-only mesh."""
    from hemx_torch.config import parse_args
    from hemx_torch.data.plugin import (get_dataset, get_dataset_tensors,
                                        unknown_dataset_message)
    from hemx_torch.models.plugin import available_models, get_model
    from hemx_torch.ops.layers import set_precision
    from hemx_torch.parallel import dp, mesh

    args = parse_args(argv)
    n = workers(args, axes)
    world = dp.world_size()
    if world > 1 or dist.is_initialized():
        if args.n_devices and args.n_devices != world:
            raise CliError(f"--n_devices {args.n_devices} in a process group "
                           f"of {world}")
    elif n > 1:
        raise CliError(f"--n_devices {n} runs {n} processes: start them "
                       f"with hemx_torch.cli.main (python -m hemx_torch.cli)"
                       f" or torchrun")
    device = mesh.rank_device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise CliError(f"--device {args.device}: no CUDA device is available "
                       f"(use --device cpu to run on the CPU)")
    model_cls = get_model(args.model)
    if model_cls is None:
        raise CliError(f"unknown model '{args.model}'. Available in "
                       f"hemx_torch: {available_models()}", code=2)
    if get_dataset(args.dataset) is None:
        raise CliError(unknown_dataset_message(args.dataset))
    if dp.active():
        args.seed, args.dir = json.loads(dp.broadcast_bytes(
            json.dumps([args.seed, args.dir]).encode(), device))
    if dist.is_initialized():
        if axes:
            mesh.make_axes(args.model_parallel, args.spatial_parallel)
        else:
            dp.set_axis(None)
    set_precision(args.precision)
    model = model_cls(args, device)
    return args, device, model, (get_dataset_tensors(args) if splits is None
                                 else splits)


def workers(args, axes: bool = True) -> int:
    """Processes ``args`` train on (``--n_devices``; the group's size in
    one), after the refusals of hemx's ``make_mesh``: both axes at once,
    more GPUs than the host has, and an axis that does not divide the
    devices (``--model_parallel 2`` on a one-GPU host: "does not divide 1
    device(s)"). ``axes`` False: the axis flags are ignored."""
    from hemx_torch.parallel import mesh
    try:
        model, spatial = ((args.model_parallel, args.spatial_parallel)
                          if axes else (1, 1))
        mesh.check_axes(model, spatial)
        n = (dist.get_world_size() if dist.is_initialized()
             else mesh.worker_count(args.n_devices, args.device))
        mesh.check_axes(model, spatial, n)
        return n
    except ValueError as e:
        raise CliError(str(e)) from None


def train(args, device, model, splits) -> dict:
    """Train through ``hemx_torch.train.loop``; returns the loop's result
    plus "args" and "summary" (also printed as the last line)."""
    from hemx_torch.parallel import dp
    from hemx_torch.train import loop

    result = loop.train(model, splits, args, device)
    result["args"] = args
    result["summary"] = loop.summarize(result, loop.global_batch(args), device)
    if dp.is_primary():
        print(json.dumps(result["summary"]), flush=True)
    return result


def run(argv=None, splits=None) -> dict:
    """Parse, build and train (:func:`build`, then :func:`train`)."""
    return train(*build(argv, splits))


def main(argv=None, run=run, axes: bool = True) -> int:
    """Exit code of ``run(argv)``: 0, 255 on a non-finite gradient, 2 for
    an unknown model, 1 for other refusals. With ``--n_devices N > 1`` and
    no process group, ``run`` goes to N spawned worker processes, one per
    device (gloo ones for ``--device cpu``) that form the group, and the
    first nonzero exit of a worker is the command's; a process ``torchrun``
    started joins its group (``env://``) instead. ``axes``: as
    :func:`build`'s."""
    from hemx_torch.config import parse_base_args
    from hemx_torch.parallel import mesh
    try:
        if dist.is_initialized():
            return _main(argv, run)
        args = parse_base_args(argv)
        if mesh.under_launcher():
            mesh.initialize_distributed(device=args.device)
            try:
                return _main(argv, run)
            finally:
                mesh.shutdown()
        n = workers(args, axes)
        if n == 1:
            return _main(argv, run)
        return _spawn(argv, run, n, args)
    except CliError as e:
        print(f"ERROR: {e}", file=sys.stderr)
        return e.code


def _main(argv, run) -> int:
    try:
        run(argv)
    except FloatingPointError as e:
        print(f"ERROR: {e}", file=sys.stderr)
        return 255
    except (CliError, NotImplementedError) as e:
        print(f"ERROR: {e}", file=sys.stderr)
        return getattr(e, "code", 1)
    return 0


def _worker_main(argv, run) -> None:
    code = _main(argv, run)
    if code:
        sys.exit(code)


def _spawn(argv, run, n: int, args) -> int:
    """``run`` in ``n`` worker processes (:func:`build` gives every rank
    rank 0's seed and ``--dir``)."""
    import torch.multiprocessing as mp

    from hemx_torch.parallel import mesh
    argv = list(sys.argv[1:] if argv is None else argv)
    try:
        mesh.spawn(_worker_main, n, device=args.device, args=(argv, run))
    except mp.ProcessExitedException as e:
        return e.exit_code or 1
    except mp.ProcessRaisedException as e:
        print(f"ERROR: a worker failed:\n{e}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
