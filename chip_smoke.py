#!/usr/bin/env python3
"""Bring-up smoke test of hemx_torch on one NVIDIA GPU.

    python3 chip_smoke.py        # from the root of a hemx checkout

Phases (each raises on failure, so the script exits nonzero and never
prints its last line):

1. Card: ``nvidia-smi`` name and power limit; torch / CUDA / cuDNN
   versions; the native reader's g++ build and the input kernel's nvcc
   build (``hemx_torch/csrc/gather_u8_normalize.cu`` into
   ``hemx_torch/_build/cuda``): its seconds, nvcc's version and the
   ``-Xptxas -v`` lines (registers, shared memory, spills).
2. Kernel vs plain: the CUDA gather+normalize kernel against its plain
   PyTorch version, ``torch.equal`` on every shape: the training path's
   (a 4096x64x64x3 uint8 dataset, a 3072-row index = 6 batches of 512,
   lo/hi (0,1) and (-1,1), int64 and int32 indices), an odd shape (37
   rows of 5x7x3), and awkward ones (rows of 1 to 40 bytes, whole and as
   bands, 65x65x1 and 66x66x1 bands in int32 and int64, a view 3 bytes
   into its storage with its first and last rows gathered, one row, and
   zero rows, which launch nothing); median CUDA-event time of each over
   25 launches.
3. Card vs CPU at a small size (latent 16, 32 px, batch 8, --precision
   highest, sgd): one IWGAN train call from the same weights, batches and
   noise on cuda and on cpu; losses rtol 5e-4 / atol 1e-5, params and G's
   BN stats rtol 2e-3 / atol 2e-5 (tests/test_models.py:324-332).
4. The slice at full width through the CLI: IWGAN latent 200, 64x64x3,
   batch 512, 5 critic steps + 1 generator step per call, Adam, f32, 8
   calls on a 4096-image uint8 dataset (the stream crosses epoch tails).
   Checks finite losses, step == 8, changed G and D params, everything on
   cuda, and that the kernel launched once per batch group (plus once per
   tail batch, the summary batch and each validation batch). Prints the
   median call time and images/s beside the card name.
5. Card vs CPU at phase 3's size in bf16 with rmsprop at hemx's defaults
   (decay 0.9, momentum 0.01): the output dtype of every layer (forward
   hooks) is the same on both devices and is hemx's (bf16, f32 after BN);
   losses rtol 3e-2; params and G's BN stats rtol 1e-2 / atol 1e-4 at
   most (the tolerance the run needed is printed).
6. The whole run at full width in bf16: ``--dtype bfloat16``, Adam, 1
   epoch of 6 calls with ``--max_to_keep 2``, then ``--epochs +1`` on the
   same ``--dir``. Checks checkpoints 0 and 1 after the first run; the
   second resumes at step 6 from checkpoint 1 (restore bit-exact), ends at
   step 12 with checkpoints {1, 2}; finite train and validate losses at the
   expected summary steps, read back from the events files; every conv and
   BN input on the card in bf16; the input kernel's launch count. Prints
   call time, images/s, checkpoint size, save and restore seconds and
   seconds per summary write.

7. Card vs CPU at phase 3's size for the other BASELINE models (``gan``,
   ``wgan`` with 2 critic steps, ``cnn``, ``vae``), sgd (lr 1e-5 for the
   VAE, whose losses are sums): one call from the same weights, batches and
   noise on each device; losses rtol 5e-4 / atol 1e-5, ``grad_norm``,
   params and BN stats rtol 2e-3 / atol 2e-5; prints the tolerance each
   run needed.
8. Each of them at full width in bf16 (latent 200, 64x64x3; gan and wgan
   bs512 rmsprop 2.5e-5, wgan 5 critic steps; cnn bs1024 rmsprop 1e-4; vae
   bs512 rmsprop 1e-3) through the CLI: 1 epoch of 4 calls with
   ``--max_to_keep 2``, then ``--epochs +1``, with phase 6's checks
   (resume at step 4 bit-exact, step 8, checkpoints {1, 2}, finite train
   and validate losses at the expected steps, bf16 conv outputs, the input
   kernel's launch count for the model's batch group). Prints each model's
   median call time and images/s.
9. The data layer at full width: a raw floorplan directory (4,096 train,
   512 validate and 512 test RGB PNGs of 128x128, row y written with PNG
   filter y % 5, so every unfilter path runs) converted by the port's
   plugin into records; IWGAN bf16 (latent 200, bs512, 5+1, Adam, 1 epoch
   of 6 calls) through ``cli.run --dataset floorplan`` on the device cache
   (a) and with ``--no-device_data_cache`` (b: the streaming Pipeline, one
   6-batch group per call, one pinned H2D copy each). Checks step 6, finite
   losses, no resume, the input kernel's launches on each path (groups,
   tails, summary batch, validation batches), the streamed bytes, and that
   (b)'s batches equal (a)'s bit for bit on the card over 2 data epochs.
   Then 512 NYUv2-format frames (RGB 120x160 and 16-bit depth, one frame
   per split with a sensor gap): the CNN in bf16 on 64x64 random crops,
   bs64, 4 calls, streaming (the split has a host transform). Checks the
   gap frames dropped, finite losses, and the first streamed batch equal
   to the CPU split's. Prints the conversion seconds, the host
   materialization rate (images/s decoded and resized), each run's median
   call and images/s, and the H2D GB/s of the streamed copies.

10. Card vs CPU for the thesis depth models at 65x65 (f32, ``--precision
   highest``, batch 4): ``paper_cgan`` in each ``--model_version`` under
   ``gan`` and ``mean_adjusted`` under ``wgan``, ``paper_standalone``
   ``mean_provided``, ``paper_sampler`` at ``--noise_layer`` e2 and d3, and
   ``sampler_gan --garch large --darch late --batch_norm_gen
   --batch_norm_disc`` (batch 8, as its late critic runs BN on 1x1 maps,
   ill-conditioned over 4 rows): one call from the same weights, batches
   and seam noise on each device, every optimizer replaced by sgd 1e-3
   as phase 7 steps (Adam's first step, lr * g / (|g| + 1e-8), turns a
   2e-8 card-vs-CPU difference in a near-zero gradient into 4.9e-5 of
   weight, over the atol), then ``predict``; losses rtol 5e-4 / atol
   1e-5, gradient norms, params, BN stats and the Eigen scalars of the
   prediction rtol 2e-3 / atol 2e-5; prints the tolerance each needed.
   Each model's own optimizer is then held on the card as phase 12 says.
11. The thesis slice at full width through ``hemx_torch.paper_train``
   (scripts/thesis_runs.sh's COMMON: 4,096 / 512 synthetic 65x65x3 uint8
   images, bs256, seed 7, its optimizer flags; one epoch = 16 calls):
   (a) ``paper_cgan --model_version mean_adjusted`` in f32, then ``--epochs
   +1`` (phase 6's checks, f32 conv products, the three moment files, the
   ``metrics_y_hat|y_0|y_mean`` summaries, two input-kernel launches per
   gathered group, the formula printed); (b) ``--training_version wgan``,
   every parameter within +-0.01; (c) ``paper_standalone mean_provided``;
   (d) ``paper_sampler --noise_layer e4-512``; (e) (a) in bf16 (every conv
   and deconv product bf16 on the card); (f) ``paper_cgan`` on phase 9's
   NYUv2 records, 65x65 random crops, bs64, 4 calls, streaming (float
   images: no kernel); (g) each of the 14 runs thesis_runs.sh trains for
   experiment1/1b/2 (paper_standalone and paper_cgan per version,
   paper_sampler per site), 3 calls. Prints each run's median call,
   images/s (a call counts one batch) and the moments' host seconds.

12. Card vs CPU for the second generation (f32, ``--precision highest``,
   batch 4, phase 10's checks, sgd): ``improved_sampler`` A1/A1 at 65x65,
   B1/B1 at 66x66 and E1/E1 with ``--g_sparsity --g_rmse`` at 64x64 (the
   bottleneck's zero fraction may differ by 2 of its 4,096 entries, and
   ``g_loss`` by that much more), ``mean_depth_estimator`` and the
   ``experimental_sampler`` composed with an estimator, at 64x64.
   Phases 10 and 12 then step each model once on the card with its own
   optimizer (a1.config's Adam here) and apply the CPU's optax-exact
   transform to the card's own gradients, moved to the CPU: the updates
   agree at rtol 1e-5 (plus one float32 ulp of the parameter per step)
   and the moments at rtol 1e-5.
13. The second generation at full width through its entry points, from
   hemx's config files (``@examples/improved_sampler/*.config``) on
   synthetic uint8 sets of 4,096 / 512 images at each run's patch size,
   seed 7: (a) ``a1.config`` (A1/A1, 65 px, bs256, Adam 1e-4 / 0.5, f32),
   an epoch of 16 calls then ``--epochs +1`` with phase 6's checks (resume
   bit-exact, conv products f32); (b) ``ff.sparsity.config`` (E1/E1, 64
   px, bs512, 8 calls); (c) ``gb1.db1.config`` (B1/B1, 66 px, bs512, 8
   calls); (d) ``experimental.config`` through ``python -m
   hemx_torch.experimental`` at bs64 with ``--estimator_epochs 1 --epochs
   1`` (the published 30 and 10 cut), sampler lr 1e-4; (e)
   ``hemx_torch.paper_metrics`` and ``hemx_torch.paper_fullimage
   --scene_shape 240 320 3 --strides 8 4 2`` on phase 11's paper_cgan run.
   Each prints its median call, images/s (patches/s for (e)), its wall
   time and the input kernel's launches beside the expected count.

14. Card vs CPU for the rest of the zoo (f32, ``--precision highest``,
   batch 4, phase 10's checks, sgd): ``pix2pix`` at 32x32 with
   ``--add_l1``, with every noise site, ``--dropout 0.5`` and BN in G and
   D, and with ``--n_disc_train 2`` (the seam carries the U-Net's noise
   and keep masks); ``artist`` at 65x65; ``info_gan`` at 32x32; then each
   model's own optimizer (Adam) on the card as phase 12 holds it.
15. The rest of the zoo at full width through ``cli.run`` from hemx's
   config files, NYUv2 (not in the repository) replaced by 1,024 / 128
   synthetic uint8 image + depth pairs of 256x256, seed 7, made once and
   shared by the runs: (a) ``pix2pix.config`` (bs64, Adam 1e-4 / 0.5, f32),
   an epoch of 16 calls then ``--epochs +1`` with phase 6's checks; (b)
   ``pix2pix/no_l1.config`` (dropout 0.5, BN in G and D), 8 calls; (c)
   ``noise``, ``noise2`` (d1 takes 1,024 channels) and ``noise3.config``,
   3 calls each; (d) ``baseline2.config`` (batch 1, BN in G over 1x1 maps
   of one row), 16 calls; (e) (a) in bf16, 4 calls and +1, every conv and
   deconv product bf16; (f) ``artist.config`` (bs32), 8 calls, then an x
   step on the card that leaves the encoder's parameters bit for bit; (g)
   ``info_gan`` bs32, Adam 1e-4, 6 calls. Montages of 8 examples and one
   summary per epoch besides its end (hemx's cadence would write 17
   summaries of four 64-image montages in a 16-call epoch). Each prints its median call, images/s, peak
   device memory (reset per run), the input kernel's launches against
   their formula, and one more call traced: device launches, device time
   and busy share.

16. celeb and coco at full width: a raw CelebA tree (2,048 / 512 / 256
   178x218 JPEGs written with Pillow, partition and attribute lists) and a
   raw COCO tree (384 / 64 / 64 JPEGs of 320x240, 213x320 and 240x320
   with a polygon, an uncompressed and a compressed RLE per annotated
   image) are converted by the CLI's preparation step (decode and
   materialization rates printed); one JPEG's decode equals Pillow's own
   on this host; the IWGAN bf16 (bs512, latent 200, 5+1, Adam) on celeb
   through ``cli.run``, an epoch of 4 calls then ``--epochs +1`` with
   phase 6's checks; coco's ``annotations`` gathered on the card equal
   the host's uint8 category ids; the CNN bf16 on coco, 4 calls. Input
   launches against their formula.
17. Data parallel: ``--n_devices 2`` on a one-GPU host is refused with
   hemx's message; (a) two gloo ranks on cuda:0 (batch 4 each), started
   by ``hemx_torch.parallel.mesh.spawn`` with the CLI's worker function,
   against one process at batch 8, one call each of iwgan, gan, vae and
   paper_standalone (``--precision highest``): parameters, BN statistics
   and optimizer state rtol 2e-3 / atol 2e-5 (the VAE, whose float32 KL
   gradient is ill-conditioned, rtol 2e-2 / atol 1e-2), losses rtol 5e-4
   (``grad_norm`` 1e-3; the VAE's validation and ``grad_norm`` 2e-2), as
   ``tests/test_torch_dp_cli.py``; (b) the full-width bf16 IWGAN, 6 calls,
   through ``python -m torch.distributed.run --standalone
   --nproc_per_node 1 -m hemx_torch.cli`` (NCCL, world size 1): its median
   call beside phase 6's, the gradient bytes all-reduced per call, its
   input launches against their formula.
18. The post-training tools: (a) card vs CPU on a tiny cnn and a tiny gan
   run trained on the card (32 px, batch 8, ``--precision highest``): the
   visualized net's captures at rtol 2e-3 / atol 2e-5, the bestfit ascent
   from the same starts (first step rtol 1e-4 / atol 1e-5, 20 steps
   within 2/255 normalized), the CNN's encoder and pixel features and the
   FID from each side's; (b) ``hemx_torch.visualize --sample --timelapse
   --activations --weights --bestfit`` on phase 6's bf16 IWGAN run and
   phase 8's bf16 cnn run (each tool's seconds, every PNG decoded, the
   input kernel's launches: one per placement), and FID of 4,096 real
   images (one gather through the device cache) against 4,096 IWGAN
   samples in 512-row chunks, pixel and encoder (phase 8's CNN), with the
   train-vs-validate floor of each, every value finite and a set's FID
   against itself below 1e-6 of its trace; (c) whether matplotlib imports
   here, and if it does ``--loss``, ``hemx_torch.events`` and the
   ``paper_visualize`` presets on phase 11's runs and the GUI's chart
   route; the GUI's HTML routes over 127.0.0.1 always.
19. hemx's ``model`` and ``spatial`` mesh axes: (a) ``python -m
   hemx_torch.cli --model_parallel 2`` and ``--spatial_parallel 2`` exit 1
   with hemx's "does not divide 1 device(s)" on a one-GPU host; (b) iwgan
   (``n_disc_train 2``) and cnn at phase 3's size on four gloo ranks of
   the card, as data 2 x model 2 and data 2 x spatial 2 (batch 4 per data
   shard), against one process at batch 8, with phase 17 (a)'s
   tolerances and cuDNN's deterministic algorithms, and each rank's input
   launches; (c) hemx's ``examples/multichip_scaling.config`` (IWGAN,
   latent 200, 64x64x3, batch 128 per data shard, Adam(1e-4, 0.5, 0.9),
   5+1) on two gloo ranks of the card, once under ``--spatial_parallel 2``
   and once under ``--model_parallel 2``, ``synthetic_count`` cut to
   1,024, 2 calls and a checkpoint: finite losses, the checkpoint's tree
   and shapes a one-process run's and resumed by one process, launches
   equal to their formula, per call time, axis collectives and bytes,
   each rank's peak device memory and parameter-and-moment bytes against
   the one-process run's (under ``model`` at most 0.6 of it); (d), in
   phase 2: the input kernel's height band (512 rows of 64x64x3 and 128
   of 256x256x3, each in two bands) bit-equal to its plain version and to
   the whole gather's rows, device time with the L2 cache flushed,
   against its bytes bound.
20. The native reader (``hemx_torch.native``, host C++ beside the card):
   built into a fresh directory (seconds, ``g++ --version``), 64 MiB of
   12,288-byte records written by ``write_records`` and by
   ``TFRecordWriter``, byte-equal; the C++ reader (with and without
   ``verify``) and counter equal the plain walks; a flipped payload byte
   raises under ``verify``; a cut inside the last record's header CRC,
   payload or data CRC raises "truncated" in the C++ reader, the C++
   counter and the plain iterator, a cut inside the length field is a
   clean end in all three; seconds per MiB of the CRC, the writes and the
   reads, C++ and plain, on their own JSON line before the kernels line.
   Phase 1 builds the module into ``hemx_torch/_build/native`` first, so
   no build falls into a timed region; phases 9 and 16 check that their
   conversions ran through that build, and phase 6 prints the CRC's
   seconds per MiB both ways.

Phase 2 also times the kernel, by CUDA events and by the device time
torch.profiler records with the 50 MB L2 cache flushed before each
launch, on shorter gathers (short enough that an event pair around one
launch mostly times the host's launch latency, and small enough to stay
in L2 from one launch to the next): the thesis sets' rows (512 of 65x65x3
and 65x65x1, 12,675 and 4,225 bytes, not 16-byte aligned; of 66x66x3 and
66x66x1, 13,068 and 4,356 bytes; of 64x64x3 and 64x64x1) and phase 15's
(128 of 256x256x3 and 256x256x1, one pix2pix bs64 call's two batches).

Phase 20's figures are a JSON line of their own (``native_io``) before
the kernels line. The kernels line is a JSON list of the kernels with
their launch counts summed over phases 4, 6, 8, 9, 11, 13, 15-19 (each path's
counts set to 0 just before it and read just after, phase 17's by each
worker process and the torchrun run's summary line; by phase under
``launches_by_phase``), their phase-2 errors and times (the short gathers
under ``cold_rows``, the band rows of phase 19 (d), run in phase 2, under
``band_rows``), and their bound; then the phases' seconds, and the last
line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

# H100 SXM HBM3 rate (NVIDIA data sheet), for the kernel's bound
HBM_BYTES_PER_S = 3.35e12


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def png_bytes(img, filters=None) -> bytes:
    """PNG file bytes of ``img``: uint8 (H, W, C) with C 1-4 (grey, grey +
    alpha, RGB, RGBA), or uint16 (H, W) / (H, W, 1) as 16-bit grey. Row
    ``y`` is written with PNG filter ``filters[y]`` (default ``y % 5``, so
    one image holds all five); the forward filters are vectorised."""
    import struct
    import zlib

    import numpy as np
    img = np.asarray(img)
    if img.dtype == np.uint16:
        h, w = img.shape[:2]
        rows = img.reshape(h, w).astype(">u2").view(np.uint8).reshape(h, -1)
        depth, ctype, bpp = 16, 0, 2
    else:
        img = img[:, :, None] if img.ndim == 2 else img
        h, w, c = img.shape
        rows = img.reshape(h, -1)
        depth, ctype, bpp = 8, {1: 0, 2: 4, 3: 2, 4: 6}[c], c
    x = rows.astype(np.int16)
    up = np.vstack([np.zeros_like(x[:1]), x[:-1]])
    left = np.hstack([np.zeros_like(x[:, :bpp]), x[:, :-bpp]])
    up_left = np.hstack([np.zeros_like(up[:, :bpp]), up[:, :-bpp]])
    p = left + up - up_left
    pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - up_left)
    paeth = np.where((pa <= pb) & (pa <= pc), left,
                     np.where(pb <= pc, up, up_left))
    kinds = (np.arange(h) % 5 if filters is None
             else np.asarray(filters, np.int64))
    pred = np.stack([np.zeros_like(x), left, up, (left + up) // 2,
                     paeth])[kinds, np.arange(h)]
    data = np.hstack([kinds[:, None].astype(np.uint8),
                      ((x - pred) & 255).astype(np.uint8)])

    def chunk(tag: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + tag + body
                + struct.pack(">I", zlib.crc32(tag + body) & 0xFFFFFFFF))
    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0,
                                         0, 0))
            + chunk(b"IDAT", zlib.compress(data.tobytes(), 6))
            + chunk(b"IEND", b""))


def phase_card(torch) -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(out, flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, cuDNN "
          f"{torch.backends.cudnn.version()}", flush=True)
    from hemx_torch import native
    t0 = time.perf_counter()
    mod = native.load()
    print(f"hemx_torch.native: {mod.__file__} loaded in "
          f"{time.perf_counter() - t0:.2f} s (built at first use)",
          flush=True)
    build_kernel()
    return out


def build_kernel() -> float:
    """The input kernel's nvcc build (none if it is there already): prints
    its seconds, nvcc's version and ptxas's registers, shared memory and
    spills of each instance; returns the seconds."""
    from hemx_torch.ops import input_kernels as K
    from hemx_torch.utils.build import log_path
    fresh = not os.path.exists(K.so_path())
    t0 = time.perf_counter()
    path = K.build()
    secs = time.perf_counter() - t0
    version = subprocess.run([K.nvcc(), "--version"], capture_output=True,
                             text=True, timeout=60).stdout.strip()
    print(f"input kernel: {'built' if fresh else 'found'} {path} in "
          f"{secs:.2f} s by {version.splitlines()[-1]}: "
          f"{' '.join(K.compile_command())}", flush=True)
    with open(log_path(path)) as f:
        for line in f:
            if re.search(r"Compiling entry|Used \d+ registers|spill", line):
                print(f"  {line.strip()}", flush=True)
    return secs


def _median_ms(torch, fns: dict, n: int = 25, warmup: int = 3) -> dict:
    """Median CUDA-event time per launch of each fn, launched in turns."""
    for _ in range(warmup):
        for f in fns.values():
            f()
    torch.cuda.synchronize()
    events = {k: [] for k in fns}
    for _ in range(n):
        for k, f in fns.items():
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            f()
            e.record()
            events[k].append((s, e))
    torch.cuda.synchronize()
    return {k: statistics.median(s.elapsed_time(e) for s, e in v)
            for k, v in events.items()}


def _device_ms(torch, fn, n: int = 20, flush=None) -> float:
    """Device time per call of ``fn``: the summed duration of the CUDA
    kernels ``n`` calls launch, from ``torch.profiler``, over ``n``. Unlike
    a CUDA-event pair around one call, it leaves out the host's launch
    latency, which an idle device waits through. ``flush`` (a 256 MB
    ``zero_``, a fill kernel, left out of the sum) runs before each call,
    so a gather smaller than the 50 MB L2 cache finds it cold, as a train
    call's gather of fresh rows does."""
    from torch.autograd import DeviceType
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                if flush is not None:
                    flush()
                fn()
            torch.cuda.synchronize()
        cuda = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        fills = (sum("FillFunctor" in e.name for e in cuda)
                 if flush is not None else n)
        mine = [e for e in cuda
                if not (flush is not None and "FillFunctor" in e.name)]
        # a trace that lost events (the profiler has been seen to drop some
        # or all of them after many sessions in one process) is taken again
        if fills == n and mine and len(mine) % n == 0:
            return sum(e.time_range.elapsed_us() for e in mine) / n / 1e3
        print(f"torch.profiler recorded {fills} of {n} flushes and "
              f"{len(mine)} kernels; tracing again", flush=True)
    check(False, "the profiler recorded an incomplete trace three times")


def phase_kernel(torch, dev) -> dict:
    from hemx_torch.ops import input_kernels as K
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    cases = []
    ds = torch.randint(0, 256, (4096, 64, 64, 3), dtype=torch.uint8,
                       device=dev, generator=g)
    idx = torch.randperm(4096, device=dev, generator=g)[:3072]
    for lo, hi in ((0.0, 1.0), (-1.0, 1.0)):
        cases.append((ds, idx, lo, hi))
    cases.append((ds, idx.to(torch.int32), 0.0, 1.0))
    odd = torch.randint(0, 256, (50, 5, 7, 3), dtype=torch.uint8, device=dev,
                        generator=g)
    odd_idx = torch.randint(0, 50, (37,), device=dev, generator=g)
    cases += [(odd, odd_idx, 0.0, 1.0), (odd, odd_idx, -1.0, 1.0)]
    max_err = 0.0
    for d, i, lo, hi in cases:
        a = K.gather_u8_normalize(d, i, lo, hi)
        b = K.gather_u8_normalize_ref(d, i, lo, hi)
        torch.cuda.synchronize()
        n, h, w, c = d.shape
        check(a.shape == (i.numel(), c, h, w) and a.dtype == torch.float32,
              f"kernel output {a.dtype} {tuple(a.shape)}")
        check(a.is_contiguous(memory_format=torch.channels_last),
              "kernel output is not channels_last")
        err = (a - b).abs().max().item()
        print(f"kernel vs plain: ds {tuple(d.shape)} idx {i.numel()} "
              f"{i.dtype} lo/hi ({lo}, {hi}): max abs diff {err:.3g}",
              flush=True)
        check(torch.equal(a, b), f"kernel disagrees with plain version: "
                                 f"{err}")
        max_err = max(max_err, err)
    cold = []
    l2_flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    flush = l2_flush.zero_
    # (side, channels, dataset rows, gathered rows): the thesis sets' image
    # and depth rows, 65x65 (paper models, A*), 66x66 (B1, C1) and 64x64
    # (B2, D1, E1, the experimental sampler), 512 of 4,096; pix2pix's,
    # artist's and info_gan's 256x256 rows, 128 of 1,024 (one pix2pix bs64
    # call's two batches)
    for side, c, n_ds, rows in ((65, 3, 4096, 512), (65, 1, 4096, 512),
                                (66, 3, 4096, 512), (66, 1, 4096, 512),
                                (64, 3, 4096, 512), (64, 1, 4096, 512),
                                (256, 3, 1024, 128), (256, 1, 1024, 128)):
        d65 = torch.randint(0, 256, (n_ds, side, side, c), dtype=torch.uint8,
                            device=dev, generator=g)
        i65 = torch.randperm(n_ds, device=dev, generator=g)[:rows]
        a = K.gather_u8_normalize(d65, i65, 0.0, 1.0)
        b = K.gather_u8_normalize_ref(d65, i65, 0.0, 1.0)
        torch.cuda.synchronize()
        check(a.shape == (rows, c, side, side)
              and a.is_contiguous(memory_format=torch.channels_last),
              f"kernel output {tuple(a.shape)} on {side}x{side}x{c} rows")
        err = (a - b).abs().max().item()
        check(torch.equal(a, b), f"kernel disagrees on {side}x{side}x{c} "
                                 f"rows: {err}")
        max_err = max(max_err, err)
        t = _median_ms(torch, {
            "kernel": lambda: K.gather_u8_normalize(d65, i65, 0.0, 1.0),
            "plain": lambda: K.gather_u8_normalize_ref(d65, i65, 0.0, 1.0)})
        d = {"kernel": _device_ms(
                 torch, lambda: K.gather_u8_normalize(d65, i65, 0.0, 1.0),
                 flush=flush),
             "plain": _device_ms(
                 torch, lambda: K.gather_u8_normalize_ref(d65, i65, 0.0, 1.0),
                 flush=flush)}
        row = side * side * c
        moved = rows * (row * 5 + i65.element_size())
        bound = moved / HBM_BYTES_PER_S * 1e3
        cold.append({"rows": f"{rows}x{side}x{side}x{c}", "row_bytes": row,
                     "max_abs_err": err, "ms": t["kernel"],
                     "plain_ms": t["plain"], "device_ms": d["kernel"],
                     "plain_device_ms": d["plain"], "bound_ms": bound})
        aligned = "" if row % 16 == 0 else ", not 16-byte aligned"
        print(f"gather_u8_normalize {rows}x{side}x{side}x{c} ({row} B rows"
              f"{aligned}): max abs diff {err:.3g}; kernel "
              f"{t['kernel']:.4f} ms, plain {t['plain']:.4f} ms (median of "
              f"25 CUDA-event timed launches, launch latency included); "
              f"device time (torch.profiler, 20 calls, L2 flushed before "
              f"each) kernel "
              f"{d['kernel']:.4f} ms, plain {d['plain']:.4f} ms; bound "
              f"{bound:.4f} ms ({moved / 1e6:.2f} MB at 3.35 TB/s), kernel "
              f"at {100 * bound / t['kernel']:.0f} % of it by events, "
              f"{100 * bound / d['kernel']:.0f} % by device time",
              flush=True)
    ms = _median_ms(torch, {
        "kernel": lambda: K.gather_u8_normalize(ds, idx, 0.0, 1.0),
        "plain": lambda: K.gather_u8_normalize_ref(ds, idx, 0.0, 1.0)})
    # bytes the function must move: the gathered uint8 rows and the index
    # read once, the float32 rows written once
    moved = idx.numel() * (64 * 64 * 3 * 5 + idx.element_size())
    bound_ms = moved / HBM_BYTES_PER_S * 1e3
    print(f"gather_u8_normalize 3072x64x64x3: kernel {ms['kernel']:.4f} ms "
          f"({moved / ms['kernel'] / 1e6:.1f} GB/s), plain {ms['plain']:.4f} "
          f"ms (median of 25 CUDA-event timed launches); bound "
          f"{bound_ms:.4f} ms ({moved / 1e6:.1f} MB at 3.35 TB/s), kernel at "
          f"{100 * bound_ms / ms['kernel']:.0f} % of it; no single PyTorch "
          f"call computes gather + convert + scale", flush=True)
    bands = phase_band_kernel(torch, dev)
    phase_kernel_awkward(torch, dev)
    return {"max_abs_err": max_err, "ms": ms["kernel"],
            "plain_ms": ms["plain"], "bound_ms": bound_ms,
            "bound_by": "bytes", "library_ms": None, "cold_rows": cold,
            "band_rows": bands}


def phase_kernel_awkward(torch, dev) -> None:
    """Phase 2's awkward shapes, each ``torch.equal`` to the plain version
    and launched once (zero rows: never): rows of 1 to 40 bytes, whole and
    as bands; 65x65x1 and 66x66x1 whole and in odd bands; rows 1-2 of
    5x7x3; int32 and int64 indices; a view 3 bytes into its storage, whose
    bytes around it (255) differ from all it holds, with its first and
    last rows gathered; one row; zero rows."""
    from hemx_torch.ops import input_kernels as K
    g = torch.Generator(device=dev)
    g.manual_seed(2)

    def u8(shape, top=256):
        return torch.randint(0, top, shape, dtype=torch.uint8, device=dev,
                             generator=g)
    cases = []
    for width in range(1, 41):
        cases.append((u8((301, 1, width, 1)), 777, None))
        if width % 2 == 0:
            cases.append((u8((301, 2, width // 2, 1)), 777, (1, 2)))
    for shape, n, rows, bands in (
            ((65, 65, 1), 4096, 512, (None, (1, 64), (33, 34))),
            ((66, 66, 1), 4096, 512, (None, (17, 50))),
            ((5, 7, 3), 50, 37, ((1, 2), (2, 5))),
            ((5, 7, 3), 50, 1, (None, (4, 5))),
            ((5, 7, 3), 50, 0, (None, (1, 2)))):
        d = u8((n,) + shape)
        cases += [(d, rows, b) for b in bands]
    n, shape = 40, (65, 65, 1)
    storage = torch.full((n * 65 * 65 + 3 + 17,), 255, dtype=torch.uint8,
                         device=dev)
    view = storage[3:3 + n * 65 * 65].view((n,) + shape)
    view.copy_(u8(view.shape, top=255))
    check(view.is_contiguous() and view.data_ptr() % 16 == 3,
          f"the view starts at {view.data_ptr()} % 16, not 3")
    ends = torch.tensor([0, n - 1, n - 1, 0], device=dev)
    cases += [(view, ends, None), (view, ends, (64, 65))]
    checked = 0
    for d, rows, band in cases:
        for dtype in (torch.int64, torch.int32):
            idx = (rows if torch.is_tensor(rows) else torch.randint(
                0, d.shape[0], (rows,), device=dev, generator=g)).to(dtype)
            before = K.LAUNCHES["gather_u8_normalize"]
            for lo, hi in ((0.0, 1.0), (-1.0, 1.0)):
                a = K.gather_u8_normalize(d, idx, lo, hi, band)
                b = K.gather_u8_normalize_ref(d, idx, lo, hi, band)
                torch.cuda.synchronize()
                check(a.shape == b.shape and a.is_contiguous(
                    memory_format=torch.channels_last) and torch.equal(a, b),
                    f"kernel differs from plain on {tuple(d.shape)} rows "
                    f"{idx.numel()} band {band} {dtype}")
                checked += 1
            check(K.LAUNCHES["gather_u8_normalize"] - before
                  == (2 if idx.numel() else 0),
                  f"{idx.numel()} rows: launched "
                  f"{K.LAUNCHES['gather_u8_normalize'] - before} times")
    print(f"gather_u8_normalize awkward shapes: {checked} gathers bit-equal "
          f"to the plain version (rows of 1-40 bytes whole and as bands, "
          f"65x65x1 and 66x66x1 in odd bands, 5x7x3 rows 1-2, one row, "
          f"zero rows launching nothing, a view 3 bytes into its storage; "
          f"int64 and int32 indices)", flush=True)


def _close(a, b, rtol, atol, what):
    import numpy as np
    a, b = np.asarray(a), np.asarray(b)
    ok = np.all(np.abs(a - b) <= atol + rtol * np.abs(b))
    check(bool(ok), f"{what}: cuda {a.ravel()[:4]} vs cpu {b.ravel()[:4]} "
                    f"(max abs diff {np.max(np.abs(a - b)):.3g})")


def _small_args(extra, model: str = "iwgan", n_disc_train: int = 5):
    from hemx_torch.config import parse_args
    gan = model in ("gan", "wgan", "iwgan")
    return parse_args(["--model", model, "--dataset", "synthetic",
                       "--synthetic_u8", "--synthetic_count", "64",
                       "--synthetic_shape", "32", "32", "3",
                       "--batch_size", "8", "--latent_size", "16",
                       "--precision", "highest", "--seed", "0"]
                      + (["--n_disc_train", str(n_disc_train)] if gan else [])
                      + extra)


def _seam_noise(torch, model, batch: int, latent: int):
    """Noise for one train call through the model's seam, drawn on the CPU:
    ``{"z", "alpha"}`` per IWGAN critic step, ``{"z"}`` per other GAN step,
    one ``{"eps"}`` for the VAE; None for the CNN, which draws none."""
    name = model.name
    if name == "cnn":
        return None
    g = torch.Generator()
    g.manual_seed(1)
    if name == "vae":
        return [{"eps": torch.randn((batch, latent), generator=g)}]
    n = model.batches_per_train_call()
    out = []
    for i in range(n):
        d = {"z": torch.randn((batch, latent), generator=g)}
        if name == "iwgan" and i < n - 1:
            d["alpha"] = torch.rand((batch, 1), generator=g)
        out.append(d)
    return out


def _one_call_each(torch, dev, args, hooks: bool = False) -> dict:
    """One train call of ``args.model`` from the same weights, batches and
    noise on the CPU and on ``dev``: {device: (metrics, (params, mstate),
    batches, layer output dtypes)}."""
    from hemx_torch import convert
    from hemx_torch.data.pipeline import DeviceDataPipeline
    from hemx_torch.data.synthetic import SyntheticDataset
    from hemx_torch.models.plugin import get_model
    from hemx_torch.ops.layers import set_precision

    set_precision(args.precision)
    split = SyntheticDataset.get_datasets(args)["train"]
    cls = get_model(args.model)
    noise = _seam_noise(torch, cls(args, "cpu"), 8, 16)
    out = {}
    for d in ("cpu", dev):
        model = cls(args, d)
        ts = model.init_state((3, 32, 32), args.seed)
        dtypes, handles = {}, []

        def record(key):
            def hook(module, inp, out):
                dtypes.setdefault(key, out[0].dtype)
            return hook
        if hooks:
            for net in ("generator", "discriminator"):
                for name, layer in ts.nets[net].named_children():
                    handles.append(layer.register_forward_hook(
                        record(f"{net}/{name}")))
        n = model.batches_per_train_call()
        pipe = DeviceDataPipeline(split, 8, device=d, keys=("image",),
                                  seed=0, group=n)
        batches = list(pipe.epoch(0))[:n]
        kw = {} if noise is None else {"noise": noise}
        ts, metrics = model.train(ts, iter(batches), **kw)
        for h in handles:
            h.remove()
        out[str(d)] = ({k: float(v) for k, v in metrics.items()},
                       convert.to_jax(ts.nets),
                       [b["image"].cpu() for b in batches], dtypes)
    return out


def _compare_trees(out, dev, rtol, atol):
    """Check both runs' params and BN stats at (rtol, atol); returns the
    largest |cuda - cpu| and the largest |cuda - cpu| - rtol * |cpu|."""
    import numpy as np
    from hemx_torch import convert
    (_, (p_gpu, s_gpu), _, _), (_, (p_cpu, s_cpu), _, _) = (out[str(dev)],
                                                            out["cpu"])
    worst_abs = worst_excess = 0.0
    for tree_gpu, tree_cpu in ((p_gpu, p_cpu), (s_gpu, s_cpu)):
        fg = convert.flatten_tree(tree_gpu)
        fc = convert.flatten_tree(tree_cpu)
        check(sorted(fg) == sorted(fc), "parameter trees differ")
        for k in fc:
            _close(fg[k], fc[k], rtol, atol, "/".join(k))
            diff = np.abs(fg[k] - fc[k])
            worst_abs = max(worst_abs, float(diff.max()))
            worst_excess = max(worst_excess, float(
                (diff - rtol * np.abs(fc[k])).max()))
    return worst_abs, worst_excess


def phase_card_vs_cpu(torch, dev) -> None:
    args = _small_args(["--optimizer", "sgd", "--lr", "1e-3"])
    out = _one_call_each(torch, dev, args)
    (m_gpu, _, b_gpu, _), (m_cpu, _, b_cpu, _) = out[str(dev)], out["cpu"]
    for a, b in zip(b_gpu, b_cpu):
        check(torch.equal(a, b), "cuda and cpu batches differ")
    for k in m_cpu:
        _close(m_gpu[k], m_cpu[k], 5e-4, 1e-5, k)
    _compare_trees(out, dev, 2e-3, 2e-5)
    print(f"card vs cpu (32px, latent 16, batch 8, highest, sgd): losses "
          f"cuda {m_gpu} cpu {m_cpu}; params and BN stats agree", flush=True)


def hemx_bf16_dtypes(torch, nets) -> dict:
    """The output dtype of each layer under hemx's bf16 policy
    (``hemx/ops/layers.py:78-83,274-300,391-401,450-451,508-509``): a
    conv/deconv/dense outputs bf16 unless BN follows it (``+ beta`` in f32
    makes it f32); a layer without parameters keeps its input's dtype."""
    from hemx_torch.ops.layers import BatchNorm
    want = {}
    for net in ("generator", "discriminator"):
        cur = None
        for name, layer in nets[net].named_children():
            if any(True for _ in layer.parameters()):
                bn = any(isinstance(m, BatchNorm) for m in layer.modules())
                cur = torch.float32 if bn else torch.bfloat16
            want[f"{net}/{name}"] = cur
    return want


def phase_bf16_card_vs_cpu(torch, dev) -> None:
    from hemx_torch.models.gan import IwganModel
    args = _small_args(["--dtype", "bfloat16", "--optimizer", "rmsprop"])
    check(args.decay == 0.9 and args.momentum == 0.01,
          f"rmsprop defaults decay {args.decay} momentum {args.momentum}")
    out = _one_call_each(torch, dev, args, hooks=True)
    (m_gpu, _, b_gpu, t_gpu), (m_cpu, _, b_cpu, t_cpu) = (out[str(dev)],
                                                          out["cpu"])
    want = hemx_bf16_dtypes(torch, IwganModel(args, "cpu").init_state(
        (3, 32, 32), 0).nets)
    check(t_gpu == t_cpu == want,
          f"layer output dtypes: cuda {t_gpu}, cpu {t_cpu}, hemx {want}")
    check(torch.bfloat16 in want.values(), "no layer computed in bf16")
    for a, b in zip(b_gpu, b_cpu):
        check(torch.equal(a, b), "cuda and cpu batches differ")
    for k in m_cpu:
        _close(m_gpu[k], m_cpu[k], 3e-2, 0.0, k)
    worst_abs, worst_excess = _compare_trees(out, dev, 1e-2, 1e-4)
    print(f"card vs cpu, bf16 + rmsprop (decay 0.9, momentum 0.01): layer "
          f"dtypes equal and hemx's ({sum(v == torch.bfloat16 for v in want.values())} "
          f"of {len(want)} layers bf16); losses cuda {m_gpu} cpu {m_cpu} "
          f"(rtol 3e-2); params and BN stats within rtol 1e-2 / atol 1e-4: "
          f"max |cuda-cpu| {worst_abs:.3g}, atol needed at rtol 1e-2 "
          f"{max(worst_excess, 0.0):.3g}", flush=True)


def expected_launches(per_epoch: int, group: int, consumed: int) -> int:
    """Launches of the input kernel while a stream yields ``consumed``
    batches: one per full group, one per epoch-tail batch."""
    launches = got = 0
    while got < consumed:
        for _ in range(per_epoch // group):
            if got < consumed:
                launches, got = launches + 1, got + group
        for _ in range(per_epoch % group):
            if got < consumed:
                launches, got = launches + 1, got + 1
    return launches


# the headline IWGAN's flags beside the model's own (BASELINE widths)
IWGAN_FLAGS = ["--n_disc_train", "5", "--optimizer", "adam", "--lr", "1e-4",
               "--beta1", "0.5", "--beta2", "0.9"]


def full_width_argv(dev, workdir: str, *, count: int, eval_count: int,
                    image: int, batch: int, latent: int,
                    model: str = "iwgan", flags=IWGAN_FLAGS) -> list:
    return ["--model", model, "--dataset", "synthetic", "--synthetic_u8",
            "--synthetic_count", str(count),
            "--synthetic_eval_count", str(eval_count),
            "--synthetic_shape", str(image), str(image), "3",
            "--batch_size", str(batch), "--latent_size", str(latent),
            *flags, "--device", str(dev), "--dir", workdir, "--seed", "0"]


def run_launches(count: int, eval_count: int, batch: int, calls: int,
                 group: int = 6) -> int:
    """Input-kernel launches of one ``cli.run`` of one epoch of ``calls``
    calls of ``group`` batches: the train stream, the summary batch, and one
    per validation batch."""
    return (expected_launches(count // batch, group, calls * group) + 1
            + eval_count // batch)


def synthetic_run(dev, *, count: int = 4096, eval_count: int = 1024,
                  image: int = 64):
    """A ``cli.run`` on one set of the synthetic splits
    :func:`full_width_argv` asks for, made once: phases 4, 6 and 8 train
    on them (each run would draw its 5,120 images on the host again). A
    run starts with none of an earlier run's device pipelines."""
    from hemx_torch import cli
    from hemx_torch.config import parse_args
    from hemx_torch.data.plugin import get_dataset_tensors
    splits = get_dataset_tensors(parse_args(full_width_argv(
        dev, "", count=count, eval_count=eval_count, image=image, batch=1,
        latent=1)))

    def run(argv):
        for split in splits.values():
            split.release_device_pipelines()
        return cli.run(argv, splits)
    run.splits = splits
    return run


def phase_full_width(torch, dev, card: str, workdir: str, run, *,
                     count: int = 4096, eval_count: int = 1024,
                     image: int = 64, batch: int = 512, latent: int = 200,
                     calls: int = 8) -> int:
    from hemx_torch.models.gan import IwganModel
    from hemx_torch.ops import input_kernels as K

    argv = full_width_argv(dev, workdir, count=count, eval_count=eval_count,
                           image=image, batch=batch, latent=latent)
    argv += ["--epochs", "1", "--epoch_size", str(calls)]
    K.reset_launches()
    res = run(argv)
    launches = K.LAUNCHES["gather_u8_normalize"]
    ts, hist, pipe = res["train_state"], res["history"], res["pipeline"]
    check(ts.step == calls, f"step {ts.step} != {calls}")
    check(all(math.isfinite(r[k]) for r in hist for k in ("g_loss", "d_loss")),
          f"non-finite loss in {hist}")
    want = run_launches(count, eval_count, batch, calls)
    check(launches == want, f"input kernel launched {launches} times, "
                            f"expected {want}")
    check(all(p.device == dev for p in ts.nets.parameters()),
          f"a parameter is not on {dev}")
    check(all(v.device == dev for v in pipe.ds.values()),
          f"the dataset is not on {dev}")
    check(all(b["image"].device == dev for b in pipe.epoch(0)),
          f"a batch is not on {dev}")
    init = IwganModel(res["args"], "cpu").init_state((3, image, image),
                                                     res["args"].seed)
    for net in ("generator", "discriminator"):
        moved = max((a.detach().cpu() - b).abs().max().item() for a, b in zip(
            ts.nets[net].parameters(), init.nets[net].parameters()))
        check(moved > 0, f"{net} params did not change")
    s = res["summary"]
    print(f"IWGAN bs{batch} {image}x{image}x3 latent {latent}, {calls} train "
          f"calls on {card}: "
          f"first call {s['first_call_s']:.4f} s, median call "
          f"{s['median_call_s']:.4f} s, {s['images_per_s']:.1f} images/s "
          f"(calls 2-{calls}, calls x {batch} / seconds); d_loss "
          f"{[round(r['d_loss'], 4) for r in hist]}", flush=True)
    return launches


def expected_summary_steps(batches: int, start_epoch: int, epochs: int,
                           start_step: int, freq: int = 0) -> set:
    """Steps of the train summaries with losses: hemx's cadence, 10 per
    epoch for the first 3 epochs, then 3 (``freq`` per epoch when
    ``--summary_freq`` sets it), plus each epoch's end
    (``hemx/train/loop.py:186-234``)."""
    steps, step = set(), start_step
    for epoch in range(start_epoch, start_epoch + epochs):
        cadence = max(batches // (freq or (10 if epoch < 3 else 3)), 1)
        for i in range(batches):
            step += 1
            if i % cadence == 0:
                steps.add(step)
        steps.add(step)
    return steps


def _trees_equal(a: dict, b: dict) -> bool:
    import numpy as np
    from hemx_torch import convert
    fa, fb = convert.flatten_tree(a), convert.flatten_tree(b)
    return fa.keys() == fb.keys() and all(
        np.asarray(fa[k]).dtype == np.asarray(fb[k]).dtype
        and np.array_equal(fa[k], fb[k]) for k in fa)


def run_and_resume(torch, dev, workdir: str, argv: list, calls: int,
                   group: int, count: int, eval_count: int,
                   batch: int, *, run=None, dtype: str = "bfloat16",
                   keys: int = 1, eval_tags=None, bn_input=None,
                   image: int = 0) -> dict:
    """``run(argv)`` (default ``cli.run``) for one epoch of ``calls`` calls
    with ``--max_to_keep 2``, then ``--epochs +1`` on the same ``--dir``,
    with the input kernel's counts set to 0 just before and read just
    after. Checks checkpoints 0 and 1 after the first run; the second
    resumes at step ``calls`` from checkpoint 1 (restore bit-exact) and ends
    at step ``2 * calls`` with checkpoints {1, 2}; every loss finite in the
    history and in the train and validate events at the expected steps
    (validation writes ``eval_tags``, default the train losses but
    ``grad_norm``); in ``dtype`` on the card: every conv and deconv product
    (and with it each layer without BN's output) and every BN input; the
    launch count, one per ``keys`` uint8 keys. ``bn_input``: the BN
    inputs' dtype where it is not ``dtype`` (pix2pix's nets add the f32
    bias to a bf16 product uncast, as hemx's do). ``image``: the input
    side when the dataset is not synthetic. Returns both runs' results and
    the launches."""
    from hemx_torch import cli, convert
    from hemx_torch.models.plugin import get_model
    from hemx_torch.ops import input_kernels as K
    from hemx_torch.ops import layers
    from hemx_torch.ops.layers import BatchNorm, Conv2d
    from hemx_torch.summaries.reader import get_all_events, get_tag_values
    from hemx_torch.train.checkpoint import CheckpointManager

    run = run or cli.run
    argv = argv + ["--dtype", dtype, "--epoch_size", str(calls),
                   "--max_to_keep", "2"]
    seen = {"conv2d output": set(), "conv/deconv product": set(),
            "batch_norm input": set()}

    def post(m, inp, out):
        # a conv with BN outputs f32 by hemx's policy (BN's f32 beta); its
        # bf16 product is the BN input the pre-hook sees
        if (isinstance(m, Conv2d) and not hasattr(m, "norm0")
                and out[0].device.type == dev.type):
            seen["conv2d output"].add(out[0].dtype)

    def pre(m, inp):
        if isinstance(m, BatchNorm) and inp[0].device.type == dev.type:
            seen["batch_norm input"].add(inp[0].dtype)

    def recording(op):
        def wrapped(*a, **kw):
            y = op(*a, **kw)
            if y.device.type == dev.type:
                seen["conv/deconv product"].add(y.dtype)
            return y
        return wrapped

    ops = {n: getattr(layers, n) for n in ("conv2d_op", "deconv2d_op")}
    for n, op in ops.items():
        setattr(layers, n, recording(op))
    hooks = [torch.nn.modules.module.register_module_forward_hook(post),
             torch.nn.modules.module.register_module_forward_pre_hook(pre)]
    K.reset_launches()
    try:
        res1 = run(argv + ["--epochs", "1"])
        manager = CheckpointManager(workdir)
        check([e for e, _ in manager.checkpoints()] == [0, 1],
              f"after the first run: checkpoints {manager.checkpoints()}")
        ckpt1 = manager.restore(manager.checkpoints()[-1][1])
        check(_trees_equal(ckpt1, convert.to_checkpoint(res1["train_state"], 1)),
              "checkpoint-1 differs from the first run's final state")
        res2 = run(argv + ["--epochs", "+1"])
    finally:
        for h in hooks:
            h.remove()
        for n, op in ops.items():
            setattr(layers, n, op)
    launches = K.LAUNCHES["gather_u8_normalize"]
    args = res2["args"]
    ts = res2["train_state"]
    r = res2["resumed"]
    check(r is not None and r["epoch"] == 1 and r["step"] == calls
          and r["path"].endswith("checkpoint-1.msgpack"),
          f"{args.model}: second run resumed from {r}")
    image = image or args.synthetic_shape[0]
    fresh = get_model(args.model)(args, dev).init_state((3, image, image), 0)
    check(convert.load_checkpoint(fresh, ckpt1) == 1
          and _trees_equal(convert.to_checkpoint(fresh, 1), ckpt1),
          f"{args.model}: restoring checkpoint-1 is not bit-exact (weights, "
          f"BN stats, optimizer moments, step, key)")
    check(ts.step == 2 * calls and res2["epoch"] == 2,
          f"{args.model}: second run ended at step {ts.step}, epoch "
          f"{res2['epoch']}")
    ckpts = [e for e, _ in manager.checkpoints()]
    check(ckpts == [1, 2], f"{args.model}: after gc: checkpoints {ckpts}")
    hist = res1["history"] + res2["history"]
    losses = sorted(k for k in hist[0] if k != "seconds")
    check(len(hist) == 2 * calls and all(
        math.isfinite(h[k]) for h in hist for k in losses),
        f"{args.model}: calls {len(hist)}, non-finite loss in {hist}")
    want = {"train": (expected_summary_steps(calls, 0, 2, 0,
                                             args.summary_freq), losses),
            "validate": ({calls, 2 * calls},
                         eval_tags or [k for k in losses if k != "grad_norm"])}
    for phase, (steps, tags) in want.items():
        events = get_all_events(os.path.join(workdir, phase))
        for tag in tags:
            got = get_tag_values("", f"losses/{tag}", events)
            check({s for s, _ in got} == steps,
                  f"{args.model} {phase} losses/{tag} at steps "
                  f"{[s for s, _ in got]}, expected {sorted(steps)}")
            check(all(math.isfinite(v) for _, v in got),
                  f"{args.model} {phase} losses/{tag} not finite: {got}")
    has_bn = any(isinstance(m, BatchNorm) for m in ts.nets.modules())
    want_dtype = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    want_seen = {"conv2d output": ({want_dtype} if any(
                     isinstance(m, Conv2d) for m in ts.nets.modules())
                     else set()),
                 "conv/deconv product": {want_dtype},
                 "batch_norm input": ({bn_input or want_dtype} if has_bn
                                      else set())}
    check(seen == want_seen,
          f"{args.model}: compute dtypes on the card: {seen}, expected "
          f"{want_seen}")
    want_launches = 2 * keys * run_launches(count, eval_count, batch, calls,
                                            group)
    check(launches == want_launches,
          f"{args.model}: input kernel launched {launches} times, expected "
          f"{want_launches}")
    secs = [h["seconds"] for h in hist]
    steady = secs[1:calls] + secs[calls + 1:]
    return {"res1": res1, "res2": res2, "launches": launches, "secs": secs,
            "median_s": statistics.median(steady), "steady": len(steady),
            "losses": losses}


def phase_bf16_run(torch, dev, card: str, workdir: str, run, *,
                   count: int = 4096,
                   eval_count: int = 1024, image: int = 64, batch: int = 512,
                   latent: int = 200, calls: int = 6) -> int:
    from hemx_torch.summaries import crc32c as C

    argv = full_width_argv(dev, workdir, count=count, eval_count=eval_count,
                           image=image, batch=batch, latent=latent)
    out = run_and_resume(torch, dev, workdir, argv, calls, 6, count,
                         eval_count, batch, run=run)
    t, t2 = out["res1"]["timings"], out["res2"]["timings"]
    crc_data = bytes(range(256)) * 4096  # 1 MiB
    crc_s, crcs = {}, {}
    for name, fn in (("native", C.crc32c), ("plain", C._py_crc32c)):
        t0 = time.perf_counter()
        crcs[name] = fn(crc_data)
        crc_s[name] = time.perf_counter() - t0
    check(crcs["native"] == crcs["plain"],
          f"crc32c of 1 MiB: native {crcs['native']:#x}, plain "
          f"{crcs['plain']:#x}")
    secs, med = out["secs"], out["median_s"]
    print(f"IWGAN bf16 bs{batch} {image}x{image}x3 latent {latent}, 5+1, Adam, "
          f"2 runs of {calls} calls on {card}: first calls "
          f"{secs[0]:.4f} / {secs[calls]:.4f} s, median call {med:.4f} s "
          f"({out['steady']} steady calls), {batch / med:.1f} images/s; "
          f"resumed at step {out['res2']['resumed']['step']}, ended at step "
          f"{out['res2']['train_state'].step}", flush=True)
    print(f"checkpoint {t['checkpoint_bytes'][-1]} bytes; save s "
          f"{[round(x, 4) for x in t['save_s'] + t2['save_s']]}; restore s "
          f"{[round(x, 4) for x in t2['restore_s']]}; summary write s median "
          f"{statistics.median(t['summary_s'] + t2['summary_s']):.4f} "
          f"(n={len(t['summary_s'] + t2['summary_s'])}); crc32c of 1 MiB "
          f"{crc_s['native']:.6f} s native (C++), {crc_s['plain']:.4f} s "
          f"plain (Python), {crc_s['plain'] / crc_s['native']:.0f}x",
          flush=True)
    return out["launches"], med


# (model, batch, train-call group, flags): BASELINE's widths and optimizers
ZOO = [("gan", 512, 1, ["--optimizer", "rmsprop", "--lr", "2.5e-5"]),
       ("wgan", 512, 6, ["--n_disc_train", "5", "--optimizer", "rmsprop",
                         "--lr", "2.5e-5"]),
       ("cnn", 1024, 1, ["--optimizer", "rmsprop", "--lr", "1e-4"]),
       ("vae", 512, 1, ["--optimizer", "rmsprop", "--lr", "1e-3"])]


def phase_zoo_card_vs_cpu(torch, dev) -> None:
    """Phase 3's check for the other BASELINE models: one call on the card
    and on the CPU (32 px, latent 16, batch 8, highest, sgd, 2 critic steps
    for the WGAN); losses rtol 5e-4 / atol 1e-5, ``grad_norm``, params
    and BN stats rtol 2e-3 / atol 2e-5. The VAE's losses are sums over B*H*W*C (24,576
    values here), not means, and its gradients are that much larger; a
    parameter's card-vs-CPU difference after sgd is lr times its
    gradient's, so the VAE steps at lr 1e-5 (at 1e-4 the encoder's first
    kernel differed by 3.44e-5, over the atol)."""
    for name in ("gan", "wgan", "cnn", "vae"):
        lr = "1e-5" if name == "vae" else "1e-3"
        args = _small_args(["--optimizer", "sgd", "--lr", lr], model=name,
                           n_disc_train=2)
        out = _one_call_each(torch, dev, args)
        (m_gpu, _, b_gpu, _), (m_cpu, _, b_cpu, _) = out[str(dev)], out["cpu"]
        for a, b in zip(b_gpu, b_cpu):
            check(torch.equal(a, b), f"{name}: cuda and cpu batches differ")
        check(set(m_gpu) == set(m_cpu), f"{name}: metrics {m_gpu} vs {m_cpu}")
        need = {}
        for k in m_cpu:
            # grad_norm is a statistic of the gradient, which the
            # parameters' tolerance holds (the sgd step is lr * grad)
            rtol, atol = (2e-3, 2e-5) if k == "grad_norm" else (5e-4, 1e-5)
            _close(m_gpu[k], m_cpu[k], rtol, atol, f"{name} {k}")
            need[k] = abs(m_gpu[k] - m_cpu[k]) / max(abs(m_cpu[k]), 1e-30)
        worst_abs, worst_excess = _compare_trees(out, dev, 2e-3, 2e-5)
        print(f"card vs cpu, {name} (32px, latent 16, batch 8, highest, sgd "
              f"{lr}): metrics cuda {m_gpu} cpu {m_cpu}, relative "
              f"difference (the rtol each needed) "
              + ", ".join(f"{k} {v:.3g}" for k, v in need.items())
              + f"; params and BN stats max |cuda-cpu| {worst_abs:.3g}, "
              f"atol needed at rtol 2e-3 {max(worst_excess, 0.0):.3g}",
              flush=True)


def phase_zoo_bf16_runs(torch, dev, card: str, workdir: str, run, *,
                        count: int = 4096, eval_count: int = 1024,
                        image: int = 64, latent: int = 200,
                        calls: int = 4) -> dict:
    """Each other BASELINE model at full width in bf16 through the CLI, one
    epoch of ``calls`` calls and then ``--epochs +1``
    (:func:`run_and_resume`). Returns {model: input-kernel launches}."""
    launches = {}
    for name, batch, group, flags in ZOO:
        d = os.path.join(workdir, name)
        argv = full_width_argv(dev, d, count=count, eval_count=eval_count,
                               image=image, batch=batch, latent=latent,
                               model=name, flags=flags)
        out = run_and_resume(torch, dev, d, argv, calls, group, count,
                             eval_count, batch, run=run)
        launches[name] = out["launches"]
        med = out["median_s"]
        last = out["res2"]["history"][-1]
        print(f"{name} bf16 bs{batch} {image}x{image}x3 latent {latent}, "
              f"{' '.join(flags)}, 2 runs of {calls} calls on {card}: first "
              f"calls {out['secs'][0]:.4f} / {out['secs'][calls]:.4f} s, "
              f"median call {med:.4f} s ({out['steady']} steady calls), "
              f"{batch / med:.1f} images/s (calls x {batch} / seconds, as "
              f"bench.py counts); resumed at step {out['res2']['resumed']['step']}, "
              f"ended at step {out['res2']['train_state'].step}; "
              f"checkpoints {{1, 2}}; {out['launches']} input-kernel "
              f"launches; last call " + ", ".join(
                  f"{k} {last[k]:.6g}" for k in out["losses"]), flush=True)
    return launches


def floorplan_image(rng, size: int):
    """A floorplan-like RGB drawing: pale rooms with dark walls on white."""
    import numpy as np
    img = np.full((size, size, 3), 255, np.uint8)
    for _ in range(int(rng.integers(4, 9))):
        y0, x0 = rng.integers(0, size - 16, 2)
        h, w = rng.integers(12, size // 2, 2)
        y1, x1 = min(y0 + h, size), min(x0 + w, size)
        img[y0:y1, x0:x1] = rng.integers(190, 256, 3)
        for ys, xs in ((slice(y0, y0 + 2), slice(x0, x1)),
                       (slice(y1 - 2, y1), slice(x0, x1)),
                       (slice(y0, y1), slice(x0, x0 + 2)),
                       (slice(y0, y1), slice(x1 - 2, x1))):
            img[ys, xs] = 40
    return img


def write_floorplan_raw(raw: str, counts: dict, size: int, seed: int) -> int:
    """A raw floorplan directory: ``counts[split]`` RGB PNGs of size x size
    (row y with PNG filter y % 5) and the three list files. Returns the
    PNG bytes written."""
    import numpy as np
    lists = {"train": "train_set.txt", "validate": "validation_set.txt",
             "test": "test_set.txt"}
    rng = np.random.default_rng(seed)
    total = 0
    os.makedirs(raw, exist_ok=True)
    for split, n in counts.items():
        names = [f"{split}_{i:05d}.png" for i in range(n)]
        for name in names:
            data = png_bytes(floorplan_image(rng, size))
            total += len(data)
            with open(os.path.join(raw, name), "wb") as f:
                f.write(data)
        with open(os.path.join(raw, lists[split]), "w") as f:
            f.write("\n".join(names) + "\n")
    return total


def write_nyuv2_raw(raw: str, counts: dict, h: int, w: int, seed: int) -> None:
    """NYUv2-format frames: ``<frame>_i.png`` RGB and ``<frame>_f.png``
    16-bit grey depth in [2000, 50000], smooth scenes; frame 0 of each
    split has a sensor gap (a depth of 0), which the plugin drops."""
    import numpy as np
    lists = {"train": "train.txt", "validate": "validation.txt",
             "test": "test.txt"}
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    os.makedirs(raw, exist_ok=True)
    for split, n in counts.items():
        frames = [f"{split}_{i:04d}" for i in range(n)]
        for i, frame in enumerate(frames):
            g = rng.uniform(-1, 1, (2, 3))
            rgb = 128 + 60 * (g[0] * (yy / h)[..., None]
                              + g[1] * (xx / w)[..., None])
            depth = 2000 + 48000 * (0.5 + 0.25 * (rng.uniform(-1, 1)
                                                  * yy / h + rng.uniform(
                                                      -1, 1) * xx / w))
            for _ in range(3):
                y0, x0 = rng.integers(0, h - 20), rng.integers(0, w - 20)
                rgb[y0:y0 + 20, x0:x0 + 20] = rng.integers(0, 256, 3)
                depth[y0:y0 + 20, x0:x0 + 20] = rng.uniform(2000, 50000)
            depth = depth.astype(np.uint16)
            if i == 0:
                depth[h // 2, w // 2] = 0
            with open(os.path.join(raw, frame + "_i.png"), "wb") as f:
                f.write(png_bytes(np.clip(rgb, 0, 255).astype(np.uint8)))
            with open(os.path.join(raw, frame + "_f.png"), "wb") as f:
                f.write(png_bytes(depth))
        with open(os.path.join(raw, lists[split]), "w") as f:
            f.write("\n".join(frames) + "\n")


def decode_costs(raw: str, size: int, n: int = 256) -> None:
    """Host ms per image of the floorplan parse's parts, on ``n`` of the
    raw PNGs: decode when every row is filtered None (inflate and the
    vectorised path only), decode with rows filtered y % 5 (as written),
    and the 64x64 resize."""
    from hemx_torch.data.imageio import decode_image, resize_bilinear
    names = sorted(f for f in os.listdir(raw)
                   if f.startswith("train_") and f.endswith(".png"))[:n]
    files = []
    for name in names:
        with open(os.path.join(raw, name), "rb") as f:
            files.append(f.read())
    imgs = [decode_image(d) for d in files]
    plain = [png_bytes(im, [0] * size) for im in imgs]
    ms = {}
    for label, fn, items in (
            ("decode, filter None", decode_image, plain),
            ("decode, filters y % 5", decode_image, files),
            ("resize to 64x64", lambda im: resize_bilinear(im, 64, 64),
             imgs)):
        t0 = time.perf_counter()
        for item in items:
            fn(item)
        ms[label] = (time.perf_counter() - t0) / len(items) * 1e3
    print(f"host parse of a {size}x{size} floorplan PNG, ms per image over "
          f"{len(files)}: " + ", ".join(f"{k} {v:.3f}" for k, v in ms.items()),
          flush=True)


def stream_groups(per_epoch: int, group: int, consumed: int) -> list:
    """The batch groups the streaming Pipeline sends while a stream yields
    ``consumed`` batches, by size: ``group`` batches each, the epoch's
    tail group shorter; a group is copied and normalized (one input-kernel
    launch) when its first batch is drawn."""
    sizes, got = [], 0
    while got < consumed:
        left = per_epoch
        while left and got < consumed:
            sizes.append(min(group, left))
            got, left = got + sizes[-1], left - sizes[-1]
    return sizes


def check_native_build() -> None:
    """The records' CRCs and reads went through the build of phase 1."""
    from hemx_torch import native
    path = native.load().__file__
    check(os.path.dirname(path) == native.BUILD_DIR,
          f"hemx_torch.native loaded from {path}, not from "
          f"{native.BUILD_DIR}")


def phase_data(torch, dev, card: str, workdir: str, *, size: int = 128,
               counts=(4096, 512, 512), batch: int = 512, calls: int = 6,
               nyu_counts=(384, 65, 63), nyu_batch: int = 64,
               nyu_calls: int = 4) -> dict:
    """The data layer at full width: raw floorplan PNGs -> the plugin's
    records -> IWGAN bf16 through ``cli.run`` on the device cache (a) and
    streaming (b); then NYUv2 frames -> the CNN on random crops
    (streaming: the split has a host transform). Returns the input kernel's
    launches of each run."""
    from hemx_torch import cli
    from hemx_torch.config import parse_args
    from hemx_torch.data.pipeline import DeviceDataPipeline, Pipeline
    from hemx_torch.data.plugin import get_dataset, get_dataset_tensors
    from hemx_torch.ops import input_kernels as K

    raw, store = os.path.join(workdir, "raw"), os.path.join(workdir, "store")
    split_counts = dict(zip(("train", "validate", "test"), counts))
    t0 = time.perf_counter()
    png_total = write_floorplan_raw(raw, split_counts, size, seed=0)
    write_s = time.perf_counter() - t0
    plugin = get_dataset("floorplan")
    t0 = time.perf_counter()
    plugin.convert_to_tfrecord(raw, os.path.join(store, "floorplan"))
    convert_s = time.perf_counter() - t0
    record_bytes = sum(os.path.getsize(os.path.join(store, "floorplan", f))
                       for f in os.listdir(os.path.join(store, "floorplan")))
    check_native_build()
    print(f"floorplan raw: {sum(counts)} RGB PNGs of {size}x{size} (rows "
          f"filtered y % 5), {png_total} bytes, written in {write_s:.2f} s; "
          f"converted by the plugin to {record_bytes} bytes of records in "
          f"{convert_s:.2f} s ({sum(counts) / convert_s:.1f} images/s) "
          f"through hemx_torch.native's CRC-32C (1.97-2.29 s with the "
          f"pure-Python CRC-32C, PERF.md)", flush=True)

    argv = ["--model", "iwgan", "--dataset", "floorplan", "--raw_dataset_dir",
            raw, "--dataset_dir", store, "--batch_size", str(batch),
            "--latent_size", "200", *IWGAN_FLAGS, "--dtype", "bfloat16",
            "--epochs", "1", "--epoch_size", str(calls), "--device", str(dev),
            "--seed", "0"]
    runs, launches = {}, {}
    # both runs train on one materialization of the records (the decode
    # is timed once, by the first run)
    splits = get_dataset_tensors(parse_args(argv + ["--dir", workdir]))
    for name, extra in (("cached", []), ("streaming",
                                         ["--no-device_data_cache"])):
        K.reset_launches()
        runs[name] = cli.run(argv + ["--dir", os.path.join(workdir, name)]
                             + extra, splits=splits)
        launches[name] = K.LAUNCHES["gather_u8_normalize"]
    a, b = runs["cached"], runs["streaming"]
    check(isinstance(a["pipeline"], DeviceDataPipeline)
          and isinstance(b["pipeline"], Pipeline),
          f"feeders {type(a['pipeline'])}, {type(b['pipeline'])}")
    b["pipeline"].drain()
    h2d_bytes, h2d_s = b["pipeline"].h2d_bytes, b["pipeline"].h2d_s
    stage_s = b["pipeline"].stage_s
    per_epoch, consumed = counts[0] // batch, calls * 6
    groups = stream_groups(per_epoch, 6, consumed)
    # + the summary batch and one per validation batch
    want = {"cached": expected_launches(per_epoch, 6, consumed) + 1
            + counts[1] // batch,
            "streaming": len(groups) + 1 + counts[1] // batch}
    for name, res in runs.items():
        hist = res["history"]
        check(res["train_state"].step == calls and res["resumed"] is None,
              f"{name}: step {res['train_state'].step}, resumed "
              f"{res['resumed']}")
        check(all(math.isfinite(r[k]) for r in hist
                  for k in ("g_loss", "d_loss")), f"{name}: losses {hist}")
        check(launches[name] == want[name],
              f"{name}: input kernel launched {launches[name]} times, "
              f"expected {want[name]}")
    check(h2d_bytes == sum(groups) * batch * 64 * 64 * 3,
          f"streamed {h2d_bytes} bytes over H2D, expected groups {groups}")
    compared = 0
    for e in range(2):
        got = list(b["pipeline"].epoch(e))
        ref = list(a["pipeline"].epoch(e))
        check(len(got) == len(ref) == per_epoch,
              f"epoch {e}: {len(got)} streamed, {len(ref)} cached batches")
        for g, r in zip(got, ref):
            check(g["image"].device == r["image"].device == dev
                  and torch.equal(g["image"], r["image"]),
                  f"epoch {e}: a streamed batch differs from the cached one")
            compared += 1
    mat = {n: r["timings"]["materialize_s"] for n, r in runs.items()}
    for name, res in runs.items():
        s = res["summary"]
        secs = [round(r["seconds"], 4) for r in res["history"]]
        print(f"IWGAN bf16 from floorplan records ({name}), bs{batch} 64x64x3 "
              f"latent 200, 5+1, Adam, {calls} calls on {card}: first call "
              f"{s['first_call_s']:.4f} s, median call "
              f"{s['median_call_s']:.4f} s, {s['images_per_s']:.1f} images/s "
              f"(calls 2-{calls}); host materialization of the train split "
              f"{mat[name]:.2f} s = {counts[0] / mat[name]:.1f} images/s "
              f"decoded and resized; {launches[name]} input-kernel launches "
              f"(expected {want[name]}); calls s {secs}", flush=True)
    print(f"streaming H2D: {h2d_bytes} bytes in {h2d_s * 1e3:.3f} ms of "
          f"CUDA-event time over {len(groups)} pinned group copies "
          f"(groups of {groups}) = {h2d_bytes / h2d_s / 1e9:.2f} GB/s on "
          f"{card}; filling the pinned buffers took {stage_s * 1e3:.2f} ms "
          f"on the host ({h2d_bytes / stage_s / 1e9:.2f} GB/s); {compared} "
          f"streamed batches over 2 data epochs equal the cached ones bit "
          f"for bit on the card", flush=True)
    decode_costs(raw, size)

    nyu_raw = os.path.join(workdir, "nyu_raw")
    nyu = dict(zip(("train", "validate", "test"), nyu_counts))
    write_nyuv2_raw(nyu_raw, nyu, 120, 160, seed=1)
    nyu_argv = ["--model", "cnn", "--dataset", "nyuv2", "--raw_dataset_dir",
                nyu_raw, "--dataset_dir", store, "--random_crop", "64", "64",
                "--batch_size", str(nyu_batch), "--latent_size", "200",
                "--optimizer", "rmsprop", "--lr", "1e-4", "--dtype",
                "bfloat16", "--epochs", "1", "--epoch_size", str(nyu_calls),
                "--device", str(dev), "--dir", os.path.join(workdir, "nyu"),
                "--seed", "0"]
    K.reset_launches()
    n = cli.run(nyu_argv)
    launches["nyuv2"] = K.LAUNCHES["gather_u8_normalize"]
    check(isinstance(n["pipeline"], Pipeline), "nyuv2 did not stream")
    check(n["train_state"].step == nyu_calls and n["resumed"] is None
          and all(math.isfinite(r["loss"]) for r in n["history"]),
          f"nyuv2: step {n['train_state'].step}, history {n['history']}")
    check(launches["nyuv2"] == 0,
          f"nyuv2's float images launched the u8 kernel {launches['nyuv2']}x")
    cpu_splits = get_dataset("nyuv2").get_datasets(n["args"])
    got_counts = {k: s.count for k, s in cpu_splits.items()}
    check(got_counts == {k: v - 1 for k, v in nyu.items()},
          f"nyuv2 split sizes {got_counts}: the gap frames were not dropped")
    first = next(n["pipeline"].epoch(0))["image"]
    host = next(cpu_splits["train"].iter_epoch(nyu_batch, seed=0, epoch=0))
    check(first.device == dev and torch.equal(
        first.cpu(), torch.from_numpy(host["image"]).permute(0, 3, 1, 2)),
        "the first streamed NYUv2 batch differs from the CPU split's")
    s = n["summary"]
    nm = n["timings"]["materialize_s"]
    print(f"CNN bf16 on NYUv2 64x64 crops of 120x160 frames, bs{nyu_batch}, "
          f"rmsprop, {nyu_calls} calls streaming on {card}: median call "
          f"{s['median_call_s']:.4f} s, {s['images_per_s']:.1f} images/s; "
          f"splits {got_counts} after the gap filter; host materialization "
          f"{nm:.2f} s = {got_counts['train'] / nm:.1f} frames/s (RGB + "
          f"16-bit depth decoded); first streamed batch equals the CPU "
          f"split's", flush=True)
    return launches


# phase 10: (model, batch, flags) run on the card and on the CPU
DEPTH_CARD_VS_CPU = (
    [("paper_cgan", 4, ["--model_version", v, "--training_version", "gan"])
     for v in ("baseline", "mean_adjusted", "mean_provided",
               "mean_provided2")]
    + [("paper_cgan", 4, ["--model_version", "mean_adjusted",
                          "--training_version", "wgan"]),
       ("paper_standalone", 4, ["--model_version", "mean_provided"]),
       ("paper_sampler", 4, ["--noise_layer", "e2"]),
       ("paper_sampler", 4, ["--noise_layer", "d3"]),
       # batch 8: the late critic's BN acts on 1x1 maps, ill-conditioned over
       # 4 rows (its gradient norm moves by 4e-3 between two float32 sums)
       ("sampler_gan", 8, ["--garch", "large", "--darch", "late",
                           "--batch_norm_gen", "--batch_norm_disc"])])


def _depth_setup(torch, d, model_name: str, batch: int, flags, size: int,
                 compose: bool):
    """(args, model, train state, one call's batches) of a depth model on
    device ``d``, weights from the seed (drawn on the CPU, so equal on every
    device); with ``compose`` an experimental sampler composed with a
    mean-depth estimator made the same way."""
    from hemx_torch.config import parse_args
    from hemx_torch.data.pipeline import DeviceDataPipeline
    from hemx_torch.data.synthetic import SyntheticDataset
    from hemx_torch.models.plugin import get_model
    from hemx_torch.ops.layers import set_precision

    args = parse_args(["--model", model_name, "--dataset", "synthetic",
                       "--synthetic_u8", "--synthetic_count", "64",
                       "--synthetic_shape", str(size), str(size), "3",
                       "--batch_size", str(batch), "--precision", "highest",
                       "--seed", "0"] + flags)
    set_precision(args.precision)
    split = SyntheticDataset.get_datasets(args)["train"]
    model = get_model(model_name)(args, d)
    if compose:
        est = get_model("mean_depth_estimator")(args, d)
        model.set_estimator(est, est.init_state((3, size, size), args.seed))
    ts = model.init_state((3, size, size), args.seed)
    n = model.batches_per_train_call()
    pipe = DeviceDataPipeline(split, batch, device=d, keys=model.batch_keys,
                              seed=0, group=n)
    return args, model, ts, list(pipe.epoch(0))[:n]


def _seam(torch, model, ts, batches, seed: int = 1):
    """The seam noise of one train call and of a predict (drawn on the
    CPU), or (None, None) for a model without noise."""
    from hemx_torch.models.conditional import draw_noise
    if not (isinstance(ts.nets, torch.nn.ModuleDict)
            and "generator" in ts.nets):  # a standalone net, artist
        return None, None
    g = torch.Generator()
    g.manual_seed(seed)
    G = ts.nets["generator"]
    noise = [draw_noise(G, g, batches[min(i, len(batches) - 1)]["image"])
             for i in range(model.n_substeps())]
    return noise, draw_noise(G, g, batches[0]["image"])


def _depth_call_each(torch, dev, model_name: str, batch: int, flags,
                     size: int = 65, compose: bool = False) -> dict:
    """One train call of a depth model from the same weights, batches and
    seam noise on the CPU and on ``dev``, every optimizer replaced by sgd
    1e-3, then ``predict`` (an estimator's ``predict_mean``) on the first
    batch: {device: (metrics, (params, mstate), batches, Eigen scalars of
    the prediction or None)}."""
    from hemx_torch import convert
    from hemx_torch.metrics.eigen import eigen_metrics
    from hemx_torch.models.conditional import ConditionalGanBase
    from hemx_torch.train.optimizers import Optimizer, make_transform

    out, noise = {}, None
    for d in ("cpu", dev):
        _, model, ts, batches = _depth_setup(torch, d, model_name, batch,
                                             flags, size, compose)
        gan = isinstance(model, ConditionalGanBase)
        if noise is None:  # drawn once, on the CPU
            noise, pred_noise = _seam(torch, model, ts, batches)
        # sgd in place of the model's Adam / rmsprop, as phase 7 steps: a
        # parameter's card-vs-CPU difference is then lr times its
        # gradient's; Adam's first step, lr * g / (|g| + 1e-8), would turn
        # a 2e-8 difference in a near-zero gradient into 4.9e-5 of weight
        # (the models' own optimizers are held by _own_optimizer_on_card)
        sgd = make_transform(argparse.Namespace(optimizer="sgd", lr=1e-3))
        ts.opt = ({k: Optimizer(o.module, sgd) for k, o in ts.opt.items()}
                  if isinstance(ts.opt, dict)
                  else Optimizer(ts.opt.module, sgd))
        ts, metrics = model.train(ts, iter(batches), **(
            {"noise": noise} if noise is not None else {}))
        eig = None
        if gan:
            pred, prep = model.predict(ts, batches[0], noise=pred_noise)
            if model.depth_range() == (0.0, 10.0):  # meters: Eigen on /10
                eig = {k: float(v) for k, v in eigen_metrics(
                    (prep["y"] / 10.0).clamp(min=1e-3).cpu(),
                    (pred / 10.0).clamp(min=1e-3).cpu()).items()}
        elif hasattr(model, "predict_mean"):
            eig = {"predict_mean": model.predict_mean(ts, batches[0]).cpu()}
        out[str(d)] = ({k: float(v) for k, v in metrics.items()},
                       convert.to_jax(ts.nets),
                       [torch.cat([b["image"], b["depth"]], 1).cpu()
                        for b in batches], eig)
    return out


def _own_optimizer_on_card(torch, dev, model_name: str, batch: int, flags,
                           size: int = 65, compose: bool = False) -> float:
    """One train call on the card with the model's own optimizers (Adam
    for the models of this script's lists but sampler_gan, which keeps
    hemx's switch), each step's gradients recorded; then the CPU applies
    the same optax-exact transforms to those gradients, moved to the CPU,
    from the same start (and clips under ``wgan`` where the model does).
    The card's parameters must equal the CPU's within rtol 1e-5 of the
    summed |update| of their steps plus one float32 ulp of the parameter
    per step (each step's add may round to the other neighbour), and its
    optimizer moments at rtol 1e-5: the optimizer on the card, held apart
    from the gradient's rounding. Returns the largest relative update
    difference."""
    import copy

    import numpy as np
    from hemx_torch import convert
    from hemx_torch.train.optimizers import Optimizer, clip_params

    args, model, ts, batches = _depth_setup(torch, dev, model_name, batch,
                                            flags, size, compose)
    noise, _ = _seam(torch, model, ts, batches)
    opts = ts.opt if isinstance(ts.opt, dict) else {"": ts.opt}
    where = {id(m): n for n, m in ts.nets.named_modules()}
    cpu_nets = copy.deepcopy(ts.nets).cpu()
    before = {n: p.detach().clone() for n, p in cpu_nets.named_parameters()}

    def twin(module):
        """``module``'s copy in cpu_nets: a network of the state, or an
        optimizer's own ModuleDict over several (artist, info_gan's Q)."""
        if id(module) in where:
            return cpu_nets.get_submodule(where[id(module)])
        return torch.nn.ModuleDict({n: twin(c)
                                    for n, c in module.named_children()})
    cpu_opts = {k: Optimizer(twin(o.module), o.tx) for k, o in opts.items()}
    full_name = {id(p): n for n, p in cpu_nets.named_parameters()}
    steps = []
    for k, o in opts.items():
        def record(grads, k=k, real=o.step):
            steps.append((k, [g.detach().cpu().clone() for g in grads]))
            real(grads)
        o.step = record
    ts, _ = model.train(ts, iter(batches),
                        **({"noise": noise} if noise is not None else {}))
    wgan = getattr(model, "training_version", "gan") == "wgan"
    # per parameter: the sum of |update| over the steps and the steps taken
    moved = {n: np.zeros(p.shape) for n, p in cpu_nets.named_parameters()}
    taken = dict.fromkeys(moved, 0)
    for k, grads in steps:
        mod = cpu_opts[k].module
        old = {n: p.detach().clone() for n, p in mod.named_parameters()}
        cpu_opts[k].step(grads)
        if wgan and (k == "d" or getattr(model, "clip_generator", True)):
            clip_params(mod.parameters(), model.clip_value)
        for n, p in mod.named_parameters():
            moved[full_name[id(p)]] += (p.detach()
                                        - old[n]).abs().double().numpy()
            taken[full_name[id(p)]] += 1
    label = f"{model_name} {' '.join(flags)}"
    worst = 0.0
    for n, p in cpu_nets.named_parameters():
        got = dict(ts.nets.named_parameters())[n].detach().cpu().numpy()
        want = p.detach().numpy()
        # each step's add may round to the other neighbour once its update
        # differs in the last bit: one float32 ulp per step taken
        ulp = taken[n] * np.spacing(np.maximum(np.abs(want),
                                               np.abs(before[n].numpy())))
        err = np.abs(got.astype(np.float64) - want)
        check(bool(np.all(err <= 1e-5 * moved[n] + ulp)),
              f"{label}: the card's update of {n} is not the CPU "
              f"optimizer's on the card's gradients (max |diff| "
              f"{err.max():.3g})")
        rel = np.maximum(err - ulp, 0.0) / np.maximum(moved[n], 1e-30)
        worst = max(worst, float(rel.max()))
    for k, o in opts.items():
        got = convert.flatten_tree(convert.opt_state_to_jax(o))
        want = convert.flatten_tree(convert.opt_state_to_jax(cpu_opts[k]))
        check(got.keys() == want.keys(), f"{label}: optimizer state keys")
        for key in want:
            _close(got[key], want[key], 1e-5, 0.0, f"{label} opt {k} {key}")
    print(f"{label}: {len(steps)} steps of its own optimizer on the card; "
          f"the CPU's optax-exact transform on the card's gradients gives "
          f"the same updates (largest relative difference {worst:.3g}, "
          f"bound 1e-5) and moments", flush=True)
    return worst


def _compare_depth(torch, dev, label: str, out: dict, batch: int,
                   sparsity_n: int = 0) -> None:
    """Phase 7's check of one depth-model call on the card and the CPU:
    losses rtol 5e-4 / atol 1e-5; gradient norms, params, BN stats and the
    Eigen scalars (or predicted means) of the prediction rtol 2e-3 / atol
    2e-5. ``sparsity_n``: the entries of G's bottleneck, whose fraction of
    exact zeros (``sparsity_term``) may differ by 2 counts (a
    pre-activation near 0 may round to the other side), and ``g_loss``,
    which subtracts it, by that difference more."""
    import numpy as np
    (m_gpu, _, b_gpu, e_gpu), (m_cpu, _, b_cpu, e_cpu) = (out[str(dev)],
                                                          out["cpu"])
    for a, b in zip(b_gpu, b_cpu):
        check(torch.equal(a, b), f"{label}: cuda and cpu batches differ")
    check(set(m_gpu) == set(m_cpu), f"{label}: metrics {m_gpu} vs {m_cpu}")
    need = {}
    flips = abs(m_gpu.get("sparsity_term", 0.0) - m_cpu.get("sparsity_term",
                                                           0.0))
    for k in m_cpu:
        rtol, atol = ((2e-3, 2e-5) if k.endswith("grad_norm")
                      else (5e-4, 1e-5))
        if k == "sparsity_term":
            rtol, atol = 0.0, 2.0 / sparsity_n + 1e-7
        elif k == "g_loss" and sparsity_n:
            atol += flips
        _close(m_gpu[k], m_cpu[k], rtol, atol, f"{label} {k}")
        need[k] = abs(m_gpu[k] - m_cpu[k]) / max(abs(m_cpu[k]), 1e-30)
    worst_abs, worst_excess = _compare_trees(out, dev, 2e-3, 2e-5)
    eig_need = 0.0
    if e_cpu is not None:
        for k in e_cpu:
            _close(e_gpu[k], e_cpu[k], 2e-3, 2e-5, f"{label} eigen {k}")
            a, b = np.asarray(e_gpu[k]), np.asarray(e_cpu[k])
            eig_need = max(eig_need, float((np.abs(a - b)
                                            / np.abs(b).clip(1e-30)).max()))
    print(f"card vs cpu, {label} (batch {batch}, highest): relative "
          f"difference of each metric (the rtol it needed) "
          + ", ".join(f"{k} {v:.3g}" for k, v in sorted(need.items()))
          + (f" (sparsity_term {flips * sparsity_n:.0f} of {sparsity_n} "
             f"entries apart)" if sparsity_n else "")
          + f"; params and BN stats max |cuda-cpu| {worst_abs:.3g}, "
          f"atol needed at rtol 2e-3 {max(worst_excess, 0.0):.3g}"
          + (f"; prediction scalars rtol needed {eig_need:.3g}"
             if e_cpu is not None else ""), flush=True)


def phase_depth_card_vs_cpu(torch, dev) -> None:
    """Phase 7's check for the depth models at 65x65 (f32, highest, each
    optimizer replaced by sgd 1e-3), then each model's own optimizer on
    the card against the CPU's on the card's gradients."""
    for name, batch, flags in DEPTH_CARD_VS_CPU:
        out = _depth_call_each(torch, dev, name, batch, flags)
        _compare_depth(torch, dev, f"{name} {' '.join(flags)} 65x65", out,
                       batch)
        _own_optimizer_on_card(torch, dev, name, batch, flags)


# phase 12: (model, batch, size, flags, composed) on the card and the CPU,
# with a1.config's optimizer for the own-optimizer check
SLICE_OPT = ["--optimizer", "adam", "--lr", "1e-4", "--beta1", "0.5"]
SLICE_CARD_VS_CPU = [
    ("improved_sampler", 4, 65, ["--g_arch", "A1", "--d_arch", "A1"], False),
    ("improved_sampler", 4, 66, ["--g_arch", "B1", "--d_arch", "B1"], False),
    ("improved_sampler", 4, 64, ["--g_arch", "E1", "--d_arch", "E1",
                                 "--g_sparsity", "--g_rmse"], False),
    ("mean_depth_estimator", 4, 64, [], False),
    ("experimental_sampler", 4, 64, [], True)]


def phase_slice_card_vs_cpu(torch, dev) -> None:
    """Phase 10's checks for this slice's models: improved_sampler A1/A1
    (65 px), B1/B1 (66 px), E1/E1 with --g_sparsity --g_rmse (64 px; its
    bottleneck is 1x1x1024 per row), the mean-depth estimator and the
    experimental sampler composed with an estimator (64 px)."""
    for name, batch, size, flags, compose in SLICE_CARD_VS_CPU:
        flags = flags + SLICE_OPT
        out = _depth_call_each(torch, dev, name, batch, flags, size, compose)
        label = f"{name} {' '.join(flags[:4])}{' composed' if compose else ''}"
        _compare_depth(torch, dev, f"{label} {size}x{size}", out, batch,
                       sparsity_n=batch * 1024 if "--g_sparsity" in flags
                       else 0)
        _own_optimizer_on_card(torch, dev, name, batch, flags, size, compose)


# thesis_runs.sh's optimizer flags
GAN_OPT = ["--optimizer", "adam", "--g_lr", "1e-4", "--d_lr", "1e-4",
           "--g_beta1", "0.5", "--g_beta2", "0.999", "--d_beta1", "0.5",
           "--d_beta2", "0.999"]
STANDALONE_OPT = ["--optimizer", "adam", "--g_lr", "1e-4", "--g_beta1",
                  "0.5", "--g_beta2", "0.999"]


def _thesis_line(label: str, card: str, res: dict, batch: int,
                 launches: int, want: int) -> None:
    s = res["summary"]
    print(f"{label} on {card}: {s['calls']} calls, first call "
          f"{s['first_call_s']:.4f} s, median call {s['median_call_s']:.4f} s, "
          f"{s['images_per_s']:.1f} images/s (a call counts one batch of "
          f"{batch}); moments {res['moments_s']:.3f} s on the host; "
          f"{launches} input-kernel launches (expected {want})", flush=True)


def phase_thesis(torch, dev, card: str, workdir: str, nyu_raw: str,
                 store: str, *, count: int = 4096, eval_count: int = 512,
                 batch: int = 256, nyu_batch: int = 64) -> dict:
    """The slice at full width through ``python -m hemx_torch.paper_train``
    (``paper_train.run``), thesis_runs.sh's COMMON: 4,096 / 512 synthetic
    65x65x3 uint8 images, bs256, seed 7, one epoch (16 calls) per run.
    Returns the input kernel's launches of each run."""
    from hemx_torch import paper_train
    from hemx_torch.ops import input_kernels as K
    from hemx_torch.summaries.reader import get_all_events

    THESIS = ["--dataset", "synthetic", "--synthetic_count", str(count),
              "--synthetic_eval_count", str(eval_count), "--synthetic_shape",
              "65", "65", "3", "--synthetic_u8", "--batch_size", str(batch),
              "--max_to_keep", "1", "--seed", "7"]
    calls = count // batch
    launches = {}
    # (a) paper_cgan mean_adjusted, f32: an epoch, then +1 on the same dir;
    # per call one 2-batch gather of each uint8 key (image, depth), plus
    # the summary batch and each validation batch, each key
    d = os.path.join(workdir, "cgan")
    argv = ["--model", "paper_cgan", "--model_version", "mean_adjusted",
            *THESIS, *GAN_OPT, "--device", str(dev), "--dir", d]
    out = run_and_resume(torch, dev, d, argv, calls, 2, count, eval_count,
                         batch, run=paper_train.run, dtype="float32", keys=2,
                         eval_tags=["g_loss", "d_loss", "rmse"])
    launches["cgan_f32_run_and_resume"] = out["launches"]
    per_run = run_launches(count, eval_count, batch, calls, 2)
    want = 2 * 2 * per_run
    print(f"launch formula (a): 2 runs x 2 uint8 keys x (expected_launches("
          f"{count // batch} batches per data epoch, group 2, {calls} calls x "
          f"2 batches) + 1 summary batch + {eval_count} / {batch} validation "
          f"batches) = 2 x 2 x {per_run} = {want}", flush=True)
    tags = set(get_all_events(os.path.join(d, "train")))
    for prefix in ("metrics_y_hat/", "metrics_y_0/", "metrics_y_mean/"):
        check(any(t.startswith(prefix) for t in tags),
              f"paper_cgan: no {prefix}* summaries")
    for f in ("mean_image.png", "var_image.png", "mean_image.npy"):
        check(os.path.exists(os.path.join(d, f)), f"paper_cgan: no {f}")
    for r in (out["res1"], out["res2"]):
        _thesis_line(f"paper_cgan mean_adjusted f32 bs{batch} (run and "
                     f"resume)", card, r, batch, out["launches"], want)

    def one_epoch(label, name, argv, group, check_fn=None):
        K.reset_launches()
        res = paper_train.run(argv + ["--epochs", "1", "--device", str(dev),
                                      "--dir", os.path.join(workdir, name)])
        n = K.LAUNCHES["gather_u8_normalize"]
        want = 2 * run_launches(count, eval_count, batch, calls, group)
        check(res["train_state"].step == calls,
              f"{label}: step {res['train_state'].step}")
        check(all(math.isfinite(v) for h in res["history"] for v in h.values()),
              f"{label}: non-finite loss")
        check(n == want, f"{label}: input kernel launched {n}, expected {want}")
        if check_fn:
            check_fn(res)
        _thesis_line(label, card, res, batch, n, want)
        launches[name] = n

    def clipped(res):
        worst = max(p.abs().max().item()
                    for p in res["train_state"].nets.parameters())
        check(worst <= 0.01 + 1e-7, f"paper_cgan wgan: a parameter at {worst}")
        print(f"paper_cgan wgan: every parameter within +-0.01 (largest "
              f"|p| {worst:.6g})", flush=True)

    # (b)-(d) one epoch each
    one_epoch(f"paper_cgan wgan f32 bs{batch} (5+1)", "cgan_wgan",
              ["--model", "paper_cgan", "--training_version", "wgan",
               *THESIS, *GAN_OPT], 6, clipped)
    one_epoch(f"paper_standalone mean_provided f32 bs{batch}", "standalone",
              ["--model", "paper_standalone", "--model_version",
               "mean_provided", *THESIS, *STANDALONE_OPT], 1)
    one_epoch(f"paper_sampler e4-512 f32 bs{batch}", "sampler_e4_512",
              ["--model", "paper_sampler", "--noise_layer", "e4-512",
               *THESIS, *GAN_OPT], 2)
    # (e) (a) in bf16: every conv and deconv product on the card in bf16
    d = os.path.join(workdir, "cgan_bf16")
    argv = ["--model", "paper_cgan", "--model_version", "mean_adjusted",
            *THESIS, *GAN_OPT, "--device", str(dev), "--dir", d]
    out = run_and_resume(torch, dev, d, argv, calls, 2, count, eval_count,
                         batch, run=paper_train.run, dtype="bfloat16", keys=2,
                         eval_tags=["g_loss", "d_loss", "rmse"])
    launches["cgan_bf16_run_and_resume"] = out["launches"]
    for r in (out["res1"], out["res2"]):
        _thesis_line(f"paper_cgan mean_adjusted bf16 bs{batch} (run and "
                     f"resume)", card, r, batch, out["launches"], want)
    # (f) the thesis's own input: NYUv2-format records, 65x65 random crops,
    # streamed (float images: no input kernel)
    K.reset_launches()
    res = paper_train.run(
        ["--model", "paper_cgan", "--dataset", "nyuv2", "--raw_dataset_dir",
         nyu_raw, "--dataset_dir", store, "--random_crop", "65", "65",
         "--batch_size", str(nyu_batch), *GAN_OPT, "--epochs", "1", "--epoch_size",
         "4", "--seed", "7", "--device", str(dev), "--dir",
         os.path.join(workdir, "nyu_cgan")])
    n = K.LAUNCHES["gather_u8_normalize"]
    check(res["train_state"].step == 4 and n == 0
          and all(math.isfinite(v) for h in res["history"]
                  for v in h.values()),
          f"paper_cgan on NYUv2: step {res['train_state'].step}, launches "
          f"{n}, history {res['history']}")
    check(os.path.exists(os.path.join(workdir, "nyu_cgan", "mean_image.npy")),
          "paper_cgan on NYUv2: no moments")
    _thesis_line(f"paper_cgan on NYUv2 65x65 crops, bs{nyu_batch}, "
                 f"streaming", card, res, nyu_batch, n, 0)
    launches["cgan_nyuv2_streaming"] = n
    thesis_rows(torch, dev, card, THESIS)
    return launches


def thesis_rows(torch, dev, card: str, common: list, calls: int = 3) -> None:
    """Every run ``scripts/thesis_runs.sh`` trains for experiment1/1b/2
    (``paper_standalone`` and ``paper_cgan`` per model version, and
    ``paper_sampler`` per noise site; 14 runs) takes ``calls`` train calls
    at full width on the card from one device-resident split: finite
    metrics, the step count, and the last call's time."""
    from hemx_torch.config import parse_args
    from hemx_torch.data.pipeline import DeviceDataPipeline
    from hemx_torch.data.synthetic import SyntheticDataset
    from hemx_torch.models.plugin import get_model
    from hemx_torch.train.loop import _continuous_stream

    rows = []
    for v in ("baseline", "mean_adjusted", "mean_provided"):
        rows += [["--model", "paper_standalone", "--model_version", v,
                  *STANDALONE_OPT],
                 ["--model", "paper_cgan", "--model_version", v, *GAN_OPT]]
    rows += [["--model", "paper_sampler", "--noise_layer", site, *GAN_OPT]
             for site in ("x", "e1", "e2", "e3", "e4-512", "d2", "d3", "d4")]
    split = None
    times = []
    for argv in rows:
        args = parse_args(argv + common + ["--device", str(dev)])
        if split is None:
            split = SyntheticDataset.get_datasets(args)["train"]
        model = get_model(args.model)(args, dev)
        ts = model.init_state((3, 65, 65), args.seed)
        stream = _continuous_stream(DeviceDataPipeline(
            split, args.batch_size, device=dev, keys=model.batch_keys,
            seed=args.seed, group=model.batches_per_train_call()))
        for _ in range(calls):
            t0 = time.perf_counter()
            ts, metrics = model.train(ts, stream)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            seconds = time.perf_counter() - t0
        label = " ".join(argv[1:4])
        check(ts.step == calls and all(
            math.isfinite(float(m)) for m in metrics.values()),
            f"{label}: step {ts.step}, metrics {metrics}")
        times.append(f"{label} {seconds * 1e3:.1f} ms")
    print(f"the {len(rows)} thesis_runs.sh runs, {calls} calls each at bs"
          f"{args.batch_size} on {card}, all finite; last call: "
          + "; ".join(times), flush=True)


CONFIGS = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "examples", "improved_sampler")


def _slice_line(label: str, card: str, res: dict, batch: int, launches: int,
                want: int) -> None:
    s = res["summary"]
    print(f"{label} on {card}: {s['calls']} calls, first call "
          f"{s['first_call_s']:.4f} s, median call {s['median_call_s']:.4f} s, "
          f"{s['images_per_s']:.1f} images/s (a call counts one batch of "
          f"{batch}); {launches} input-kernel launches (expected {want})",
          flush=True)


def phase_slice(torch, dev, card: str, workdir: str, cgan_dir: str, *,
                count: int = 4096, eval_count: int = 512) -> dict:
    """This slice at full width through its entry points, on synthetic
    uint8 sets of ``count`` / ``eval_count`` images at each run's patch
    size, seed 7, from hemx's config files (``@FILE``, then the flags that
    replace the NYUv2 input). Returns the input kernel's launches of each
    run."""
    from hemx_torch import cli, experimental, paper_fullimage, paper_metrics
    from hemx_torch.ops import input_kernels as K

    def synthetic(size: int, batch: int) -> list:
        return ["--dataset", "synthetic", "--synthetic_u8",
                "--synthetic_count", str(count), "--synthetic_eval_count",
                str(eval_count), "--synthetic_shape", str(size), str(size),
                "3", "--batch_size", str(batch), "--seed", "7",
                "--device", str(dev)]

    launches = {}
    # (a) a1.config: A1/A1, 65 px, bs256, Adam(1e-4, beta1 0.5), f32, an
    # epoch of 16 calls, then +1 with a bit-exact resume; each call gathers
    # one batch of each uint8 key (image, depth)
    batch, calls = 256, count // 256
    d = os.path.join(workdir, "a1")
    t0 = time.perf_counter()
    out = run_and_resume(
        torch, dev, d, ["@" + os.path.join(CONFIGS, "a1.config"),
                        *synthetic(65, batch), "--dir", d],
        calls, 1, count, eval_count, batch, run=cli.run, dtype="float32",
        keys=2, eval_tags=["g_loss", "d_loss", "rmse", "l1"])
    launches["a1_f32_run_and_resume"] = out["launches"]
    print(f"a1.config run and resume: {time.perf_counter() - t0:.1f} s for "
          f"both runs (data, summaries, checkpoints, validation)", flush=True)
    want = 2 * 2 * run_launches(count, eval_count, batch, calls, 1)
    print(f"launch formula (a): 2 runs x 2 uint8 keys x (expected_launches("
          f"{count // batch} batches per data epoch, group 1, {calls} calls) "
          f"+ 1 summary batch + {eval_count} / {batch} validation batches) = "
          f"{want}", flush=True)
    for r in (out["res1"], out["res2"]):
        _slice_line(f"improved_sampler A1/A1 65x65 f32 bs{batch} (run and "
                    f"resume)", card, r, batch, out["launches"], want)

    def one_epoch(label, name, argv, batch, calls, entry=cli.run, runs=1):
        K.reset_launches()
        t0 = time.perf_counter()
        res = entry(argv + ["--epochs", "1", "--epoch_size", str(calls),
                            "--max_to_keep", "1", "--dir",
                            os.path.join(workdir, name)])
        wall = time.perf_counter() - t0
        n = K.LAUNCHES["gather_u8_normalize"]
        want = runs * 2 * run_launches(count, eval_count, batch, calls, 1)
        check(res["train_state"].step == calls,
              f"{label}: step {res['train_state'].step}")
        check(all(math.isfinite(v) for h in res["history"] for v in h.values()),
              f"{label}: non-finite loss")
        check(n == want, f"{label}: input kernel launched {n}, expected {want}")
        _slice_line(label, card, res, batch, n, want)
        print(f"{label}: {wall:.1f} s for the whole run (data, summaries, "
              f"checkpoints, validation)", flush=True)
        launches[name] = n
        return res

    # (b) ff.sparsity.config: E1/E1, 64 px, bs512, --g_sparsity, 8 calls
    res = one_epoch("improved_sampler E1/E1 --g_sparsity 64x64 f32 bs512",
                    "e1_sparsity", ["@" + os.path.join(
                        CONFIGS, "ff.sparsity.config"), *synthetic(64, 512)],
                    512, 8)
    sp = [h["sparsity_term"] for h in res["history"]]
    check(all(0.0 <= v <= 1.0 for v in sp), f"E1 sparsity terms {sp}")
    print(f"E1 bottleneck zero fraction per call: {sp}", flush=True)
    # (c) gb1.db1.config: B1/B1, 66 px, bs512, 8 calls
    one_epoch("improved_sampler B1/B1 66x66 f32 bs512", "b1",
              ["@" + os.path.join(CONFIGS, "gb1.db1.config"),
               *synthetic(66, 512)], 512, 8)
    # (d) experimental.config through python -m hemx_torch.experimental:
    # bs64, an estimator epoch then a sampler epoch (the published 30 and
    # 10 epochs cut to 1 each); both phases gather image and depth
    batch = 64
    res = one_epoch("experimental (estimator, then composed E1 sampler) "
                    f"64x64 bs{batch}", "experimental",
                    ["@" + os.path.join(CONFIGS, "experimental.config"),
                     *synthetic(64, batch), "--estimator_epochs", "1"],
                    batch, count // batch, entry=experimental.run, runs=2)
    est = res["estimator"]
    check(est["train_state"].step == count // batch
          and all(math.isfinite(h["m_loss"]) for h in est["history"]),
          f"experimental: estimator step {est['train_state'].step}")
    check(res["args"].lr == 1e-4, f"experimental: sampler lr {res['args'].lr}")
    secs = sorted(h["seconds"] for h in est["history"][1:])
    print(f"experimental phase 1 (mean_depth_estimator) on {card}: "
          f"{len(est['history'])} calls, median call "
          f"{statistics.median(secs):.4f} s, m_loss "
          f"{est['history'][0]['m_loss']:.4f} -> "
          f"{est['history'][-1]['m_loss']:.4f}", flush=True)
    # (e) the evaluation tools on phase 11's paper_cgan run
    K.reset_launches()
    t0 = time.perf_counter()
    report = paper_metrics.run(["--dir", cgan_dir, "--device", str(dev)])
    metrics_s = time.perf_counter() - t0
    n = K.LAUNCHES["gather_u8_normalize"]
    want = 2 * (count // 256 + 2 * (eval_count // 256))
    check(n == want, f"paper_metrics: input kernel launched {n}, "
                     f"expected {want}")
    check(set(report) == {"train", "validate", "test"} and all(
        math.isfinite(v) for split in report.values()
        for variant in split.values() for v in variant.values()),
        f"paper_metrics: report {report}")
    launches["paper_metrics"] = n
    print(f"paper_metrics on {card}: {count + 2 * eval_count} patches over 3 "
          f"splits in {metrics_s:.2f} s; y_hat linear_rmse (test) "
          f"{report['test']['y_hat']['linear_rmse']:.4f}; {n} input-kernel "
          f"launches (expected {want}: one per uint8 key and batch)",
          flush=True)
    K.reset_launches()
    t0 = time.perf_counter()
    full = paper_fullimage.run(["--dir", cgan_dir, "--device", str(dev),
                                "--scene_shape", "240", "320", "3",
                                "--strides", "8", "4", "2"])
    n = K.LAUNCHES["gather_u8_normalize"]
    check(n == 0, f"paper_fullimage: {n} kernel launches (host-normalized)")
    check(sorted(full["rmse"]) == ["2", "4", "8"] and all(
        math.isfinite(v["mean"]) for v in full["rmse"].values()),
        f"paper_fullimage: {full['rmse']}")
    launches["paper_fullimage"] = n
    print(f"paper_fullimage on {card}: 8 scenes of 240x320, strides 8 4 2: "
          f"{full['patches']} patches in {full['seconds']:.2f} s of "
          f"prediction, {full['patches'] / full['seconds']:.1f} patches/s "
          f"(host slicing and H2D included), {time.perf_counter() - t0:.1f} "
          f"s in all; mean rmse per stride "
          + ", ".join(f"{k}: {v['mean']:.4f}" for k, v in
                      sorted(full["rmse"].items())), flush=True)
    return launches

# phase 14: (model, batch, size, flags) on the card and the CPU, with
# examples/pix2pix.config's optimizer for the own-optimizer check
ZOO_OPT = ["--optimizer", "adam", "--lr", "1e-4", "--beta1", "0.5"]
ZOO_CARD_VS_CPU = [
    ("pix2pix", 4, 32, ["--add_l1"]),
    ("pix2pix", 4, 32, ["--noise", "input", "latent", "end", "--dropout",
                        "0.5", "--batch_norm_gen", "--batch_norm_disc"]),
    ("pix2pix", 4, 32, ["--n_disc_train", "2"]),
    ("artist", 4, 65, []),
    ("info_gan", 4, 32, [])]


def phase_zoo_rest_card_vs_cpu(torch, dev) -> None:
    """Phase 10's checks for pix2pix (32 px: baseline with --add_l1; every
    noise site, dropout 0.5 and BN in G and D; --n_disc_train 2), artist
    (65 px) and info_gan (32 px): the same weights, batches and seam draws
    on each device, sgd 1e-3, then each model's own optimizer (Adam) on the
    card against the CPU's on the card's gradients."""
    for name, batch, size, flags in ZOO_CARD_VS_CPU:
        out = _depth_call_each(torch, dev, name, batch, flags + ZOO_OPT, size)
        label = f"{name} {' '.join(flags)}".strip()
        _compare_depth(torch, dev, f"{label} {size}x{size}", out, batch)
        _own_optimizer_on_card(torch, dev, name, batch, flags + ZOO_OPT, size)


EXAMPLES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "examples")


def _fresh_peak(torch, dev) -> None:
    import gc
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)


def _traced(torch, dev, fn) -> dict:
    """``fn()`` under torch.profiler: its device operations (kernels,
    copies, fills), their summed time, the device's busy share of the
    traced window (union of their intervals over the host-clock window)
    and that window."""
    from torch.autograd import DeviceType
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize(dev)
        window_us = (time.perf_counter() - t0) * 1e6
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events() if e.device_type == DeviceType.CUDA)
    busy, end = 0.0, -1.0
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    return {"launches": len(spans),
            "kernel_ms": sum(b - a for a, b in spans) / 1e3,
            "traced_ms": window_us / 1e3, "busy": busy / window_us}


def _call_profile(torch, dev, res) -> dict:
    """One more train call of a finished run, traced (:func:`_traced`)."""
    from hemx_torch.models.plugin import get_model
    from hemx_torch.train.loop import _continuous_stream
    model = get_model(res["args"].model)(res["args"], dev)
    stream = _continuous_stream(res["pipeline"])
    return _traced(torch, dev,
                   lambda: model.train(res["train_state"], stream))


def _zoo_line(label: str, card: str, res: dict, batch: int, launches: int,
              want: int, peak: int, prof: dict) -> None:
    s, t = res["summary"], res["timings"]
    print(f"{label} on {card}: {s['calls']} calls, first call "
          f"{s['first_call_s']:.4f} s, median call {s['median_call_s']:.4f} s, "
          f"{s['images_per_s']:.1f} images/s (a call counts one batch of "
          f"{batch}); peak device memory {peak / 2**30:.3f} GiB "
          f"(torch.cuda.max_memory_allocated, reset before the run); "
          f"{launches} input-kernel launches (expected {want}); one more "
          f"call traced: {prof['launches']} device launches, "
          f"{prof['kernel_ms']:.2f} ms of device time in a "
          f"{prof['traced_ms']:.2f} ms call, busy {100 * prof['busy']:.1f} %; "
          f"summary writes median {statistics.median(t['summary_s']):.3f} s "
          f"(n={len(t['summary_s'])}), checkpoint "
          f"{t['checkpoint_bytes'][-1]} bytes saved in median "
          f"{statistics.median(t['save_s']):.3f} s", flush=True)


def phase_zoo_rest(torch, dev, card: str, workdir: str, *, count: int = 1024,
                   eval_count: int = 128) -> dict:
    """pix2pix, artist and info_gan at full width through ``cli.run``, from
    hemx's config files with NYUv2 (not in the repository) replaced by
    ``count`` / ``eval_count`` synthetic uint8 image + depth pairs of
    256x256, seed 7, on the device cache; montages of 8 examples, one
    summary per epoch besides its end (hemx's cadence writes 17 in a
    16-call epoch). Returns the input kernel's launches of each run."""
    from hemx_torch import cli
    from hemx_torch.models.plugin import get_model
    from hemx_torch.ops import input_kernels as K

    from hemx_torch.config import parse_args
    from hemx_torch.data.plugin import get_dataset_tensors

    common = ["--dataset", "synthetic", "--synthetic_u8", "--synthetic_count",
              str(count), "--synthetic_eval_count", str(eval_count),
              "--synthetic_shape", "256", "256", "3", "--seed", "7",
              "--device", str(dev), "--examples", "8", "--summary_freq", "1"]
    launches = {}
    # every run trains on these splits, made once (each run would render
    # its 1,280 scenes of 256x256 on the host again); a run starts with
    # none of an earlier run's device pipelines, so its peak is its own
    splits = get_dataset_tensors(parse_args(common))

    def run(argv):
        for split in splits.values():
            split.release_device_pipelines()
        return cli.run(argv, splits)

    def config(name):
        return "@" + os.path.join(EXAMPLES, name)

    def resumed(label, name, argv, calls, dtype, **kw):
        d = os.path.join(workdir, name)
        _fresh_peak(torch, dev)
        out = run_and_resume(torch, dev, d, argv + common + ["--dir", d],
                             calls, 2, count, eval_count, 64, run=run,
                             dtype=dtype, keys=2,
                             eval_tags=["g_loss", "d_loss", "l1", "rmse"], **kw)
        peak = torch.cuda.max_memory_allocated(dev)
        want = 2 * 2 * run_launches(count, eval_count, 64, calls, 2)
        prof = _call_profile(torch, dev, out["res2"])
        for r in (out["res1"], out["res2"]):
            _zoo_line(f"{label} (run and resume)", card, r, 64,
                      out["launches"], want, peak, prof)
        launches[name] = out["launches"]
        shutil.rmtree(d, ignore_errors=True)
        return out

    def one_run(label, name, argv, batch, calls, group, keys=("g_loss",)):
        d = os.path.join(workdir, name)
        _fresh_peak(torch, dev)
        K.reset_launches()
        t0 = time.perf_counter()
        res = run(argv + common + ["--epochs", "1", "--epoch_size",
                                   str(calls), "--max_to_keep", "1",
                                   "--dir", d])
        wall = time.perf_counter() - t0
        n = K.LAUNCHES["gather_u8_normalize"]
        peak = torch.cuda.max_memory_allocated(dev)
        want = 2 * run_launches(count, eval_count, batch, calls, group)
        check(res["train_state"].step == calls,
              f"{label}: step {res['train_state'].step}")
        check(all(k in h and math.isfinite(h[k]) for h in res["history"]
                  for k in keys) and all(math.isfinite(v) for h in
                                         res["history"] for v in h.values()),
              f"{label}: losses {res['history']}")
        check(n == want, f"{label}: input kernel launched {n}, expected {want}")
        prof = _call_profile(torch, dev, res)
        _zoo_line(label, card, res, batch, n, want, peak, prof)
        print(f"{label}: {wall:.1f} s for the whole run (summaries, "
              f"checkpoints, validation)", flush=True)
        launches[name] = n
        shutil.rmtree(d, ignore_errors=True)
        return res

    # (a) pix2pix.config: bs64, Adam(1e-4, beta1 0.5), --n_disc_train
    # 1, f32: an epoch of 16 calls, then +1 with a bit-exact resume
    resumed("pix2pix pix2pix.config 256x256 f32 bs64", "pix2pix",
            [config("pix2pix.config")], 16, "float32")
    # (b) no_l1.config: dropout keep 0.5, BN in G and D
    one_run("pix2pix no_l1.config (dropout 0.5, BN in G and D) f32 bs64",
            "no_l1", [config("pix2pix/no_l1.config")], 64, 8, 2)
    # (c) the three noise sites, one per config
    for cfg in ("noise", "noise2", "noise3"):
        res = one_run(f"pix2pix {cfg}.config f32 bs64", cfg,
                      [config(f"pix2pix/{cfg}.config")], 64, 3, 2)
        G = res["train_state"].nets["generator"]
        if res["args"].noise == ["latent"]:
            check(G.d1_w.shape[0] == 1024,
                  f"{cfg}: d1 takes {G.d1_w.shape[0]} channels")
            print(f"{cfg}.config: d1 takes {G.d1_w.shape[0]} input "
                  f"channels (the bottleneck's 512 and 512 of noise)",
                  flush=True)
    # (d) baseline2.config: batch 1, BN in G over 1x1 maps of one row
    one_run("pix2pix baseline2.config (batch 1, --batch_norm_gen, "
            "--noise input) f32", "baseline2",
            [config("pix2pix/baseline2.config")], 1, 16, 2)
    # (e) (a) in bf16: every conv and deconv product bf16
    resumed("pix2pix pix2pix.config 256x256 bf16 bs64", "pix2pix_bf16",
            [config("pix2pix.config")], 4, "bfloat16",
            bn_input=torch.float32)
    # (f) artist.config: bs32, Adam 1e-4; the x step on the card
    res = one_run("artist artist.config 256x256 f32 bs32", "artist",
                  [config("artist.config")], 32, 8, 2,
                  keys=("y_loss", "x_loss", "y_hat_rmse"))
    ts, nets = res["train_state"], res["train_state"].nets
    enc = {n: p.detach().clone()
           for n, p in nets["encoder"].named_parameters()}
    dec = {n: p.detach().clone()
           for n, p in nets["x_decoder"].named_parameters()}
    stats = {n: b.clone() for n, b in nets["encoder"].named_buffers()}
    get_model("artist")(res["args"], dev).x_step(
        ts, next(iter(res["pipeline"].epoch(0))))
    check(all(torch.equal(p, enc[n])
              for n, p in nets["encoder"].named_parameters()),
          "artist: the x step moved the encoder's parameters")
    check(all(not torch.equal(p, dec[n])
              for n, p in nets["x_decoder"].named_parameters()
              if n.endswith("_w")),
          "artist: the x step left an x-decoder kernel")
    check(any(not torch.equal(b, stats[n])
              for n, b in nets["encoder"].named_buffers()
              if n.endswith("mean")),
          "artist: the x step left the encoder's BN stats")
    print("artist: an x step on the card leaves the encoder's parameters "
          "bit for bit, moves every x-decoder kernel and the encoder's "
          "BN moving stats", flush=True)
    # (g) info_gan at 256 px, bs32, Adam 1e-4
    one_run("info_gan 256x256 f32 bs32", "info_gan",
            ["--model", "info_gan", "--optimizer", "adam", "--lr", "1e-4",
             "--batch_size", "32"], 32, 6, 3,
            keys=("d_loss", "g_loss", "q_loss"))
    return launches


def photo_bank(rng, h: int, w: int, n: int = 16) -> list:
    """``n`` smooth photograph-like RGB images of ``h`` x ``w``: random
    colours on a coarse grid of 8x8 cells, bilinearly spread. A JPEG of
    one decodes as slowly as a photograph of its size."""
    import numpy as np
    ys = np.linspace(0, 8, h, dtype=np.float32)
    xs = np.linspace(0, 8, w, dtype=np.float32)
    y0, x0 = np.minimum(ys.astype(int), 7), np.minimum(xs.astype(int), 7)
    wy, wx = (ys - y0)[:, None, None], (xs - x0)[None, :, None]
    bank = []
    for _ in range(n):
        low = rng.uniform(0, 255, (9, 9, 3)).astype(np.float32)
        top = low[y0][:, x0] * (1 - wx) + low[y0][:, x0 + 1] * wx
        bot = low[y0 + 1][:, x0] * (1 - wx) + low[y0 + 1][:, x0 + 1] * wx
        bank.append((top * (1 - wy) + bot * wy).astype(np.uint8))
    return bank


def photo(rng, bank: list):
    """One of ``bank``'s images, rolled by a random offset."""
    import numpy as np
    img = bank[int(rng.integers(len(bank)))]
    return np.roll(img, tuple(int(v) for v in rng.integers(0, 64, 2)),
                   axis=(0, 1))


def jpeg_bytes(img, quality: int = 90) -> bytes:
    import io

    from PIL import Image
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="JPEG", quality=quality)
    return buf.getvalue()


def write_celeb_raw(raw: str, counts: dict, seed: int) -> list:
    """A raw CelebA tree: ``img_align_celeba/`` of 178x218 JPEGs (encoded
    here with Pillow), ``list_eval_partition.txt`` (0/1/2) and
    ``list_attr_celeba.txt`` (count, names, then +-1 per attribute).
    Returns the file names."""
    import numpy as np
    rng = np.random.default_rng(seed)
    bank = photo_bank(rng, 218, 178)
    os.makedirs(os.path.join(raw, "img_align_celeba"), exist_ok=True)
    names, codes = [], []
    for code, split in enumerate(("train", "validate", "test")):
        for _ in range(counts[split]):
            name = f"{len(names) + 1:06d}.jpg"
            with open(os.path.join(raw, "img_align_celeba", name), "wb") as f:
                f.write(jpeg_bytes(photo(rng, bank)))
            names.append(name)
            codes.append(code)
    with open(os.path.join(raw, "list_eval_partition.txt"), "w") as f:
        f.writelines(f"{n} {c}\n" for n, c in zip(names, codes))
    with open(os.path.join(raw, "list_attr_celeba.txt"), "w") as f:
        f.write(f"{len(names)}\n" + " ".join(f"attr{i}" for i in range(40))
                + "\n")
        for n in names:
            f.write(n + " " + " ".join(str(v) for v in rng.choice([-1, 1], 40))
                    + "\n")
    return names


def coco_rle_string(counts) -> str:
    """COCO's compressed RLE string of run lengths ``counts``."""
    out = []
    for i, x in enumerate(counts):
        if i > 2:
            x -= counts[i - 2]
        more = True
        while more:
            c = x & 0x1F
            x >>= 5
            more = x != -1 if c & 0x10 else x != 0
            out.append(chr((c | 0x20 if more else c) + 48))
    return "".join(out)


def write_coco_raw(raw: str, counts: dict, seed: int) -> None:
    """A raw COCO 2014 tree: ``train2014/``, ``val2014/`` and
    ``test2014/`` JPEGs of three sizes, and ``annotations/`` json with a
    polygon, an uncompressed RLE and a compressed RLE per image of the
    annotated splits (categories 1-90)."""
    import json

    import numpy as np
    rng = np.random.default_rng(seed)
    sizes = ((240, 320), (213, 320), (320, 240))
    banks = [photo_bank(rng, h, w) for h, w in sizes]
    files = {"train": ("train2014", "instances_train2014.json"),
             "validate": ("val2014", "instances_val2014.json"),
             "test": ("test2014", "image_info_test2014.json")}
    os.makedirs(os.path.join(raw, "annotations"), exist_ok=True)
    for split, n in counts.items():
        d, ann_file = files[split]
        os.makedirs(os.path.join(raw, d), exist_ok=True)
        images, anns = [], []
        for i in range(n):
            h, w = sizes[i % 3]
            image_id = 100000 * len(images) + i
            name = f"COCO_{d}_{image_id:012d}.jpg"
            with open(os.path.join(raw, d, name), "wb") as f:
                f.write(jpeg_bytes(photo(rng, banks[i % 3])))
            images.append({"id": image_id, "file_name": name, "height": h,
                           "width": w})
            if split == "test":
                continue
            y0, x0 = int(rng.integers(0, h // 2)), int(rng.integers(0, w // 2))
            cats = rng.integers(1, 91, 3)
            anns += [
                {"segmentation": [[x0, y0, x0 + w / 3, y0 + 5, x0 + 10,
                                   y0 + h / 3]], "bbox": [x0, y0, w / 3,
                                                          h / 3],
                 "iscrowd": 0, "area": float(h * w / 18),
                 "category_id": int(cats[0]), "image_id": image_id},
                {"segmentation": {"counts": [h * 3 + 7, h * 2 - 9,
                                             h * w - 5 * h + 2],
                                  "size": [h, w]},
                 "bbox": [3, 7, 2, h - 2], "iscrowd": 1,
                 "area": float(h * 2 - 9), "category_id": int(cats[1]),
                 "image_id": image_id},
                {"segmentation": {"counts": coco_rle_string(
                    [h * 10 + 4, 40, h - 44, 12, h * w - 11 * h - 12]),
                    "size": [h, w]},
                 "bbox": [10, 4, 2, 40], "iscrowd": 1, "area": 52.0,
                 "category_id": int(cats[2]), "image_id": image_id}]
        with open(os.path.join(raw, "annotations", ann_file), "w") as f:
            json.dump({"images": images, "annotations": anns}, f)


def phase_celeb_coco(torch, dev, card: str, workdir: str, *,
                     celeb_counts=(2048, 512, 256), coco_counts=(384, 64, 64),
                     batch: int = 512, calls: int = 4,
                     cnn_batch: int = 64) -> dict:
    """celeb and coco at full width: raw trees written here, converted by
    the CLI's preparation step, the IWGAN bf16 on celeb (bs512, latent 200,
    5+1, Adam) with run and resume, and the CNN on coco; each run's input
    launches against their formula. Returns the launches by run."""
    import numpy as np
    from PIL import Image

    import PIL
    from hemx_torch import cli
    from hemx_torch.config import parse_args
    from hemx_torch.data.imageio import decode_image
    from hemx_torch.data.pipeline import DeviceDataPipeline
    from hemx_torch.data.plugin import get_dataset_tensors, prepare_dataset
    from hemx_torch.ops import input_kernels as K

    store = os.path.join(workdir, "store")
    launches, rates = {}, {}
    for name, counts, write in (("celeb", celeb_counts, write_celeb_raw),
                                ("coco", coco_counts, write_coco_raw)):
        raw = os.path.join(workdir, f"{name}_raw")
        split_counts = dict(zip(("train", "validate", "test"), counts))
        t0 = time.perf_counter()
        write(raw, split_counts, seed=0)
        write_s = time.perf_counter() - t0
        args = parse_args(["--dataset", name, "--raw_dataset_dir", raw,
                           "--dataset_dir", store, "--device", str(dev),
                           "--dir", os.path.join(workdir, "unused")])
        t0 = time.perf_counter()
        prepare_dataset(args)
        convert_s = time.perf_counter() - t0
        splits = get_dataset_tensors(args)
        t0 = time.perf_counter()
        n = splits["train"].count
        mat_s = time.perf_counter() - t0
        check(n == counts[0], f"{name}: {n} train records, expected "
                              f"{counts[0]}")
        rates[name] = (sum(counts), write_s, convert_s, n, mat_s, splits)
        check_native_build()
        rec_dir = os.path.join(store, name)
        rec_bytes = sum(os.path.getsize(os.path.join(rec_dir, f))
                        for f in os.listdir(rec_dir)
                        if f.endswith(".tfrecords"))
        print(f"{name} raw: {sum(counts)} JPEGs written (Pillow "
              f"{PIL.__version__}) in {write_s:.2f} s; {rec_bytes} bytes of "
              f"records by the CLI's preparation in {convert_s:.2f} s "
              f"({sum(counts) / convert_s:.1f} images/s) through "
              f"hemx_torch.native's CRC-32C; train split materialized "
              f"(decoded, resized to 64x64) in {mat_s:.2f} s = "
              f"{n / mat_s:.1f} images/s", flush=True)
    jpg = os.path.join(workdir, "celeb_raw", "img_align_celeba", "000001.jpg")
    with open(jpg, "rb") as f:
        data = f.read()
    check(np.array_equal(decode_image(data), np.asarray(
        Image.open(jpg).convert("RGB"))),
        "the port's JPEG decode differs from Pillow's on this host")

    celeb_splits = rates["celeb"][5]
    argv = ["--model", "iwgan", "--dataset", "celeb", "--dataset_dir", store,
            "--batch_size", str(batch), "--latent_size", "200", *IWGAN_FLAGS,
            "--device", str(dev), "--dir", os.path.join(workdir, "celeb_iwgan"),
            "--seed", "0"]
    out = run_and_resume(torch, dev, os.path.join(workdir, "celeb_iwgan"),
                         argv, calls, 6, celeb_counts[0], celeb_counts[1],
                         batch, run=lambda a: cli.run(a, splits=celeb_splits),
                         image=64)
    launches["celeb_iwgan_bf16_run_and_resume"] = out["launches"]
    print(f"IWGAN bf16 on celeb records, bs{batch} 64x64x3 latent 200, 5+1, "
          f"Adam, 2 runs of {calls} calls on {card}: median call "
          f"{out['median_s']:.4f} s ({out['steady']} steady calls), "
          f"{batch / out['median_s']:.1f} images/s; {out['launches']} "
          f"input-kernel launches (formula "
          f"{2 * run_launches(celeb_counts[0], celeb_counts[1], batch, calls)}"
          f")", flush=True)

    coco_splits = rates["coco"][5]
    feed = DeviceDataPipeline(coco_splits["train"], cnn_batch, device=dev,
                              shuffle=False)
    got = next(feed.epoch(0))
    host = next(coco_splits["train"].iter_epoch(cnn_batch, shuffle=False))
    check(got["annotations"].dtype == torch.uint8 and torch.equal(
        got["annotations"].permute(0, 2, 3, 1).cpu(),
        torch.from_numpy(host["annotations"])),
        "coco annotations through the device cache differ from the host's")
    check(len(np.unique(host["annotations"])) > 3,
          "coco masks hold too few category ids")
    cnn = ["--model", "cnn", "--dataset", "coco", "--dataset_dir", store,
           "--batch_size", str(cnn_batch), "--latent_size", "200", "--optimizer",
           "rmsprop", "--lr", "1e-4", "--dtype", "bfloat16", "--epochs", "1",
           "--epoch_size", "4", "--device", str(dev), "--seed", "0",
           "--dir", os.path.join(workdir, "coco_cnn")]
    K.reset_launches()
    res = cli.run(cnn, splits=coco_splits)
    launches["coco_cnn"] = K.LAUNCHES["gather_u8_normalize"]
    want = run_launches(coco_counts[0], coco_counts[1], cnn_batch, 4, 1)
    check(res["train_state"].step == 4 and all(
        math.isfinite(h["loss"]) for h in res["history"]),
        f"coco CNN: step {res['train_state'].step}, {res['history']}")
    check(launches["coco_cnn"] == want, f"coco CNN: input kernel launched "
          f"{launches['coco_cnn']} times, expected {want}")
    print(f"CNN bf16 on coco records, bs{cnn_batch}, rmsprop, 4 calls on "
          f"{card}: "
          f"median call {res['summary']['median_call_s']:.4f} s; "
          f"annotations gathered on the card as uint8 category ids equal "
          f"the host's; {launches['coco_cnn']} input-kernel launches "
          f"(expected {want})", flush=True)
    return launches


def _dp_runs(runs, out_dir: str) -> None:
    """Each ``(entry, argv)`` of ``runs`` in this rank of a process group,
    through the entry point's run function; the input kernel's launches
    of each go to ``out_dir/launches-<rank>.json``."""
    import torch
    import torch.distributed as dist

    from hemx_torch import cli, paper_train
    from hemx_torch.ops import input_kernels as K
    torch.backends.cudnn.deterministic = True  # see DP_SMALL
    counts = []
    for entry, argv in runs:
        K.reset_launches()
        cli._worker_main(argv, {"cli": cli.run,
                                "paper_train": paper_train.run}[entry])
        counts.append(K.LAUNCHES["gather_u8_normalize"])
    with open(os.path.join(out_dir, f"launches-{dist.get_rank()}.json"),
              "w") as f:
        json.dump(counts, f)


# phase 17 (a): one call of each on two gloo ranks of cuda:0 (batch 4
# each) and in one process at batch 8: (name, entry point, uint8 keys,
# flags). Both sides run cuDNN's deterministic algorithms: with the
# default ones, one process repeating the gan's call on identical inputs
# now and then ends with an optimizer state (the raw gradient) outside
# the tolerance below, which would read as the two sides disagreeing;
# tests/test_torch_cuda_determinism.py counts such runs and shows the
# deterministic ones repeat bit for bit.
DP_SMALL = [
    ("iwgan", "cli", 1, ["--model", "iwgan", "--latent_size", "16",
                      "--n_disc_train", "2",
                      "--optimizer", "momentum", "--lr", "1e-3",
                      "--momentum", "0.5"]),
    ("gan", "cli", 1, ["--model", "gan", "--latent_size", "16", "--optimizer",
                    "momentum", "--lr", "1e-3", "--momentum", "0.5"]),
    ("vae", "cli", 1, ["--model", "vae", "--latent_size", "16", "--optimizer",
                    "sgd", "--lr", "1e-4"]),
    ("paper_standalone", "paper_train", 2, [
        "--model", "paper_standalone", "--model_version", "mean_provided"]),
]


def _compare_runs(label: str, got_dir: str, want_dir: str, tol: dict,
                  loss_rtol) -> float:
    """Check the last checkpoint of the run in ``got_dir`` (params, BN
    stats, optimizer state) against ``want_dir``'s at ``tol``, and its
    train and validate losses at ``loss_rtol(phase, tag)`` (+ 1e-5);
    returns the largest |diff| of the state."""
    import numpy as np
    from hemx_torch.convert import flatten_tree
    from hemx_torch.summaries.reader import get_all_events
    from hemx_torch.train.checkpoint import CheckpointManager
    worst = 0.0
    got, want = (flatten_tree(CheckpointManager(d).restore()["train_state"])
                 for d in (got_dir, want_dir))
    check(sorted(got) == sorted(want), f"{label}: checkpoint trees differ")
    for k in want:
        if k[0] in ("params", "mstate", "opt"):
            a_, b_ = np.asarray(got[k]), np.asarray(want[k])
            check(np.allclose(a_, b_, **tol),
                  f"{label} {'/'.join(k)}: differs from one process by "
                  f"{np.abs(a_ - b_).max()}")
            if a_.size:
                worst = max(worst, float(np.abs(a_ - b_).max()))
    for phase in ("train", "validate"):
        ev = [{(t, s): v for t, rows in get_all_events(os.path.join(
            d, phase)).items() if t.startswith("losses/") for _, s, v in rows}
              for d in (got_dir, want_dir)]
        check(ev[0].keys() == ev[1].keys() and ev[1],
              f"{label} {phase}: losses {sorted(ev[0])} vs {sorted(ev[1])}")
        for k, v in ev[1].items():
            check(abs(ev[0][k] - v) <= loss_rtol(phase, k[0]) * abs(v) + 1e-5,
                  f"{label} {phase} {k}: {ev[0][k]}, one process {v}")
    return worst


def phase_data_parallel(torch, dev, card: str, workdir: str, bf16_median: float,
                        *, count: int = 3072, eval_count: int = 512,
                        batch: int = 512, calls: int = 6) -> dict:
    """(a) two gloo ranks on ``dev`` against one process at the global
    batch, through the library's worker function; (b) the full-width bf16
    IWGAN through ``torchrun`` (NCCL, world size 1). Returns launches."""
    from hemx_torch import cli, paper_train
    from hemx_torch.config import parse_args
    from hemx_torch.ops import input_kernels as K
    from hemx_torch.parallel import mesh

    try:
        cli.workers(parse_args(["--dataset", "synthetic", "--n_devices", "2",
                                "--device", "cuda", "--dir", workdir]))
        check(torch.cuda.device_count() >= 2,
              "--n_devices 2 was not refused on a one-GPU host")
    except cli.CliError as e:
        check(str(e) == f"requested 2 devices but only "
                        f"{torch.cuda.device_count()} available",
              f"--n_devices 2 refused with {e}")
        print(f"--n_devices 2 on this host: refused, as hemx refuses it: "
              f"{e}", flush=True)

    def argv(flags, shape, b, d):
        return (["--dataset", "synthetic", "--synthetic_u8",
                 "--synthetic_count", "32", "--synthetic_eval_count", "16",
                 "--synthetic_shape", *shape, "--epochs", "1",
                 "--epoch_size", "1", "--precision",
                 "highest", "--device", str(dev), "--seed", "3",
                 "--batch_size", str(b), "--dir", d] + flags)

    runs, one = [], []
    for name, entry, _, flags in DP_SMALL:
        shape = ["65", "65", "3"] if entry == "paper_train" else ["32", "32",
                                                                  "3"]
        runs.append((entry, argv(flags, shape, 4,
                                 os.path.join(workdir, name, "two"))))
        one.append((entry, argv(flags, shape, 8,
                                os.path.join(workdir, name, "one"))))
    t0 = time.perf_counter()
    mesh.spawn(_dp_runs, 2, device=str(dev), backend="gloo",
               args=(runs, workdir))
    spawn_s = time.perf_counter() - t0
    rank_launches = [json.load(open(os.path.join(workdir,
                                                 f"launches-{r}.json")))
                     for r in (0, 1)]
    launches = {}
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True  # see DP_SMALL
    for (name, entry, keys, _), (_, a), r0, r1 in zip(DP_SMALL, one,
                                                      *rank_launches):
        K.reset_launches()
        {"cli": cli.run, "paper_train": paper_train.run}[entry](a)
        single = K.LAUNCHES["gather_u8_normalize"]
        launches[f"dp2_{name}_rank0"] = r0
        launches[f"dp2_{name}_rank1"] = r1
        # rank 0 places the summary batch (one launch per uint8 key);
        # rank 1 does not
        check(r0 == single and r1 == single - keys,
              f"{name}: launches rank 0 {r0}, rank 1 {r1}, one process "
              f"{single}")
        tol = (dict(rtol=2e-2, atol=1e-2) if name == "vae"
               else dict(rtol=2e-3, atol=2e-5))
        worst = _compare_runs(
            f"{name} two ranks", os.path.join(workdir, name, "two"),
            os.path.join(workdir, name, "one"), tol,
            lambda phase, tag, name=name: 2e-2 if name == "vae" and (
                phase == "validate" or "grad_norm" in tag) else (
                1e-3 if "grad_norm" in tag else 5e-4))
        print(f"{name}: 2 gloo ranks on {card} (batch 4 each) vs one "
              f"process (batch 8): one call, max |diff| of params, BN "
              f"stats and optimizer state {worst:.3g} (allowed rtol "
              f"{tol['rtol']} / atol {tol['atol']}), losses within their "
              f"tolerance; launches rank 0 {r0}, rank 1 {r1}, one process "
              f"{single}", flush=True)
    torch.backends.cudnn.deterministic = deterministic
    print(f"phase 17 (a): the two ranks' four runs took {spawn_s:.1f} s "
          f"(process start included)", flush=True)

    full = full_width_argv(dev, os.path.join(workdir, "torchrun"),
                           count=count, eval_count=eval_count, image=64,
                           batch=batch, latent=200)
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node", "1", "-m", "hemx_torch.cli", *full,
           "--dtype", "bfloat16", "--epochs", "1", "--epoch_size",
           str(calls), "--summary_freq", "1"]
    t0 = time.perf_counter()
    r = subprocess.run(cmd, capture_output=True, text=True, timeout=300,
                       env={**os.environ, "PYTHONPATH": os.getcwd()})
    wall = time.perf_counter() - t0
    check(r.returncode == 0, f"torchrun failed ({r.returncode}):\n"
                             f"{r.stdout[-3000:]}\n{r.stderr[-3000:]}")
    s = json.loads(r.stdout.strip().splitlines()[-1])
    want = run_launches(count, eval_count, batch, calls)
    launches["torchrun_nccl_world1_iwgan_bf16"] = (
        s["input_kernel_launches"]["gather_u8_normalize"])
    check(s["processes"] == 1 and s["device"] == str(dev)
          and s["step"] == calls and s["global_batch"] == batch,
          f"torchrun summary {s}")
    check(launches["torchrun_nccl_world1_iwgan_bf16"] == want,
          f"torchrun: input kernel launched "
          f"{launches['torchrun_nccl_world1_iwgan_bf16']} times, expected "
          f"{want}")
    red = s["grad_all_reduce"]
    check(red["collectives"] > 0, f"no gradient all-reduce under torchrun: "
                                  f"{s}")
    med = s["median_call_s"]
    print(f"IWGAN bf16 bs{batch} 64x64x3 latent 200, 5+1, Adam through "
          f"torchrun (NCCL, world size 1) on {card}: median call {med:.4f} s "
          f"against phase 6's {bf16_median:.4f} s in this script "
          f"({100 * (med / bf16_median - 1):+.2f} %); "
          f"{red['bytes'] / s['calls'] / 1e6:.1f} MB all-reduced per call in "
          f"{red['collectives'] / s['calls']:.1f} collectives; "
          f"{launches['torchrun_nccl_world1_iwgan_bf16']} input-kernel "
          f"launches (expected {want}); the command took {wall:.1f} s",
          flush=True)
    return launches

def _state_bytes(ts) -> int:
    """Bytes of a train state's parameters and optimizer moments (a rank's
    slices under ``--model_parallel``)."""
    from hemx_torch.train.optimizers import Moments, Optimizer

    def walk(state) -> int:
        if isinstance(state, Moments):
            return sum(t.numel() * t.element_size() for t in state.values())
        if isinstance(state, dict):
            return sum(walk(v) for v in state.values())
        return 0
    opts = [ts.opt] if isinstance(ts.opt, Optimizer) else list(ts.opt.values())
    return (sum(p.numel() * p.element_size() for p in ts.nets.parameters())
            + sum(walk(o.state) for o in opts))


def _axis_runs(runs, out_dir: str) -> None:
    """Each argv of ``runs`` through ``cli.run`` in this rank of a process
    group; per run, its input-kernel launches, peak device memory, state
    bytes and summary line go to ``out_dir/axis-<rank>.json``."""
    import gc

    import torch
    import torch.distributed as dist

    from hemx_torch import cli
    from hemx_torch.ops import input_kernels as K
    torch.backends.cudnn.deterministic = True  # see DP_SMALL
    out = []
    for argv in runs:
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        K.reset_launches()
        res = cli.run(argv)
        out.append({"launches": K.LAUNCHES["gather_u8_normalize"],
                    "peak": torch.cuda.max_memory_allocated(),
                    "state_bytes": _state_bytes(res["train_state"]),
                    "summary": res["summary"]})
        del res
    with open(os.path.join(out_dir, f"axis-{dist.get_rank()}.json"),
              "w") as f:
        json.dump(out, f)


# phase 19 (b): one call of each on four gloo ranks of cuda:0, as hemx's
# (data=2, model=2) and (data=2, spatial=2) grids (batch 4 per data shard),
# and in one process at the global batch 8, with phase 17 (a)'s flags and
# tolerances
AXES_SMALL = [
    ("iwgan", ["--model", "iwgan", "--latent_size", "16", "--n_disc_train",
               "2", "--optimizer", "momentum", "--lr", "1e-3", "--momentum",
               "0.5"]),
    ("cnn", ["--model", "cnn", "--latent_size", "16", "--optimizer",
             "momentum", "--lr", "1e-3", "--momentum", "0.5"]),
]
AXES = ("model", "spatial")


def phase_axes_refused(torch, workdir: str) -> None:
    """(a) On a one-GPU host, ``--model_parallel 2`` and
    ``--spatial_parallel 2`` exit 1 with hemx's "does not divide 1
    device(s)"."""
    import contextlib
    import io

    from hemx_torch import cli
    n = torch.cuda.device_count()
    for axis in AXES:
        err = io.StringIO()
        with contextlib.redirect_stderr(err):
            code = cli.main(["--dataset", "synthetic", f"--{axis}_parallel",
                             "2", "--dir", os.path.join(workdir, "refused")])
        if n % 2 == 0:
            print(f"--{axis}_parallel 2 on {n} GPUs: not refused (exit "
                  f"{code})", flush=True)
            continue
        want = f"ERROR: --{axis}_parallel 2 does not divide {n} device(s)"
        check(code == 1 and err.getvalue().strip() == want,
              f"--{axis}_parallel 2: exit {code}, {err.getvalue()!r}")
        print(f"python -m hemx_torch.cli --{axis}_parallel 2: exit 1, "
              f"{want[7:]!r}, hemx's words", flush=True)


def phase_axes_small(torch, dev, card: str, workdir: str) -> dict:
    """(b) iwgan and cnn at phase 3's size on four gloo ranks of ``dev``
    under each axis against one process on ``dev`` at the global batch.
    Returns launches."""
    from hemx_torch import cli
    from hemx_torch.ops import input_kernels as K
    from hemx_torch.parallel import mesh

    def argv(flags, b, d, extra):
        return (["--dataset", "synthetic", "--synthetic_u8",
                 "--synthetic_count", "32", "--synthetic_eval_count", "16",
                 "--synthetic_shape", "32", "32", "3", "--epochs", "1",
                 "--epoch_size", "1", "--precision", "highest", "--device",
                 str(dev), "--seed", "3", "--batch_size", str(b), "--dir",
                 d] + flags + extra)

    runs = [argv(flags, 4, os.path.join(workdir, name, axis),
                 [f"--{axis}_parallel", "2"])
            for name, flags in AXES_SMALL for axis in AXES]
    t0 = time.perf_counter()
    mesh.spawn(_axis_runs, 4, device=str(dev), backend="gloo",
               args=(runs, workdir))
    spawn_s = time.perf_counter() - t0
    ranks = [json.load(open(os.path.join(workdir, f"axis-{r}.json")))
             for r in range(4)]
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True  # see DP_SMALL
    launches = {}
    for i, (name, flags) in enumerate(AXES_SMALL):
        K.reset_launches()
        cli.run(argv(flags, 8, os.path.join(workdir, name, "one"), []))
        single = K.LAUNCHES["gather_u8_normalize"]
        for j, axis in enumerate(AXES):
            got = [ranks[r][2 * i + j] for r in range(4)]
            counts = [g["launches"] for g in got]
            for r, c in enumerate(counts):
                launches[f"{name}_{axis}2_rank{r}"] = c
            # every rank gathers its rows (its band under spatial); rank 0
            # also places the summary batch
            check(counts == [single] + [single - 1] * 3,
                  f"{name} {axis}: launches {counts}, one process {single}")
            s = got[0]["summary"]
            check(s["processes"] == 4 and s["global_batch"] == 8
                  and s["axis"]["kind"] == axis and s["axis"]["data"] == 2,
                  f"{name} {axis}: summary {s}")
            tol = dict(rtol=2e-3, atol=2e-5)
            worst = _compare_runs(
                f"{name} data 2 x {axis} 2",
                os.path.join(workdir, name, axis),
                os.path.join(workdir, name, "one"), tol,
                lambda phase, tag: 1e-3 if "grad_norm" in tag else 5e-4)
            print(f"{name}: 4 gloo ranks on {card} as data 2 x {axis} 2 "
                  f"(batch 4 per data shard) vs one process (batch 8): one "
                  f"call, max |diff| of params, BN stats and optimizer "
                  f"state {worst:.3g} (allowed rtol {tol['rtol']} / atol "
                  f"{tol['atol']}), losses within their tolerance; "
                  f"launches {counts}, one process {single}; "
                  f"{s['axis']['collectives_per_call']:.0f} axis "
                  f"collectives, {s['axis']['bytes_per_call'] / 1e6:.2f} MB "
                  f"per call", flush=True)
    torch.backends.cudnn.deterministic = deterministic
    print(f"phase 19 (b): the four ranks' four runs took {spawn_s:.1f} s "
          f"(process start included)", flush=True)
    return launches


def phase_axes_full(torch, dev, card: str, workdir: str, *,
                    count: int = 1024, eval_count: int = 128,
                    batch: int = 128, image: int = 64, latent: int = 200,
                    calls: int = 2) -> dict:
    """(c) hemx's ``examples/multichip_scaling.config`` (the IWGAN at
    latent 200, 64x64x3, batch 128 per data shard, Adam(1e-4, 0.5, 0.9),
    5 critic steps) on two gloo ranks of ``dev``, once under
    ``--spatial_parallel 2`` and once under ``--model_parallel 2``
    (synthetic_count cut to ``count``, ``calls`` calls, a checkpoint),
    against one process at the same global batch. Returns launches."""
    import shutil as sh

    import numpy as np
    from hemx_torch import cli
    from hemx_torch.config import parse_args
    from hemx_torch.convert import flatten_tree
    from hemx_torch.ops import input_kernels as K
    from hemx_torch.parallel import mesh
    from hemx_torch.train.checkpoint import CheckpointManager
    config = os.path.join(os.getcwd(), "examples", "multichip_scaling.config")
    want_args = parse_args(["@" + config, "--device", str(dev)])
    check(want_args.model == "iwgan" and want_args.latent_size == 200
          and want_args.batch_size == 128 and want_args.n_disc_train == 5
          and want_args.optimizer == "adam" and want_args.spatial_parallel == 2,
          f"{config}: {vars(want_args)}")

    def argv(d, axis):
        return (["@" + config, "--synthetic_u8", "--synthetic_count",
                 str(count), "--synthetic_eval_count", str(eval_count),
                 "--synthetic_shape", str(image), str(image), "3",
                 "--batch_size", str(batch), "--latent_size", str(latent),
                 "--epochs", "1", "--epoch_size", str(calls), "--device",
                 str(dev), "--seed", "0", "--dir", d,
                 "--spatial_parallel", "2" if axis == "spatial" else "1",
                 "--model_parallel", "2" if axis == "model" else "1"])

    runs = [argv(os.path.join(workdir, axis), axis) for axis in AXES]
    t0 = time.perf_counter()
    mesh.spawn(_axis_runs, 2, device=str(dev), backend="gloo",
               args=(runs, workdir))
    spawn_s = time.perf_counter() - t0
    ranks = [json.load(open(os.path.join(workdir, f"axis-{r}.json")))
             for r in range(2)]
    torch.cuda.reset_peak_memory_stats()
    K.reset_launches()
    one = cli.run(argv(os.path.join(workdir, "one"), None))
    one_launches = K.LAUNCHES["gather_u8_normalize"]
    one_peak = torch.cuda.max_memory_allocated()
    one_state = _state_bytes(one["train_state"])
    one_s = one["summary"]
    del one
    want = run_launches(count, eval_count, batch, calls)
    check(one_launches == want, f"one process: {one_launches} launches, "
                                f"expected {want}")
    one_tree = flatten_tree(CheckpointManager(os.path.join(
        workdir, "one")).restore())
    launches = {}
    for j, axis in enumerate(AXES):
        got = [ranks[r][j] for r in range(2)]
        counts = [g["launches"] for g in got]
        for r, c in enumerate(counts):
            launches[f"multichip_{axis}2_rank{r}"] = c
        check(counts == [want, want - 1],
              f"{axis}: launches {counts}, expected [{want}, {want - 1}]")
        s = got[0]["summary"]
        check(s["step"] == calls and s["global_batch"] == batch
              and s["axis"]["kind"] == axis and s["axis"]["size"] == 2,
              f"{axis}: summary {s}")
        d = os.path.join(workdir, axis)
        tree = flatten_tree(CheckpointManager(d).restore())
        check(sorted(tree) == sorted(one_tree) and all(
            np.shape(tree[k]) == np.shape(one_tree[k]) for k in tree),
            f"{axis}: the checkpoint's tree or shapes differ from one "
            f"process's")
        for k, v in tree.items():
            if k[1:2] in (("params",), ("mstate",), ("opt",)):
                check(np.isfinite(np.asarray(v)).all(),
                      f"{axis}: {'/'.join(k)} not finite")
        from hemx_torch.summaries.reader import get_all_events
        losses = {t: [v for _, _, v in rows] for t, rows in get_all_events(
            os.path.join(d, "train")).items() if t.startswith("losses/")}
        check(losses and all(np.isfinite(v).all() for v in losses.values()),
              f"{axis}: losses {losses}")
        resumed = os.path.join(workdir, f"{axis}_resumed")
        sh.copytree(d, resumed)
        more = argv(resumed, None)
        more[more.index("--epochs") + 1] = "+1"
        more[more.index("--epoch_size") + 1] = "1"
        res = cli.run(more)
        check(res["resumed"] is not None and res["train_state"].step
              == calls + 1, f"{axis}: one process did not resume the run")
        del res
        ax = s["axis"]
        peaks = [g["peak"] for g in got]
        states = [g["state_bytes"] for g in got]
        print(f"multichip_scaling.config under --{axis}_parallel 2 (2 gloo "
              f"ranks on {card}, batch {batch} per data shard, "
              f"synthetic_count {count}, {calls} calls): first call "
              f"{s['first_call_s']:.3f} s, median of the rest "
              f"{s['median_call_s']:.3f} s (one process: "
              f"{one_s['first_call_s']:.3f} / {one_s['median_call_s']:.3f} "
              f"s); per call {ax['collectives_per_call']:.0f} axis "
              f"collectives, {ax['bytes_per_call'] / 1e9:.3f} GB, and "
              f"{s['grad_all_reduce']['collectives'] / calls:.1f} gradient "
              f"all-reduces, {s['grad_all_reduce']['bytes'] / calls / 1e9:.3f}"
              f" GB; per-rank peak device memory "
              f"{[round(p / 2**30, 3) for p in peaks]} GiB (one process "
              f"{one_peak / 2**30:.3f}); parameters and moments per rank "
              f"{[round(b / 2**20, 1) for b in states]} MiB (one process "
              f"{one_state / 2**20:.1f}, ratio "
              f"{max(states) / one_state:.3f}); launches {counts} (expected "
              f"{want}, {want - 1}); losses finite; checkpoint tree and "
              f"shapes a one-process run's, resumed by one process",
              flush=True)
        if axis == "model":
            check(max(states) < 0.6 * one_state,
                  f"model: a rank holds {max(states)} of {one_state} bytes "
                  f"of parameters and moments")
    print(f"phase 19 (c): the two ranks' two runs took {spawn_s:.1f} s "
          f"(process start included); gloo stages every collective on a "
          f"CUDA tensor through the host, so these times measure that the "
          f"axes are right, not what they would gain over NVLink",
          flush=True)
    return launches


def phase_band_kernel(torch, dev) -> list:
    """Phase 2's (and the axes' (d)) input kernel's height band against its
    plain version, bit for bit: 512 rows of 64x64x3 and 128 rows of 256x256x3, each in its
    two bands; device time with the L2 cache flushed before each launch,
    beside the bytes bound."""
    from hemx_torch.ops import input_kernels as K
    g = torch.Generator(device=dev)
    g.manual_seed(1)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev).zero_
    rows_out = []
    for side, n_ds, rows in ((64, 4096, 512), (256, 1024, 128)):
        ds = torch.randint(0, 256, (n_ds, side, side, 3), dtype=torch.uint8,
                           device=dev, generator=g)
        idx = torch.randperm(n_ds, device=dev, generator=g)[:rows]
        whole = K.gather_u8_normalize_ref(ds, idx, -1.0, 1.0)
        for h0, h1 in ((0, side // 2), (side // 2, side)):
            a = K.gather_u8_normalize(ds, idx, -1.0, 1.0, rows=(h0, h1))
            b = K.gather_u8_normalize_ref(ds, idx, -1.0, 1.0, rows=(h0, h1))
            torch.cuda.synchronize()
            check(a.shape == (rows, 3, h1 - h0, side) and a.is_contiguous(
                memory_format=torch.channels_last),
                f"band kernel output {tuple(a.shape)}")
            check(torch.equal(a, b) and torch.equal(a, whole[:, :, h0:h1]),
                  f"band ({h0}, {h1}) of {side}x{side}x3: kernel and plain "
                  f"differ by {(a - b).abs().max().item()}")
            ms = _device_ms(torch, lambda: K.gather_u8_normalize(
                ds, idx, -1.0, 1.0, rows=(h0, h1)), flush=flush)
            plain = _device_ms(torch, lambda: K.gather_u8_normalize_ref(
                ds, idx, -1.0, 1.0, rows=(h0, h1)), flush=flush)
            band = (h1 - h0) * side * 3
            moved = rows * (band * 5 + idx.element_size())
            bound = moved / HBM_BYTES_PER_S * 1e3
            rows_out.append({"rows": f"{rows}x{side}x{side}x3",
                             "band": [h0, h1], "band_bytes": band,
                             "max_abs_err": 0.0, "device_ms": ms,
                             "plain_device_ms": plain, "bound_ms": bound})
            print(f"gather_u8_normalize band rows ({h0}, {h1}) of {rows}x"
                  f"{side}x{side}x3 ({band} B of each row): bit-equal to "
                  f"the plain version and to the whole gather's rows; "
                  f"device time (torch.profiler, 20 calls, L2 flushed "
                  f"before each) kernel {ms:.4f} ms, plain {plain:.4f} ms; "
                  f"bound {bound:.4f} ms ({moved / 1e6:.2f} MB at 3.35 "
                  f"TB/s), kernel at {100 * bound / ms:.0f} % of it",
                  flush=True)
    return rows_out


def phase_axes(torch, dev, card: str, workdir: str) -> dict:
    """Phase 19: (a) the refusals on one card, (b) card runs of the two
    axes at a small size against one process, (c) the multichip_scaling
    config at full width under each axis ((d), the input kernel's band,
    runs in phase 2). Returns launches."""
    phase_axes_refused(torch, workdir)
    launches = {f"small_{k}": v for k, v in phase_axes_small(
        torch, dev, card, os.path.join(workdir, "small")).items()}
    launches.update(phase_axes_full(torch, dev, card,
                                    os.path.join(workdir, "full")))
    return launches


def _median_s(fn, n: int = 3) -> float:
    """The median host seconds of ``n`` runs of ``fn``."""
    secs = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        secs.append(time.perf_counter() - t0)
    return statistics.median(secs)


def phase_native(card: str, workdir: str, *, mib: int = 64,
                 record: int = 12288) -> dict:
    """Phase 20: ``hemx_torch.native`` built into a fresh directory, its
    records and errors against the plain walks, and seconds per MiB of
    each path on this host (the median of 3 runs; the plain CRC over 1
    MiB). Returns the line of figures."""
    import numpy as np

    from hemx_torch import native
    from hemx_torch.data import tfrecord as T
    from hemx_torch.summaries import crc32c as C

    build_dir = os.path.join(workdir, "build")
    t0 = time.perf_counter()
    mod = native.load(build_dir=build_dir)
    build_s = time.perf_counter() - t0
    check(os.path.dirname(mod.__file__) == build_dir,
          f"built {mod.__file__}, not into {build_dir}")
    gxx = subprocess.run(["g++", "--version"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.splitlines()[0]
    print(f"hemx_torch.native built into a fresh directory in {build_s:.2f} "
          f"s by {gxx}", flush=True)

    n = -(-mib * 2 ** 20 // record)
    blob = np.random.default_rng(0).integers(0, 256, n * record,
                                             dtype=np.uint8).tobytes()
    recs = [blob[i * record:(i + 1) * record] for i in range(n)]
    size_mib = n * record / 2 ** 20
    native_file = os.path.join(workdir, "native.tfrecords")
    py_file = os.path.join(workdir, "python.tfrecords")

    def write_py():
        with T.TFRecordWriter(py_file) as w:
            for r in recs:
                w.write(r)

    secs = {"write_native": _median_s(
                lambda: mod.write_records(native_file, recs)),
            "write_python": _median_s(write_py)}
    with open(native_file, "rb") as f, open(py_file, "rb") as g:
        check(f.read() == g.read(), "write_records and TFRecordWriter wrote "
                                    "different bytes")
    for verify in (False, True):
        tag = "verified" if verify else "unverified"
        check(mod.read_all_records(native_file, verify) == recs
              and T.read_all_records(native_file, verify) == recs
              and list(T.tfrecord_iterator(native_file, verify)) == recs,
              f"{tag} reads differ from the records written")
        secs[f"read_{tag}_native"] = _median_s(
            lambda: mod.read_all_records(native_file, verify))
        secs[f"read_{tag}_python"] = _median_s(
            lambda: list(T.tfrecord_iterator(native_file, verify)))
    check(T.count_records(native_file) == mod.count_records(native_file)
          == T._py_count_records(native_file) == n,
          f"counts differ from {n}")
    per_mib = {k: v / size_mib for k, v in secs.items()}
    crc_blob = blob[:2 ** 20]
    per_mib["crc32c_native"] = _median_s(lambda: mod.crc32c(blob)) / size_mib
    per_mib["crc32c_python"] = _median_s(lambda: C._py_crc32c(crc_blob))
    check(mod.crc32c(crc_blob) == C._py_crc32c(crc_blob),
          "crc32c: native and plain differ")

    # the errors, on the first three records
    small = os.path.join(workdir, "small.tfrecords")
    mod.write_records(small, recs[:3])
    with open(small, "rb") as f:
        data = f.read()
    last = 2 * (record + 16)
    bad = bytearray(data)
    bad[12 + record // 2] ^= 1
    with open(small, "wb") as f:
        f.write(bytes(bad))
    for read in (lambda p: mod.read_all_records(p, True),
                 lambda p: list(T.tfrecord_iterator(p, True))):
        try:
            read(small)
        except OSError as e:
            check("corrupt" in str(e), f"flipped byte: {e}")
        else:
            check(False, "a flipped payload byte passed verify")
    paths = {"C++ reader": lambda p: mod.read_all_records(p),
             "C++ counter": mod.count_records,
             "plain iterator": lambda p: list(T.tfrecord_iterator(p))}
    for where, cut in (("header CRC", last + 10),
                       ("payload", last + 12 + record // 2),
                       ("data CRC", last + 12 + record + 2)):
        with open(small, "wb") as f:
            f.write(data[:cut])
        for name, fn in paths.items():
            try:
                fn(small)
            except OSError as e:
                check("truncated" in str(e), f"{name}, cut in the {where}: "
                                             f"{e}")
            else:
                check(False, f"{name}: a cut in the last record's {where} "
                             f"passed")
    with open(small, "wb") as f:
        f.write(data[:last + 5])  # inside the last record's length
    check(mod.read_all_records(small) == recs[:2]
          and list(T.tfrecord_iterator(small)) == recs[:2]
          and mod.count_records(small) == 2,
          "a cut inside the length field is not a clean end")
    print(f"hemx_torch.native on {n} records of {record} B ({size_mib:.1f} "
          f"MiB) on the host of {card}: write_records = TFRecordWriter "
          f"byte for byte; C++ reads (verified or not) and counts = the "
          f"plain walks; a flipped byte raises under verify; cuts in the "
          f"header CRC, payload and data CRC raise truncated in the C++ "
          f"reader, the C++ counter and the plain iterator; a cut in the "
          f"length field is a clean end in all three", flush=True)
    print("seconds per MiB: " + ", ".join(f"{k} {v:.6f}"
                                          for k, v in per_mib.items()),
          flush=True)
    return {"card": card, "gxx": gxx, "build_s": build_s, "records": n,
            "record_bytes": record, "mib": size_mib,
            "s_per_mib": per_mib}


def _tool_run(dev, d: str, model: str) -> None:
    """A tiny run on the card for phase 18 (a): 32 px, batch 8, latent 16,
    ``--precision highest``, sgd, 2 calls."""
    from hemx_torch import cli
    cli.run(["--model", model, "--dataset", "synthetic", "--synthetic_u8",
             "--synthetic_count", "64", "--synthetic_eval_count", "16",
             "--synthetic_shape", "32", "32", "3", "--batch_size", "8",
             "--latent_size", "16", "--precision", "highest", "--optimizer",
             "sgd", "--lr", "1e-3", "--epochs", "1", "--epoch_size", "2",
             "--examples", "8", "--seed", "0", "--device", str(dev), "--dir",
             d])


def phase_tools_card_vs_cpu(torch, dev, workdir: str) -> None:
    """Phase 18 (a): the post-training tools' device work, card against
    CPU, on a tiny cnn run and a tiny gan run trained on the card (f32,
    TF32 off): every 4-D capture of the visualized net at rtol 2e-3 / atol
    2e-5 (phase 3's f32 gates); the bestfit ascent from the same start
    images, its first step at rtol 1e-4 / atol 1e-5 and its 20-step images,
    min/max normalized, within 2/255 (the ascent feeds each step's rounding
    into the next; on first-layer filters the port's and hemx's stay within
    2/255, ``tests/test_torch_visualize.py``); the CNN's encoder and the
    pixel features at 2e-3 / 2e-5, and the train-vs-validate FID from each
    side's features at rtol 1e-3."""
    import numpy as np
    from hemx_torch import visualize as V
    from hemx_torch.data.pipeline import place_batch
    from hemx_torch.metrics import fid as F
    for name, layer in (("cnn", "encoder/c1"), ("gan", "c1")):
        d = os.path.join(workdir, name)
        _tool_run(dev, d, name)
        runs = {side: V.load_run(d, side) for side in (str(dev), "cpu")}
        caps = {}
        for side, r in runs.items():
            r.ts.nets.eval()
            caps[side] = {k: v.float().cpu().numpy()
                          for k, v in V.capture_layers(r).items()}
        check(sorted(caps[str(dev)]) == sorted(caps["cpu"]) != [],
              f"{name}: captures {sorted(caps[str(dev)])} vs "
              f"{sorted(caps['cpu'])}")
        worst = 0.0
        for k, want in caps["cpu"].items():
            _close(caps[str(dev)][k], want, 2e-3, 2e-5, f"{name} capture {k}")
            worst = max(worst, float(np.max(np.abs(caps[str(dev)][k] - want))))
        c, h, w = runs["cpu"].model.input_shape(runs["cpu"].batch)
        g = torch.Generator()
        g.manual_seed(3)
        starts = torch.rand((4, c, h, w), generator=g) * 0.2 + 0.4
        imgs = {}
        for steps in (1, 20):
            for side, r in runs.items():
                imgs[side] = [x.float().cpu().numpy() for x in
                              V.bestfit_images(r, layer, 4, starts,
                                               steps=steps)]
            for i, (a, b) in enumerate(zip(imgs[str(dev)], imgs["cpu"])):
                if steps == 1:
                    _close(a, b, 1e-4, 1e-5, f"{name} bestfit step 1 [{i}]")
                    continue
                norm = lambda x: (x - x.min()) / max(x.max() - x.min(), 1e-12)  # noqa: E731
                diff = float(np.max(np.abs(norm(a) - norm(b))))
                check(diff <= 2 / 255, f"{name} bestfit {layer} [{i}]: "
                                       f"normalized images {diff:.4g} apart")
        line = (f"card vs cpu, {name} tools (32 px, batch 8, highest): "
                f"{len(caps['cpu'])} captures, max |cuda-cpu| {worst:.3g}; "
                f"bestfit {layer} x4, 20 steps, within 2/255")
        if name == "cnn":
            feats = {}
            for side, r in runs.items():
                rows = {sp: place_batch(next(r.splits[sp].iter_epoch(
                    r.splits[sp].count, shuffle=False)), r.splits[sp],
                    r.device, r.model.batch_keys)["image"]
                    for sp in ("train", "validate")}
                enc = F.encoder_features(r.model, r.ts)
                feats[side] = {(kind, sp): fn(x) for sp, x in rows.items()
                               for kind, fn in (("encoder", enc),
                                                ("pixel", F.pixel_features))}
            fids = {}
            for key, want in feats["cpu"].items():
                _close(feats[str(dev)][key], want, 2e-3, 2e-5,
                       f"cnn {key} features")
            for kind in ("encoder", "pixel"):
                fids[kind] = {side: F.fid_from_features(
                    f[(kind, "train")], f[(kind, "validate")])
                    for side, f in feats.items()}
                _close(fids[kind][str(dev)], fids[kind]["cpu"], 1e-3, 0.0,
                       f"cnn {kind} FID train vs validate")
            line += "; train-vs-validate FID cuda / cpu: " + ", ".join(
                f"{k} {v[str(dev)]:.6g} / {v['cpu']:.6g}"
                for k, v in fids.items())
        print(line, flush=True)


def _png_ok(path: str) -> tuple:
    from hemx_torch.data.imageio import decode_image
    with open(path, "rb") as f:
        img = decode_image(f.read(), 0)
    check(img.size > 0, f"{path} decodes to nothing")
    return img.shape


def phase_tools(torch, dev, card: str, workdir: str, iwgan_dir: str,
                cnn_dir: str, splits: dict, thesis_dir: str) -> dict:
    """Phase 18 (b) and (c): the post-training tools at full width on phase
    6's bf16 IWGAN run and phase 8's bf16 cnn run (both on ``splits``,
    phases 4-8's synthetic set), then the host-only tools on phase 11's
    runs. Returns {path: input-kernel launches}."""
    import threading
    import urllib.error
    import urllib.parse
    import urllib.request

    import numpy as np
    from hemx_torch import events, paper_visualize, visualize as V
    from hemx_torch import visualize_gui as gui
    from hemx_torch.data.pipeline import DeviceDataPipeline
    from hemx_torch.metrics import fid as F
    from hemx_torch.ops import input_kernels as K
    launches = {}
    # one placement of the run's first global batch per tool that feeds a
    # net images: the GAN's timelapse, activations and bestfit; the CNN's
    # samples (reconstructions) besides
    for name, d, want in (("iwgan", iwgan_dir, 3), ("cnn", cnn_dir, 4)):
        K.reset_launches()
        t0 = time.perf_counter()
        out = V.run(["--dir", d, "--sample", "--timelapse", "--activations",
                     "--weights", "--bestfit", "--device", str(dev)])
        wall = time.perf_counter() - t0
        n = K.LAUNCHES["gather_u8_normalize"]
        check(n == want, f"visualize {name}: input kernel launched {n}, "
                         f"expected {want}")
        launches[f"visualize_{name}"] = n
        files = sorted(os.listdir(out["out_dir"]))
        shapes = {f: _png_ok(os.path.join(out["out_dir"], f)) for f in files}
        check(any(f.startswith("bestfit-") for f in files)
              and "samples.png" in files and any(
                  f.startswith("timelapse-") for f in files),
              f"visualize {name}: files {files}")
        print(f"visualize {name} (full width, bf16) on {card}: {wall:.2f} s "
              f"with the run's loading; per tool " + ", ".join(
                  f"{k} {v:.2f} s" for k, v in out["seconds"].items())
              + f"; {len(files)} PNGs, each decodes: "
              + ", ".join(f"{f} {shapes[f][0]}x{shapes[f][1]}"
                          for f in files), flush=True)

    # FID: 4,096 real images (the train split through the device cache, one
    # gather) against 4,096 IWGAN samples, pixel and encoder features
    K.reset_launches()
    t0 = time.perf_counter()
    real = [b["image"] for b in DeviceDataPipeline(
        splits["train"], 512, device=dev, keys=("image",), shuffle=False,
        group=8).epoch(0)]
    val = [b["image"] for b in DeviceDataPipeline(
        splits["validate"], 512, device=dev, keys=("image",), shuffle=False,
        group=2).epoch(0)]
    n = K.LAUNCHES["gather_u8_normalize"]
    check(n == 2 and len(real) == 8 and len(val) == 2,
          f"FID: {n} input launches for {len(real)} + {len(val)} batches, "
          f"expected 2 for 8 + 2")
    launches["fid_real"] = n
    gan = V.load_run(iwgan_dir, dev)
    enc = V.load_run(cnn_dir, dev)
    gan.ts.nets.eval()
    enc.ts.nets.eval()
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    fake = [gan.model.sample(gan.ts, 512, z=torch.randn(
        (512, gan.args.latent_size), generator=gen, device=dev)).float()
        for _ in range(8)]
    encoder = F.encoder_features(enc.model, enc.ts)
    feats = {}
    for label, chunks in (("real", real), ("fake", fake), ("validate", val)):
        feats[("pixel", label)] = np.concatenate(
            [F.pixel_features(x) for x in chunks])
        feats[("encoder", label)] = np.concatenate([encoder(x) for x in chunks])
    torch.cuda.synchronize(dev)
    t_feat = time.perf_counter() - t0
    t1 = time.perf_counter()
    out = {}
    for kind in ("pixel", "encoder"):
        out[kind] = F.fid_from_features(feats[(kind, "real")],
                                        feats[(kind, "fake")])
        out[f"{kind}_floor"] = F.fid_from_features(feats[(kind, "real")],
                                                   feats[(kind, "validate")])
        mu, sigma = F.gaussian_stats(feats[(kind, "real")])
        self_fid = F.frechet_distance(mu, sigma, mu, sigma)
        check(abs(self_fid) < 1e-6 * np.trace(sigma),
              f"{kind} FID of a set against itself {self_fid:.3g}, trace "
              f"{np.trace(sigma):.3g}")
        out[f"{kind}_self"] = self_fid
    t_dist = time.perf_counter() - t1
    check(all(math.isfinite(v) for v in out.values()),
          f"non-finite FID {out}")
    trace = _traced(torch, dev, lambda: V.bestfit_images(gan, "c1", 16))
    print(f"IWGAN bestfit c1 (16 filters x 20 steps, bf16) traced on {card}: "
          f"{trace['traced_ms']:.1f} ms, {trace['launches']} device "
          f"operations, {trace['kernel_ms']:.1f} ms of them, busy "
          f"{100 * trace['busy']:.1f} %", flush=True)
    check(all(np.all(np.isfinite(f)) for f in feats.values()),
          "non-finite features")
    print(f"FID on {card}: 4,096 real (train) vs 4,096 IWGAN bf16 samples "
          f"(512-row chunks): pixel {out['pixel']:.6g} (train vs 1,024 "
          f"validate floor {out['pixel_floor']:.6g}), encoder (phase 8's "
          f"CNN, {feats[('encoder', 'real')].shape[1]}-d latent) "
          f"{out['encoder']:.6g} (floor {out['encoder_floor']:.6g}); self "
          f"FID pixel {out['pixel_self']:.3g}, encoder "
          f"{out['encoder_self']:.3g}; gather + sampling + features "
          f"{t_feat:.2f} s (two run loadings among them), statistics and "
          f"distances {t_dist:.2f} s",
          flush=True)

    # (c) host-only tools: matplotlib only draws here
    try:
        import matplotlib
        mpl = matplotlib.__version__
    except ImportError:
        mpl = None
    print(f"matplotlib on this host: {mpl or 'not installed'}", flush=True)
    charts = os.path.join(workdir, "charts")
    os.makedirs(charts)
    runs = {"cgan/mean_adjusted": "cgan", "standalone/mean_provided":
            "standalone", "sampler/baseline_e4-512": "sampler_e4_512"}
    root = os.path.join(workdir, "thesis_root")
    for dst, src in runs.items():
        os.makedirs(os.path.dirname(os.path.join(root, dst)), exist_ok=True)
        os.symlink(os.path.join(thesis_dir, src), os.path.join(root, dst))
    if mpl:
        t0 = time.perf_counter()
        V.run(["--dir", iwgan_dir, "--loss", "--device", str(dev)])
        check(os.path.getsize(os.path.join(iwgan_dir, "visualize",
                                           "loss.pdf")) > 0, "no loss.pdf")
        check(events.main([os.path.join(thesis_dir, "cgan"),
                           os.path.join(thesis_dir, "standalone"), "--out",
                           os.path.join(charts, "losses.pdf")]) == 0,
              "events.main failed")
        series = {}
        for e in ("1", "1b", "2"):
            fn = {"1": paper_visualize.render_experiment1,
                  "1b": paper_visualize.render_experiment1b,
                  "2": paper_visualize.render_experiment2}[e]
            series[e] = fn(root, os.path.join(charts, f"experiment{e}.pdf"))
        check(all(v > 0 for v in series.values()),
              f"paper_visualize series {series}")
        print(f"host tools: visualize --loss, events.main, paper_visualize "
              f"1 / 1b / 2 ({series['1']} / {series['1b']} / {series['2']} "
              f"series) in {time.perf_counter() - t0:.2f} s", flush=True)
    httpd, n_runs = gui.make_server(thesis_dir, 0)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"

    def get(path):
        try:
            with urllib.request.urlopen(base + path, timeout=60) as r:
                return r.status, r.read()
        except urllib.error.HTTPError as e:
            return e.code, e.read()
    try:
        runs_found = gui.discover_runs(thesis_dir)
        i = runs_found.index(os.path.join(thesis_dir, "cgan"))
        code, page = get("/")
        check(code == 200 and b"/run/0" in page, f"GUI /: {code}")
        code, page = get(f"/run/{i}")
        check(code == 200 and b"losses/d_loss" in page, f"GUI /run/{i}: {code}")
        images = [t for t in gui.get_tag_index(os.path.join(
            runs_found[i], "train"))["images"]]
        check(images != [], "phase 11's cgan run has no image summaries")
        tag = urllib.parse.quote(images[0], safe="")
        code, page = get(f"/images?run={i}&phase=train&tag={tag}")
        check(code == 200 and b"/image.png?" in page, f"GUI /images: {code}")
        step = re.search(rb"step=(\d+)", page).group(1).decode()
        code, png = get(f"/image.png?run={i}&phase=train&tag={tag}&step={step}")
        check(code == 200 and png[:8] == b"\x89PNG\r\n\x1a\n",
              f"GUI /image.png: {code}")
        for bad in ("/run/-1", f"/run/{n_runs}", "/chart?run=-1&phase=train"
                    "&tag=x"):
            check(get(bad)[0] == 404, f"GUI {bad} is not a 404")
        if mpl:
            code, png = get(f"/chart?run={i}&phase=train&tag=losses%2Fd_loss")
            check(code == 200 and png[:8] == b"\x89PNG\r\n\x1a\n",
                  f"GUI /chart: {code}")
        print(f"GUI on 127.0.0.1: {n_runs} runs of phase 11; /, /run/{i}, "
              f"/images, /image.png, 404s"
              + (", /chart" if mpl else "") + " as expected", flush=True)
    finally:
        httpd.shutdown()
        httpd.server_close()
    return launches


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    try:
        import hemx_torch  # noqa: F401
    except ImportError:
        print("chip_smoke: hemx_torch not importable; run from the root of "
              "a hemx checkout", file=sys.stderr)
        return 1
    dev = torch.device("cuda:0")
    workdir = tempfile.mkdtemp(prefix="chip_smoke_")
    marks = [time.perf_counter()]

    def stage(title: str) -> None:
        now = time.perf_counter()
        print(f"== {title} (the previous phase took {now - marks[-1]:.1f} s)",
              flush=True)
        marks.append(now)
    try:
        stage("phase 1: card")
        card = phase_card(torch)
        stage("phase 2: kernel vs plain")
        kern = phase_kernel(torch, dev)
        stage("phase 3: card vs cpu, small size")
        phase_card_vs_cpu(torch, dev)
        stage("phase 4: the slice at full width")
        run64 = synthetic_run(dev)
        launches = phase_full_width(torch, dev, card,
                                    os.path.join(workdir, "f32"), run64)
        stage("phase 5: card vs cpu, bf16 + rmsprop, small size")
        phase_bf16_card_vs_cpu(torch, dev)
        stage("phase 6: the whole bf16 run at full width, with resume")
        launches_bf16, bf16_median = phase_bf16_run(
            torch, dev, card, os.path.join(workdir, "bf16"), run64)
        stage("phase 7: card vs cpu, gan/wgan/cnn/vae, small size")
        phase_zoo_card_vs_cpu(torch, dev)
        stage("phase 8: gan/wgan/cnn/vae at full width in bf16, with "
              "resume")
        launches_zoo = phase_zoo_bf16_runs(torch, dev, card,
                                           os.path.join(workdir, "zoo"), run64)
        stage("phase 9: the data layer at full width")
        data_dir = os.path.join(workdir, "data")
        launches_data = phase_data(torch, dev, card, data_dir)
        stage("phase 10: card vs cpu, the depth models at 65x65")
        phase_depth_card_vs_cpu(torch, dev)
        stage("phase 11: the thesis slice at full width through "
              "hemx_torch.paper_train")
        launches_thesis = phase_thesis(
            torch, dev, card, os.path.join(workdir, "thesis"),
            os.path.join(data_dir, "nyu_raw"), os.path.join(data_dir, "store"))
        stage("phase 12: card vs cpu, improved_sampler, the estimator and "
              "the experimental sampler")
        phase_slice_card_vs_cpu(torch, dev)
        stage("phase 13: the second generation at full width through its "
              "entry points")
        launches_slice = phase_slice(
            torch, dev, card, os.path.join(workdir, "slice"),
            os.path.join(workdir, "thesis", "cgan"))
        stage("phase 14: card vs cpu, pix2pix, artist and info_gan")
        phase_zoo_rest_card_vs_cpu(torch, dev)
        stage("phase 15: pix2pix, artist and info_gan at full width "
              "through the CLI")
        launches_zoo_rest = phase_zoo_rest(torch, dev, card,
                                           os.path.join(workdir, "zoo_rest"))
        stage("phase 16: celeb and coco at full width")
        launches_celeb_coco = phase_celeb_coco(
            torch, dev, card, os.path.join(workdir, "celeb_coco"))
        stage("phase 17: data parallel, two gloo ranks and torchrun")
        launches_dp = phase_data_parallel(
            torch, dev, card, os.path.join(workdir, "dp"), bf16_median)
        stage("phase 18: the post-training tools")
        tools = os.path.join(workdir, "tools")
        phase_tools_card_vs_cpu(torch, dev, tools)
        launches_tools = phase_tools(
            torch, dev, card, tools, os.path.join(workdir, "bf16"),
            os.path.join(workdir, "zoo", "cnn"), run64.splits,
            os.path.join(workdir, "thesis"))
        stage("phase 19: the model and spatial axes")
        launches_axes = phase_axes(torch, dev, card,
                                   os.path.join(workdir, "axes"))
        stage("phase 20: the native reader")
        native_io = phase_native(card, os.path.join(workdir, "native"))
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    by_phase = {"phase4_iwgan_f32": launches, "phase6_iwgan_bf16": launches_bf16,
                **{f"phase8_{k}_bf16": v for k, v in launches_zoo.items()},
                **{f"phase9_{k}": v for k, v in launches_data.items()},
                **{f"phase11_{k}": v for k, v in launches_thesis.items()},
                **{f"phase13_{k}": v for k, v in launches_slice.items()},
                **{f"phase15_{k}": v for k, v in launches_zoo_rest.items()},
                **{f"phase16_{k}": v for k, v in launches_celeb_coco.items()},
                **{f"phase17_{k}": v for k, v in launches_dp.items()},
                **{f"phase18_{k}": v for k, v in launches_tools.items()},
                **{f"phase19_{k}": v for k, v in launches_axes.items()}}
    print(json.dumps({"native_io": native_io}), flush=True)
    print(json.dumps({"kernels": [{
        "name": "gather_u8_normalize", "route": "cuda",
        "source": "hemx_torch/csrc/gather_u8_normalize.cu",
        "replaces": "hemx/ops/pallas_kernels.py:75",
        "launches": sum(by_phase.values()), "launches_by_phase": by_phase,
        **kern}]}), flush=True)
    print(f"phase 20 took {time.perf_counter() - marks[-1]:.1f} s; the script "
          f"{time.perf_counter() - marks[0]:.1f} s", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
