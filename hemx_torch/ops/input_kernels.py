"""Fused gather + uint8->float normalize: the input kernel of the training path.

Replaces the TPU kernel ``hemx/ops/pallas_kernels.py::u8_normalize_pallas``
(its ``pl.pallas_call`` at line 75, body ``_norm_kernel``) and the jnp
``u8_normalize`` that ``hemx.data.pipeline.DeviceDataPipeline`` runs after
its ``jnp.take`` gather. Both compute ``float(x) * (hi - lo) / 255 + lo``.

What bounds it on an H100: bytes. It reads G*B*H*W*C uint8 and writes four
times that in float32, with no reuse and two flops per element, so the
only lever is to touch each byte once. The design therefore fuses the
gather into the normalize: each program loads its own dataset row index,
reads that row's H*W*C contiguous bytes and writes the normalized floats
straight to the output row, in the same physical NHWC order (which is the
``torch.channels_last`` layout of the logical NCHW batch). There is no
gathered uint8 intermediate and no relayout. The Pallas kernel's
``(rows, 128)`` view is deliberately not carried over: on the TPU that view
forced a relayout of the NHWC input that made the kernel 20x slower than
XLA's fused convert (``pallas_kernels.py:9-22``).

Triton rather than CUDA C++: a streaming elementwise pass with one indexed
load per row needs no tensor cores, shared-memory staging or warp
specialisation; Triton's masked vector loads and stores reach DRAM
bandwidth, and it compiles at first launch without an nvcc build step.

A height band (``rows=(h0, h1)``): under ``--spatial_parallel`` a rank
needs only rows ``[h0, h1)`` of each image (``hemx.parallel.mesh
.batch_spec`` shards height). In NHWC those are one contiguous run of
``(h1-h0)*W*C`` bytes at offset ``h0*W*C`` of each dataset row, so the band
is the same kernel with a row offset and a shorter row: each program reads
only the band's bytes and writes a (R, C, h1-h0, W) batch. The default is
the whole height.

Dispatch: a tensor on the CPU takes the plain PyTorch version
(:func:`gather_u8_normalize_ref`); a CUDA tensor launches the kernel or
raises — there is no fallback.
"""

from __future__ import annotations

import os
from pathlib import Path

import torch

#: Launches of each hand-written kernel, counted where the kernel launches
#: (and nowhere else) so a run can show that it went through the kernel.
LAUNCHES = {"gather_u8_normalize": 0}

_BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
_KERNEL = None


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def gather_u8_normalize_ref(ds: torch.Tensor, idx: torch.Tensor,
                            lo: float = 0.0, hi: float = 1.0,
                            rows: tuple | None = None) -> torch.Tensor:
    """Plain PyTorch version: gather rows ``idx`` of the uint8 NHWC dataset
    ``ds`` (image rows ``[h0, h1)`` of each with ``rows=(h0, h1)``) and
    normalize to ``[lo, hi]``; returns (R, C, h1-h0, W) float32 in
    channels_last memory. ``scale`` is the Python float ``(hi-lo)/255.0``
    exactly as in ``hemx.ops.pallas_kernels.u8_normalize``."""
    scale = (hi - lo) / 255.0
    h0, h1 = _band(ds, rows)
    return (ds[:, h0:h1].index_select(0, idx).permute(0, 3, 1, 2).float()
            * scale + lo)


def _band(ds: torch.Tensor, rows) -> tuple[int, int]:
    h = ds.shape[1]
    h0, h1 = (0, h) if rows is None else (int(rows[0]), int(rows[1]))
    if not 0 <= h0 < h1 <= h:
        raise ValueError(f"rows {rows} is not a band of height {h}")
    return h0, h1


def _check(ds: torch.Tensor, idx: torch.Tensor) -> None:
    if ds.dtype != torch.uint8 or ds.dim() != 4:
        raise ValueError(f"ds must be a uint8 (N, H, W, C) tensor; got "
                         f"{ds.dtype} {tuple(ds.shape)}")
    if idx.dtype not in (torch.int32, torch.int64) or idx.dim() != 1:
        raise ValueError(f"idx must be a 1-D int32/int64 tensor; got "
                         f"{idx.dtype} {tuple(idx.shape)}")
    if idx.device != ds.device:
        raise ValueError(f"ds on {ds.device} but idx on {idx.device}")


def _kernel():
    """Build (once) and return the Triton kernel. Triton is imported here,
    never at module import, and caches its compiled binaries under
    ``hemx_torch/_build/triton`` unless TRITON_CACHE_DIR is already set."""
    global _KERNEL
    if _KERNEL is not None:
        return _KERNEL
    os.environ.setdefault("TRITON_CACHE_DIR", str(_BUILD_DIR / "triton"))
    import triton
    import triton.language as tl

    @triton.jit
    def gather_u8_normalize_kernel(ds_ptr, idx_ptr, out_ptr, row_elems,
                                   band_start, band_elems, scale, lo,
                                   BLOCK: tl.constexpr):
        # grid = (gathered rows, blocks per band); one program normalizes
        # BLOCK contiguous bytes of one dataset row's band, which starts
        # band_start bytes into the row (0 and row_elems: the whole row)
        row = tl.program_id(0)
        blk = tl.program_id(1)
        src = tl.load(idx_ptr + row).to(tl.int64)
        offs = blk * BLOCK + tl.arange(0, BLOCK)
        mask = offs < band_elems
        x = tl.load(ds_ptr + src * row_elems + band_start + offs, mask=mask,
                    other=0)
        y = x.to(tl.float32) * scale + lo
        tl.store(out_ptr + row.to(tl.int64) * band_elems + offs, y,
                 mask=mask)

    _KERNEL = (triton, gather_u8_normalize_kernel)
    return _KERNEL


def gather_u8_normalize(ds: torch.Tensor, idx: torch.Tensor,
                        lo: float = 0.0, hi: float = 1.0,
                        rows: tuple | None = None) -> torch.Tensor:
    """``ds[idx]`` normalized from uint8 to float32 ``[lo, hi]``.

    ``ds``: contiguous uint8 (N, H, W, C); ``idx``: (R,) int32/int64 row
    indices, each in ``[0, N)`` (the caller's contract: the kernel does not
    bounds-check them); ``rows``: the band ``(h0, h1)`` of image rows to
    read, default the whole height. Returns (R, C, h1-h0, W) float32 in
    channels_last memory; split it into batches with ``torch.split``
    (views, no copy).
    """
    _check(ds, idx)
    if ds.device.type == "cpu":
        return gather_u8_normalize_ref(ds, idx, lo, hi, rows)
    if ds.device.type != "cuda":
        raise ValueError(f"gather_u8_normalize: unsupported device {ds.device}")
    if not ds.is_contiguous():
        raise ValueError("gather_u8_normalize: ds must be contiguous")
    h0, h1 = _band(ds, rows)
    triton, kernel = _kernel()
    n, h, w, c = ds.shape
    count = idx.numel()
    band_elems = (h1 - h0) * w * c
    out = torch.empty((count, h1 - h0, w, c), dtype=torch.float32,
                      device=ds.device)
    if count:
        block = min(4096, triton.next_power_of_2(band_elems))
        grid = (count, triton.cdiv(band_elems, block))
        # fp fusion off: mul then add, rounded like the plain version
        kernel[grid](ds, idx.contiguous(), out, h * w * c, h0 * w * c,
                     band_elems, (hi - lo) / 255.0, float(lo), BLOCK=block,
                     num_warps=8 if block >= 2048 else 4,
                     enable_fp_fusion=False)
        LAUNCHES["gather_u8_normalize"] += 1
    return out.permute(0, 3, 1, 2)
