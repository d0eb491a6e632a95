"""Fused gather + uint8->float normalize: the input kernel of the training path.

Replaces the TPU kernel ``hemx/ops/pallas_kernels.py::u8_normalize_pallas``
(its ``pl.pallas_call`` at line 75, body ``_norm_kernel``) and the jnp
``u8_normalize`` that ``hemx.data.pipeline.DeviceDataPipeline`` runs after
its ``jnp.take`` gather. Both compute ``float(x) * (hi - lo) / 255 + lo``.

What bounds it on an H100: bytes. It reads G*B*H*W*C uint8 and writes four
times that in float32, with no reuse and two flops per element, so the
only lever is to touch each byte once. The design therefore fuses the
gather into the normalize: the kernel loads the dataset row indices,
reads those rows' H*W*C contiguous bytes and writes the normalized floats
straight to the output rows, in the same physical NHWC order (which is the
``torch.channels_last`` layout of the logical NCHW batch). There is no
gathered uint8 intermediate and no relayout. The Pallas kernel's
``(rows, 128)`` view is deliberately not carried over: on the TPU that view
forced a relayout of the NHWC input that made the kernel 20x slower than
XLA's fused convert (``pallas_kernels.py:9-22``).

The kernel is CUDA C++ for sm_90a (``hemx_torch/csrc/gather_u8_normalize.cu``,
whose head says how it is laid out for the H100): a persistent grid walks
the flat output in equal tiles, bulk asynchronous copies stage each tile's
source rows in shared memory at any row width and storage offset, and
every store is a 16-byte vector. It is compiled by nvcc at first use
(:func:`build`) into a library with a plain C interface, loaded with
``ctypes``.

A height band (``rows=(h0, h1)``): under ``--spatial_parallel`` a rank
needs only rows ``[h0, h1)`` of each image (``hemx.parallel.mesh
.batch_spec`` shards height). In NHWC those are one contiguous run of
``(h1-h0)*W*C`` bytes at offset ``h0*W*C`` of each dataset row, so the band
is the same kernel with a row offset and a shorter row: it reads only the
band's bytes (rounded out to the 16-byte granules that hold them) and
writes a (R, C, h1-h0, W) batch. The default is
the whole height.

Dispatch: a tensor on the CPU takes the plain PyTorch version
(:func:`gather_u8_normalize_ref`); a CUDA tensor launches the kernel or
raises — there is no fallback. The build, like ``hemx_torch.native``'s, goes
through :func:`hemx_torch.utils.build.build_so`: into
``hemx_torch/_build/cuda/``, named by a hash of the source and the nvcc
command, once under a lock; a missing ``nvcc`` or a compile error raises
``RuntimeError`` with the command and the compiler's stderr.
"""

from __future__ import annotations

import ctypes
import os
import shutil

import torch

from hemx_torch.utils import build as _build_lib
from hemx_torch.utils import tracing

#: Launches of each hand-written kernel, counted where the kernel launches
#: (and nowhere else) so a run can show that it went through the kernel.
LAUNCHES = tracing.counter("launches", "gather_u8_normalize")

_PACKAGE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PACKAGE, "csrc", "gather_u8_normalize.cu")
BUILD_DIR = os.path.join(_PACKAGE, "_build", "cuda")
# sm_90a code only; -fmad=false on top of the source's __fmul_rn/__fadd_rn:
# no multiply-add contraction, so the kernel rounds like the plain version
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_FN = None  # the loaded C entry point


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


def nvcc() -> str:
    """The nvcc on ``PATH``, else ``$CUDA_HOME/bin/nvcc`` (default
    ``/usr/local/cuda``)."""
    return shutil.which("nvcc") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")


def compile_command() -> list[str]:
    """nvcc and its flags, without the source and the output."""
    return [nvcc(), *FLAGS]


def so_path(build_dir: str | None = None) -> str:
    """Where the build of the kernel's source with :func:`compile_command`
    lies."""
    return _build_lib.so_path([SOURCE], compile_command(),
                              build_dir or BUILD_DIR, "gather_u8_normalize",
                              ".so")


def build(build_dir: str | None = None) -> str:
    """The path of the kernel's library, compiled first unless it is there;
    nvcc's output (``-Xptxas -v``: registers, shared memory, spills) is
    kept beside it (``hemx_torch.utils.build.log_path``)."""
    return _build_lib.build_so([SOURCE], compile_command(),
                               build_dir or BUILD_DIR, "gather_u8_normalize",
                               ".so", log=True)


def _launcher():
    """The C entry point of the library in :data:`BUILD_DIR`, built and
    loaded once."""
    global _FN
    if _FN is None:
        path = build()
        try:
            fn = ctypes.CDLL(path).gather_u8_normalize
        except OSError as e:
            raise RuntimeError(f"loading {path} failed: {e}") from e
        i64, ptr = ctypes.c_int64, ctypes.c_void_p
        fn.argtypes = [ptr, i64, ptr, i64, ptr, i64, i64, i64, i64,
                       ctypes.c_float, ctypes.c_float, i64, ptr]
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


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
    n, h, w, c = ds.shape
    count = idx.numel()
    band_elems = (h1 - h0) * w * c
    if band_elems >= 1 << 30:
        raise ValueError(f"gather_u8_normalize: rows of {band_elems} bytes; "
                         f"the kernel takes under 2^30")
    out = torch.empty((count, h1 - h0, w, c), dtype=torch.float32,
                      device=ds.device)
    if count:
        launch = _launcher()
        idx = idx.contiguous()
        err = launch(ds.data_ptr(), ds.numel(), idx.data_ptr(),
                     idx.element_size(), out.data_ptr(), count, h * w * c,
                     h0 * w * c, band_elems, (hi - lo) / 255.0, float(lo),
                     ds.device.index,
                     torch.cuda.current_stream(ds.device).cuda_stream)
        if err:
            raise RuntimeError(f"gather_u8_normalize: launch failed with "
                               f"CUDA error {err}")
        LAUNCHES["gather_u8_normalize"] += 1
    return out.permute(0, 3, 1, 2)
