"""hemx_torch's gather+normalize input kernel against hemx's normalize.

On the CPU the wrapper takes its plain PyTorch version; that version must
equal hemx's ``u8_normalize`` and ``u8_normalize_pallas`` (on the CPU the
latter runs its own jnp path, as tests/test_ops.py runs it) on the same
gathered rows: bit for bit for (lo, hi) = (0, 1), within atol 1e-6 (one
float32 ulp on [-1, 1]) for (-1, 1). The CUDA kernel itself runs only on
a CUDA device; its cases are marked ``cuda`` and skip without one, and hold
it to its plain version with ``torch.equal``. JAX is
imported only by the hemx comparison, so on the GPU machine (no JAX) the
``cuda`` cases run with
``python -m pytest tests/test_torch_kernels.py -m cuda --noconftest``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from hemx_torch.ops import input_kernels as K  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _hemx_float32():
    """hemx's compute dtype and precision are process-wide, and bench.main()
    in an earlier test of this worker may have left them at bfloat16:
    compare against, and leave behind, hemx's float32 defaults. (The GPU
    machine runs this file's cuda cases without JAX, hence no hemx.)"""
    try:
        from hemx.ops import layers
    except ImportError:
        return
    layers.set_compute_dtype(None)
    layers.set_default_precision("default")


def _data(seed, n=12, shape=(8, 8, 3), rows=9):
    rng = np.random.default_rng(seed)
    ds = rng.integers(0, 256, (n,) + shape, dtype=np.uint8)
    idx = rng.choice(n, rows, replace=True)
    return ds, idx


@pytest.mark.parametrize("idx_dtype", [np.int32, np.int64])
@pytest.mark.parametrize("lo,hi", [(0.0, 1.0), (-1.0, 1.0)])
def test_plain_matches_hemx(lo, hi, idx_dtype):
    import jax.numpy as jnp
    from hemx.ops.pallas_kernels import u8_normalize, u8_normalize_pallas
    ds, idx = _data(0)
    got = K.gather_u8_normalize(torch.from_numpy(ds),
                                torch.from_numpy(idx.astype(idx_dtype)), lo, hi)
    got = got.permute(0, 2, 3, 1).numpy()
    for fn in (u8_normalize, u8_normalize_pallas):
        want = np.asarray(fn(jnp.asarray(ds[idx]), lo, hi))
        if lo == 0.0:
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_cpu_layout_and_no_launch():
    """CPU tensors take the plain version (no kernel launch is counted);
    the result is (R, C, H, W) float32 in channels_last memory."""
    ds, idx = _data(1, shape=(5, 7, 3), rows=4)
    before = dict(K.LAUNCHES)
    out = K.gather_u8_normalize(torch.from_numpy(ds), torch.from_numpy(idx))
    assert K.LAUNCHES == before
    assert out.shape == (4, 3, 5, 7) and out.dtype == torch.float32
    assert out.is_contiguous(memory_format=torch.channels_last)
    np.testing.assert_array_equal(out.permute(0, 2, 3, 1).numpy(),
                                  ds[idx].astype(np.float32) * (1.0 / 255.0))


@pytest.mark.parametrize("ds_dtype,idx_shape", [
    (torch.float32, (3,)),      # dataset must be uint8
    (torch.uint8, (3, 1)),      # index must be 1-D
])
def test_rejects_bad_inputs(ds_dtype, idx_shape):
    ds = torch.zeros((4, 2, 2, 3), dtype=ds_dtype)
    idx = torch.zeros(idx_shape, dtype=torch.int64)
    with pytest.raises(ValueError):
        K.gather_u8_normalize(ds, idx)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the CUDA kernel has no CPU mode)")
    return torch.device("cuda:0")


@pytest.mark.cuda
@pytest.mark.parametrize("band", [False, True])
@pytest.mark.parametrize("shape,rows", [((64, 64, 3), 3072), ((5, 7, 3), 37)])
@pytest.mark.parametrize("lo,hi", [(0.0, 1.0), (-1.0, 1.0)])
def test_kernel_matches_plain_on_cuda(cuda_device, shape, rows, lo, hi, band):
    """The CUDA kernel equals its plain version on the card bit for bit
    and counts one launch, on whole rows and on a height band (the lower
    rows of each image, as a ``--spatial_parallel`` rank reads them)."""
    g = torch.Generator(device=cuda_device)
    g.manual_seed(0)
    ds = torch.randint(0, 256, (rows + 5,) + shape, dtype=torch.uint8,
                       device=cuda_device, generator=g)
    idx = torch.randint(0, rows + 5, (rows,), device=cuda_device, generator=g)
    rows_of = (shape[0] // 2, shape[0]) if band else None
    before = K.LAUNCHES["gather_u8_normalize"]
    got = K.gather_u8_normalize(ds, idx, lo, hi, rows_of)
    torch.cuda.synchronize()
    assert K.LAUNCHES["gather_u8_normalize"] == before + 1
    want = K.gather_u8_normalize_ref(ds, idx, lo, hi, rows_of)
    assert got.shape == want.shape
    assert got.is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(got, want)


def _equal_on_card(ds, idx, lo, hi, rows=None):
    """One launch (none for zero rows), bit-equal to the plain version."""
    before = K.LAUNCHES["gather_u8_normalize"]
    got = K.gather_u8_normalize(ds, idx, lo, hi, rows)
    torch.cuda.synchronize()
    assert (K.LAUNCHES["gather_u8_normalize"] - before
            == (1 if idx.numel() else 0))
    want = K.gather_u8_normalize_ref(ds, idx, lo, hi, rows)
    assert got.shape == want.shape and got.dtype == torch.float32
    assert got.is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(got, want), (tuple(ds.shape), idx.numel(), rows)


def _u8(g, shape, dev):
    return torch.randint(0, 256, shape, dtype=torch.uint8, device=dev,
                         generator=g)


@pytest.mark.cuda
@pytest.mark.parametrize("idx_dtype", [torch.int32, torch.int64])
def test_kernel_row_widths_1_to_40_on_cuda(cuda_device, idx_dtype):
    """Rows of 1 to 40 bytes (a tile then spans up to 32 rows, each shorter
    than a 16-byte granule or straddling two), whole and as a band."""
    g = torch.Generator(device=cuda_device)
    g.manual_seed(2)
    for width in range(1, 41):
        for shape in ((1, width, 1), (2, width, 1) if width % 2 == 0
                      else (1, 1, width)):
            ds = _u8(g, (301,) + shape, cuda_device)
            idx = torch.randint(0, 301, (777,), device=cuda_device,
                                generator=g).to(idx_dtype)
            _equal_on_card(ds, idx, -1.0, 1.0)
            if shape[0] == 2:
                _equal_on_card(ds, idx, 0.0, 1.0, rows=(1, 2))


@pytest.mark.cuda
@pytest.mark.parametrize("idx_dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("shape,n,rows,band", [
    ((65, 65, 1), 4096, 512, None),     # the thesis depth key, 4,225 B
    ((65, 65, 3), 600, 512, None),      # the thesis image key
    ((66, 66, 1), 600, 300, (17, 50)),  # B1's rows, a band in the middle
    ((5, 7, 3), 50, 37, (1, 2)),        # an odd band: one 21-byte row
    ((5, 7, 3), 50, 37, (2, 5)),
    ((64, 64, 3), 600, 512, (0, 32)),   # a --spatial_parallel band
    ((5, 7, 3), 50, 1, None),           # one row
    ((5, 7, 3), 50, 0, None),           # zero rows: no launch
    ((5, 7, 3), 50, 0, (1, 2)),
])
def test_kernel_awkward_shapes_on_cuda(cuda_device, shape, n, rows, band,
                                       idx_dtype):
    g = torch.Generator(device=cuda_device)
    g.manual_seed(3)
    ds = _u8(g, (n,) + shape, cuda_device)
    idx = torch.randint(0, n, (rows,), device=cuda_device,
                        generator=g).to(idx_dtype)
    for lo, hi in ((0.0, 1.0), (-1.0, 1.0)):
        _equal_on_card(ds, idx, lo, hi, band)


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [3, 1, 16])
@pytest.mark.parametrize("shape,band", [((65, 65, 1), None),
                                        ((5, 7, 3), (1, 4)),
                                        ((64, 64, 3), (32, 64))])
def test_kernel_storage_offset_on_cuda(cuda_device, offset, shape, band):
    """A contiguous view whose data starts ``offset`` bytes into its storage
    (so not on a 16-byte boundary), its first and last rows gathered. The
    storage's bytes around the view (255) differ from every byte it holds,
    so a byte taken from outside it would show."""
    g = torch.Generator(device=cuda_device)
    g.manual_seed(4)
    n = 40
    row = shape[0] * shape[1] * shape[2]
    storage = torch.full((n * row + offset + 17,), 255, dtype=torch.uint8,
                         device=cuda_device)
    view = storage[offset:offset + n * row].view((n,) + shape)
    view.copy_(torch.randint(0, 255, view.shape, dtype=torch.uint8,
                             device=cuda_device, generator=g))
    assert view.is_contiguous() and view.storage_offset() == offset
    idx = torch.cat([torch.tensor([0, n - 1, n - 1, 0], device=cuda_device),
                     torch.randint(0, n, (60,), device=cuda_device,
                                   generator=g)])
    _equal_on_card(view, idx, 0.0, 1.0, band)
    got = K.gather_u8_normalize(view, idx, 0.0, 1.0, band)
    assert got.max().item() < 1.0  # no 255 byte from outside the view


@pytest.mark.cuda
@pytest.mark.parametrize("group", [1, 6])
def test_streaming_pipeline_matches_cache_on_cuda(cuda_device, group):
    """On the card the streaming Pipeline (pinned staging, one H2D copy and
    one kernel launch per group) yields the device cache's batches bit for
    bit over two epochs, tails included; its copies are counted. Each
    checked epoch's copies queue behind a ~1 s kernel, so a staging
    buffer refilled before its copy has run shows as a wrong batch. A
    warm-up epoch first fills the pinned and device caches: a device
    allocation during the checked epoch would wait for the kernel and hide
    the fault, as CUDA may for a small copy, so each copy is >= 96
    KiB."""
    from types import SimpleNamespace

    from hemx_torch.data.pipeline import DeviceDataPipeline, Pipeline
    from hemx_torch.data.synthetic import SyntheticDataset
    args = SimpleNamespace(synthetic_count=80, synthetic_shape=[64, 64, 3],
                           synthetic_eval_count=0, synthetic_u8=True, seed=0)
    split = SyntheticDataset.get_datasets(args)["train"]
    # the set's uint8 image and depth go through the kernel (one launch
    # each per group); its float keys are copied as they are
    keys = split.device_transform.keys
    row_bytes = sum(v[0].nbytes for v in
                    next(split.iter_epoch(1, shuffle=False)).values())
    cached = DeviceDataPipeline(split, 8, device=cuda_device, seed=3,
                                group=group)
    stream = Pipeline(split, 8, device=cuda_device, seed=3, group=group)
    for e in range(2):
        want = list(cached.epoch(e))
        list(stream.epoch(e))
        torch.cuda.synchronize()
        before = K.LAUNCHES["gather_u8_normalize"]
        torch.cuda._sleep(2_000_000_000)  # cycles: the copies wait behind it
        got = list(stream.epoch(e))
        assert (K.LAUNCHES["gather_u8_normalize"] - before
                == len(keys) * -(-10 // group))
        assert len(got) == len(want) == 10
        for g, w in zip(got, want):
            assert g.keys() == w.keys()
            for k in g:
                assert g[k].device == w[k].device
                assert torch.equal(g[k], w[k]), k
    stream.drain()
    assert stream.h2d_bytes == 4 * 80 * row_bytes and stream.h2d_s > 0
