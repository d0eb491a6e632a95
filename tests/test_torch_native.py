"""hemx_torch.native (the C++ TFRecord reader/writer and CRC-32C) against
hemx's pure-Python paths, which are deterministic whatever hemx's own
native build does: ``hemx.summaries.crc32c._py_crc32c`` and
``hemx.data.tfrecord.tfrecord_iterator``.

* CRCs: every length 0-87 (each slicing-by-8 tail), seeded buffers up to
  64 KiB, and the CRC-32C check values.
* Records: hemx-written files read back with and without ``verify``,
  counted, and written byte for byte the same by the port's
  ``TFRecordWriter``, by ``write_records`` and by hemx's writer.
* Corruption and truncation raise, in the C++ paths and the plain ones; a
  cut inside the length field is a clean end, as in hemx's paths; a
  length of 2^63 raises without allocating.
* The build: four spawned processes building into one empty directory at
  once leave one ``.so``; a failing compiler and a file that does not load
  make ``load()`` raise ``RuntimeError``.
* The callers (``read_all_records``, ``count_records``, ``crc32c`` and
  through it the writers) call the C++ functions, seen with
  ``sys.setprofile``.
"""

import multiprocessing
import os
import struct
import sys

import numpy as np
import pytest

CHECK_VALUES = [(b"123456789", 0xE3069283), (bytes(32), 0x8A9136AA),
                (b"\xff" * 32, 0x62A8AB43), (bytes(range(32)), 0x46DD794E)]
HEMX_DATA_NAMES = ["DataPlugin", "get_dataset", "get_dataset_tensors",
                   "TFRecordWriter", "tfrecord_iterator", "count_records",
                   "ArraySource", "TFRecordSource", "Split", "Pipeline"]


def _mask(crc):
    return ((crc >> 15) | (crc << 17)) + 0xA282EAD8 & 0xFFFFFFFF


def _records(seed=0):
    rng = np.random.default_rng(seed)
    sizes = [0, 1, 7, 8, 9, 50, 4096, 12288, 100_003]
    return [rng.integers(0, 256, n, dtype=np.uint8).tobytes() for n in sizes]


def _hemx_file(tmp_path, records, name="h.tfrecords"):
    from hemx.data.tfrecord import TFRecordWriter
    path = str(tmp_path / name)
    with TFRecordWriter(path) as w:
        for r in records:
            w.write(r)
    return path


# -- CRC-32C -----------------------------------------------------------------

@pytest.mark.parametrize("tail", range(8))
def test_crc_every_length_equals_hemx(tail):
    from hemx.summaries.crc32c import _py_crc32c
    from hemx_torch import native
    from hemx_torch.summaries import crc32c as T
    mod = native.load()
    data = bytes(range(7, 256)) * 2
    for n in range(tail, 81, 8):
        want = _py_crc32c(data[:n])
        assert T.crc32c(data[:n]) == mod.crc32c(data[:n]) == want, n
        assert (T.masked_crc32c(data[:n]) == mod.masked_crc32c(data[:n])
                == _mask(want)), n
        # a running crc goes through the plain loop, as in hemx
        assert T.crc32c(data[n:n + 9], want) == _py_crc32c(data[:n + 9])


@pytest.mark.parametrize("size", [100, 4095, 4096, 65521, 65536])
def test_crc_random_buffers_equal_hemx(size):
    from hemx.summaries.crc32c import _py_crc32c
    from hemx_torch.summaries import crc32c as T
    data = np.random.default_rng(size).integers(0, 256, size,
                                                dtype=np.uint8).tobytes()
    want = _py_crc32c(data)
    assert T.crc32c(data) == T._py_crc32c(data) == want
    assert T.masked_crc32c(data) == _mask(want)


@pytest.mark.parametrize("data,want", CHECK_VALUES)
def test_crc_check_values(data, want):
    from hemx_torch.summaries import crc32c as T
    assert T.crc32c(data) == T._py_crc32c(data) == want


# -- records -----------------------------------------------------------------

@pytest.mark.parametrize("verify", [False, True])
def test_reads_and_counts_hemx_files(tmp_path, verify):
    from hemx.data import tfrecord as H
    from hemx_torch.data import tfrecord as T
    recs = _records()
    path = _hemx_file(tmp_path, recs)
    assert T.read_all_records(path, verify) == list(
        H.tfrecord_iterator(path, verify)) == recs
    assert list(T.tfrecord_iterator(path, verify)) == recs
    # the port's count first: hemx's caches ``<path>.count`` too
    assert T.count_records(path) == T._py_count_records(path) == len(recs)
    assert (tmp_path / "h.tfrecords.count").read_text() == str(len(recs))
    os.unlink(path + ".count")
    assert H.count_records(path) == len(recs)


def test_writers_equal_hemx_byte_for_byte(tmp_path):
    from hemx_torch import native
    from hemx_torch.data import tfrecord as T
    recs = _records(1)
    want = open(_hemx_file(tmp_path, recs), "rb").read()
    with T.TFRecordWriter(str(tmp_path / "t.tfrecords")) as w:
        for r in recs:
            w.write(r)
    native.load().write_records(str(tmp_path / "n.tfrecords"), recs)
    assert (tmp_path / "t.tfrecords").read_bytes() == want
    assert (tmp_path / "n.tfrecords").read_bytes() == want


# -- corruption and truncation ------------------------------------------------

def _two_records(tmp_path):
    from hemx_torch.data import tfrecord as T
    path = tmp_path / "x.tfrecords"
    with T.TFRecordWriter(str(path)) as w:
        w.write(b"a" * 50)
        w.write(b"b" * 40)
    return path, path.read_bytes()


def _readers(verify):
    """(name, fn): the C++ reader and the plain iterator."""
    from hemx_torch.data import tfrecord as T
    return [("read_all_records", lambda p: T.read_all_records(p, verify)),
            ("tfrecord_iterator", lambda p: list(T.tfrecord_iterator(p,
                                                                     verify)))]


# byte offsets in the first record: a length byte, a header CRC byte, a
# payload byte; what ``verify`` reports
@pytest.mark.parametrize("offset,what", [(0, "corrupt header crc"),
                                         (9, "corrupt header crc"),
                                         (20, "corrupt record crc")])
def test_flipped_byte_raises_under_verify(tmp_path, offset, what):
    path, data = _two_records(tmp_path)
    bad = bytearray(data)
    bad[offset] ^= 1
    path.write_bytes(bytes(bad))
    for name, read in _readers(verify=True):
        with pytest.raises(OSError, match=what):
            read(str(path))
    if offset == 20:  # CRCs unread by default
        for name, read in _readers(verify=False):
            assert len(read(str(path))) == 2, name


# the last record starts at 66 (8 + 4 + 50 + 4) and holds 8 + 4 + 40 + 4
@pytest.mark.parametrize("cut", [66 + 10, 66 + 12 + 20, 66 + 12 + 40 + 2],
                         ids=["header_crc", "payload", "data_crc"])
def test_cut_inside_last_record_is_truncated(tmp_path, cut):
    from hemx_torch.data import tfrecord as T
    path, data = _two_records(tmp_path)
    path.write_bytes(data[:cut])
    p = str(path)
    for verify in (False, True):
        for name, read in _readers(verify):
            with pytest.raises(OSError, match="truncated"):
                read(p)
    for count in (T.count_records, T._py_count_records):
        with pytest.raises(OSError, match="truncated"):
            count(p)


@pytest.mark.parametrize("cut", [66 + 1, 66 + 7])
def test_cut_inside_length_field_is_a_clean_end(tmp_path, cut):
    """hemx's paths (the reader and the counter of
    ``hemx/native/tfrecord.cc``, the iterator and the counter of
    ``hemx/data/tfrecord.py``) end cleanly where fewer than 8 bytes of a
    length are left; so do the port's."""
    from hemx.data import tfrecord as H
    from hemx_torch.data import tfrecord as T
    path, data = _two_records(tmp_path)
    path.write_bytes(data[:cut])
    p = str(path)
    want = list(H.tfrecord_iterator(p))
    assert want == [b"a" * 50]
    for verify in (False, True):
        for name, read in _readers(verify):
            assert read(p) == want, name
    assert T.count_records(p) == T._py_count_records(p) == 1


def test_length_of_two_to_the_63_raises(tmp_path):
    from hemx_torch import native
    from hemx_torch.data import tfrecord as T
    from hemx_torch.summaries.crc32c import masked_crc32c
    header = struct.pack("<Q", 2 ** 63)
    path = tmp_path / "x.tfrecords"
    path.write_bytes(header + struct.pack("<I", masked_crc32c(header))
                     + bytes(64))
    p = str(path)
    for verify in (False, True):
        with pytest.raises(OSError, match="truncated"):
            native.load().read_all_records(p, verify)
    for count in (T.count_records, T._py_count_records):
        with pytest.raises(OSError, match="truncated"):
            count(p)


# -- the build ---------------------------------------------------------------

def _load_worker(build_dir, barrier, out):
    from hemx_torch import native
    barrier.wait(60)
    mod = native.load(build_dir=build_dir)
    # the inode of the file loaded: one build leaves one for all four
    out.put((mod.__file__, os.stat(mod.__file__).st_ino,
             mod.crc32c(b"123456789")))


def test_four_processes_build_one_so(tmp_path):
    ctx = multiprocessing.get_context("spawn")
    barrier, out = ctx.Barrier(4), ctx.Queue()
    procs = [ctx.Process(target=_load_worker,
                         args=(str(tmp_path), barrier, out))
             for _ in range(4)]
    for p in procs:
        p.start()
    got = [out.get(timeout=120) for _ in procs]
    for p in procs:
        p.join(30)
        assert not p.is_alive() and p.exitcode == 0
    sos = [f for f in os.listdir(tmp_path) if f.endswith(".so")]
    assert len(sos) == 1, os.listdir(tmp_path)
    assert sorted(os.listdir(tmp_path)) == sorted(sos + ["lock"])
    so = tmp_path / sos[0]
    assert got == [(str(so), so.stat().st_ino, 0xE3069283)] * 4


def test_broken_build_raises_with_the_compiler_stderr(tmp_path,
                                                     monkeypatch):
    """A g++ that fails (here a script first on PATH) makes ``load()``
    raise with the command and the compiler's stderr, and leaves no file
    but the lock."""
    from hemx_torch import native
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir()
    gxx = bin_dir / "g++"
    gxx.write_text("#!/bin/sh\necho 'g++: error: no such compiler here' >&2"
                   "\nexit 1\n")
    gxx.chmod(0o755)
    monkeypatch.setenv("PATH", f"{bin_dir}{os.pathsep}{os.environ['PATH']}")
    build_dir = tmp_path / "build"
    with pytest.raises(RuntimeError, match="no such compiler here") as e:
        native.load(build_dir=str(build_dir))
    assert "g++ -O3 -std=c++17 -shared -fPIC" in str(e.value)
    assert os.listdir(build_dir) == ["lock"]  # no .so, no temporary file


def test_a_file_that_does_not_load_raises(tmp_path):
    from hemx_torch import native
    with open(native.so_path(str(tmp_path)), "wb") as f:
        f.write(b"not an ELF file")
    with pytest.raises(RuntimeError, match="loading"):
        native.load(build_dir=str(tmp_path))


# -- the callers -------------------------------------------------------------

def _c_calls(fn):
    """The C functions that ``fn()`` calls."""
    seen = []

    def profile(frame, event, arg):
        if event == "c_call":
            seen.append(arg)

    sys.setprofile(profile)
    try:
        fn()
    finally:
        sys.setprofile(None)
    return seen


def _call_events_writer(tmp_path):
    from hemx_torch.summaries.events import EventsWriter
    w = EventsWriter(str(tmp_path / "ev"))
    w.scalar("x", 1.0, 0)
    w.close()


@pytest.mark.parametrize("caller,fn", [
    ("read_all_records", "read_all_records"),
    ("count_records", "count_records"),
    ("crc32c", "crc32c"),
    ("TFRecordWriter", "crc32c"),
    ("EventsWriter", "crc32c")])
def test_callers_go_through_the_native_module(tmp_path, caller, fn):
    from hemx_torch import native
    from hemx_torch.data import tfrecord as T
    from hemx_torch.summaries import crc32c as C
    path, _ = _two_records(tmp_path)
    p = str(path)

    def write():
        with T.TFRecordWriter(str(tmp_path / "w.tfrecords")) as w:
            w.write(b"abc")

    calls = {"read_all_records": lambda: T.read_all_records(p),
             "count_records": lambda: T.count_records(p),
             "crc32c": lambda: C.crc32c(b"abc"),
             "TFRecordWriter": write,
             "EventsWriter": lambda: _call_events_writer(tmp_path)}
    seen = _c_calls(calls[caller])
    assert getattr(native.load(), fn) in seen


def test_data_exports_hemx_names():
    import hemx.data as H

    import hemx_torch.data as T
    for name in HEMX_DATA_NAMES:
        assert hasattr(H, name) and hasattr(T, name), name
    from hemx_torch.data.tfrecord import count_records
    assert T.count_records is count_records
