"""hemx_torch's summaries held against hemx.summaries: the CRC-32C, PNG
bytes, montage and histogram/image protos equal hemx's for the same
arrays; an events file written by the port with the clock fixed equals
hemx's byte for byte, and each package's reader reads the other's files
(tags, steps and values)."""

import importlib
import os
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")


@pytest.mark.parametrize("n", [0, 1, 7, 255, 4096])
def test_crc32c_matches_hemx(n):
    from hemx.summaries import crc32c as H
    from hemx_torch.summaries import crc32c as T
    data = np.random.default_rng(n).integers(0, 256, n, np.uint8).tobytes()
    assert T.crc32c(data) == H.crc32c(data) == H._py_crc32c(data)
    assert T.masked_crc32c(data) == H.masked_crc32c(data)


def test_crc32c_known_value():
    from hemx_torch.summaries.crc32c import crc32c
    assert crc32c(b"123456789") == 0xE3069283  # the CRC-32C check value


@pytest.mark.parametrize("shape", [(5, 7), (5, 7, 1), (4, 6, 3), (3, 2, 4)])
def test_png_bytes_match_hemx(shape):
    from hemx.summaries.png import decode_png, encode_png as h_enc
    from hemx_torch.summaries.png import encode_png
    img = np.random.default_rng(2).integers(0, 256, shape, np.uint8)
    got = encode_png(img)
    assert got == h_enc(img)
    np.testing.assert_array_equal(decode_png(got).reshape(img.shape), img)


@pytest.mark.parametrize("n", [1, 6, 7, 64])
def test_montage_matches_hemx(n):
    H = importlib.import_module("hemx.summaries.montage")
    T = importlib.import_module("hemx_torch.summaries.montage")
    imgs = np.random.default_rng(n).random((n, 4, 5, 3)).astype(np.float32)
    assert T.factorization(n) == H.factorization(n)
    np.testing.assert_array_equal(T.montage(imgs), H.montage(imgs))
    np.testing.assert_array_equal(T.to_uint8(T.montage(imgs)),
                                  H.to_uint8(H.montage(imgs)))


@pytest.mark.parametrize("kind", ["normal", "with_nonfinite", "all_nan",
                                  "constant"])
def test_histogram_and_image_protos_match_hemx(kind):
    from hemx.summaries import events as H
    from hemx_torch.summaries import events as T
    rng = np.random.default_rng(3)
    x = {"normal": rng.standard_normal(1000) * 3,
         "with_nonfinite": np.array([1.0, np.nan, -np.inf, 2.5, 0.0]),
         "all_nan": np.full(4, np.nan),
         "constant": np.zeros(9)}[kind]
    assert T.histogram_value("h", x) == H.histogram_value("h", x)
    img = rng.random((6, 5, 3)).astype(np.float32)
    assert T.image_value("i", img) == H.image_value("i", img)


def _write(events_mod, logdir):
    w = events_mod.EventsWriter(logdir)
    rng = np.random.default_rng(5)
    w.scalar("losses/loss", 0.5, 1)
    w.scalars({"losses/g_loss": -1.25, "losses/d_loss": 3.0}, 2)
    w.histogram("examples/real_hist", rng.random(300), 2)
    w.montage("examples/fake", rng.random((6, 4, 4, 3)), 3)
    w.scalars({"losses/g_loss": -0.75}, 3)
    w.close()
    return w.path


def test_events_file_matches_hemx_and_reads_both_ways(tmp_path, monkeypatch):
    from hemx.summaries import events as HE, reader as HR
    from hemx_torch.summaries import events as TE, reader as TR
    monkeypatch.setattr(time, "time", lambda: 1700000000.25)
    got = _write(TE, str(tmp_path / "port"))
    want = _write(HE, str(tmp_path / "hemx"))
    assert os.path.basename(got) == os.path.basename(want)
    with open(got, "rb") as f, open(want, "rb") as g:
        assert f.read() == g.read()
    for logdir in (tmp_path / "port", tmp_path / "hemx"):
        h = HR.get_all_events(str(logdir))
        t = TR.get_all_events(str(logdir))
        assert h == t
        assert sorted(h) == ["losses/d_loss", "losses/g_loss", "losses/loss"]
        assert TR.get_tag_values(str(logdir), "losses/g_loss") == \
            [(2, -1.25), (3, -0.75)]
    assert [s for s, _ in HR.get_histogram_values(
        str(tmp_path / "port"), "examples/real_hist")] == [2]
    assert [s for s, _ in HR.get_image_values(
        str(tmp_path / "port"), "examples/fake")] == [3]


def test_summary_writer_set_layout(tmp_path):
    from hemx_torch.summaries.events import SummaryWriterSet
    ws = SummaryWriterSet(str(tmp_path))
    ws["validate"].scalar("losses/d_loss", 1.0, 4)
    ws.close()
    for phase in ("train", "validate", "test"):
        assert len(os.listdir(tmp_path / phase)) == 1
