"""The port's summary reader, ``utils/misc``, FID, ``events``,
``paper_visualize`` and ``visualize_gui`` against hemx's on the same inputs
(no training but the VAE run of the last item).

* reader: a logdir with one events file written by hemx's writer and one by
  the port's, a resumed run's duplicate steps among them (written later, so
  their wall time wins), scalars, packed histograms, an unpacked one, and
  images; every reader function of both packages gives the same values;
* misc: ``chunks``, ``fold`` (the remainder dropped, its error below one
  batch), and ``visualize_parameters``' table of a port CNN equal to hemx's
  table of the same weights;
* FID: ``gaussian_stats``, ``_sqrtm_psd``, ``frechet_distance``,
  ``fid_from_features`` and ``fid_from_images`` on seeded numpy (rtol
  1e-10), ``pixel_features`` (1e-6); ``encoder_features`` of a CNN on
  hemx's CNN with the same weights (through ``convert.to_jax``, rtol
  1e-5), and the VAE's ValueError;
* the tools: ``events.main`` (the same series count, the histogram list),
  the three ``paper_visualize`` presets and the generic mode on a written
  ``--root`` layout (the same series counts), and the GUI's routes (the
  same HTML bodies, PNG magic on the chart routes, the same image bytes,
  404 on a bad run index or a missing parameter);
* ``visualize`` on a VAE run against hemx's, with
  ``tests/test_torch_visualize.py``'s checks (run here so that each of the
  two files stays short).
"""

import contextlib
import io
import os
import re
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from tests.test_torch_visualize import (  # noqa: E402,F401
    _hemx_float32, _two_torch_threads, check_bestfit_first_step,
    check_file_set, check_images, check_weight_grids, compare_family)

PNG_MAGIC = b"\x89PNG\r\n\x1a\n"


def _images(seed, n=4, hw=8):
    return np.random.default_rng(seed).random((n, hw, hw, 3), np.float32)


def _write_runs(root):
    from hemx.summaries.events import EventsWriter as HW
    from hemx_torch.summaries import proto
    from hemx_torch.summaries.events import EventsWriter as TW
    rng = np.random.default_rng(3)
    a = root / "a"
    for phase in ("train", "validate"):
        w = HW(str(a / phase), ".hemx")
        for step in range(4):
            w.scalar("losses/loss", 1.0 / (step + 1), step)
            w.scalar("metrics_y_hat/linear_rmse", 0.5 - 0.1 * step, step)
            w.histogram("acts/h", rng.normal(size=200) * (step + 1), step)
            w.montage("examples/out", _images(step), step)
        w.close()
    # the resumed run's file is written later: its wall times win
    for phase in ("train", "validate"):
        w = TW(str(a / phase), ".port")
        for step in range(2, 6):
            w.scalar("losses/loss", 10.0 + step, step)
            w.histogram("acts/h", rng.normal(size=100) - step, step)
            w.montage("examples/out", _images(10 + step), step)
        # one HistogramProto with unpacked doubles (one field per bucket)
        h = (proto.enc_double(1, -1.0) + proto.enc_double(2, 3.0)
             + proto.enc_double(3, 6.0) + proto.enc_double(4, 4.0)
             + proto.enc_double(5, 9.0)
             + b"".join(proto.enc_double(6, v) for v in (0.0, 1.0, 3.0))
             + b"".join(proto.enc_double(7, v) for v in (1.0, 3.0, 2.0)))
        w.write_summary([proto.enc_string(1, "acts/unpacked")
                         + proto.enc_message(5, h)], 7)
        w.close()
    b = root / "b"
    w = TW(str(b / "train"))
    for step in range(3):
        w.scalar("losses/d_loss", 2.0 - step, step)
        w.scalar("losses/g_loss", 1.0 + step, step)
    w.close()
    (b / "options.config").write_text("model gan\n")
    (a / "checkpoint-0.msgpack").write_bytes(b"")
    (a / "checkpoint-3.msgpack").write_bytes(b"")
    return str(a), str(b)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("reader")
    a, b = _write_runs(root)
    return {"root": str(root), "a": a, "b": b}


def _same(got, want):
    """Equal values, floats at rtol 1e-12 (hemx's and the port's parse
    the same bytes)."""
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            _same(got[k], want[k])
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _same(g, w)
    elif isinstance(want, float):
        np.testing.assert_allclose(got, want, rtol=1e-12)
    else:
        assert got == want


@pytest.mark.parametrize("fn, tag", [
    ("get_all_events", None), ("get_scalar_tags", None),
    ("get_tag_values", "losses/loss"),
    ("get_histogram_values", "acts/h"),
    ("get_histogram_values", "acts/unpacked"),
    ("get_image_values", "examples/out"), ("get_image_tags", None),
    ("get_histogram_tags", None), ("get_tag_index", None),
    ("get_histogram_plot_data", "acts/h"),
    ("get_histogram_plot_data", "acts/unpacked")])
def test_reader_equals_hemx(runs, fn, tag):
    from hemx.summaries import reader as H
    from hemx_torch.summaries import reader as T
    logdir = os.path.join(runs["a"], "train")
    args = (logdir,) if tag is None else (logdir, tag)
    want = getattr(H, fn)(*args)
    got = getattr(T, fn)(*args)
    if fn == "get_all_events":  # wall times differ by file; both read
        want = {k: [r[1:] for r in v] for k, v in want.items()}
        got = {k: [r[1:] for r in v] for k, v in got.items()}
    _same(got, want)
    assert want  # every case reads something


def test_resumed_steps_keep_the_latest(runs):
    from hemx_torch.summaries import reader as T
    logdir = os.path.join(runs["a"], "train")
    assert T.get_tag_values(logdir, "losses/loss") == [
        (0, 1.0), (1, 0.5), (2, 12.0), (3, 13.0), (4, 14.0), (5, 15.0)]
    hist = dict(T.get_histogram_values(logdir, "acts/h"))
    assert sorted(hist) == [0, 1, 2, 3, 4, 5]
    assert hist[2]["num"] == 100.0 and hist[1]["num"] == 200.0
    unpacked = dict(T.get_histogram_values(logdir, "acts/unpacked"))[7]
    assert unpacked["bucket_limit"] == [0.0, 1.0, 3.0]
    assert unpacked["bucket"] == [1.0, 3.0, 2.0]
    images = dict(T.get_image_values(logdir, "examples/out"))
    assert sorted(images) == list(range(6))
    assert all(v.startswith(PNG_MAGIC) for v in images.values())


def test_histogram_plot_renders(runs, tmp_path):
    from hemx_torch.summaries.reader import render_histogram_plot
    out = render_histogram_plot(os.path.join(runs["a"], "train"), "acts/h",
                                str(tmp_path / "h.png"))
    with open(out, "rb") as f:
        assert f.read(8) == PNG_MAGIC
    with pytest.raises(ValueError):
        render_histogram_plot(os.path.join(runs["a"], "train"), "nope",
                              str(tmp_path / "x.png"))


def test_misc_equals_hemx():
    from hemx.utils import misc as H
    from hemx_torch.utils import misc as T
    items = list(range(11))
    assert list(T.chunks(items, 4)) == list(H.chunks(items, 4))
    arrays = {"x": np.arange(11.0), "y": np.arange(11.0) ** 2}
    fn = lambda b: b["y"].sum() / b["x"].sum()  # noqa: E731
    assert T.fold(fn, arrays, 3) == H.fold(fn, arrays, 3)
    with pytest.raises(ValueError, match="smaller than one batch"):
        T.fold(fn, arrays, 12)


def _port_cnn(hw=16, latent=8):
    import types
    from hemx_torch.models.cnn import CnnModel
    args = types.SimpleNamespace(latent_size=latent, dtype="float32",
                                 optimizer="rmsprop", lr=1e-3, decay=0.9,
                                 momentum=0.0, centered=False)
    model = CnnModel(args, "cpu")
    return model, model.build_nets((3, hw, hw), 5)


def _hemx_cnn(port_net, hw=16, latent=8):
    """hemx's CNN built for the same images, with the port's weights in
    hemx's layout."""
    from tests.conftest import make_args
    from hemx.models.plugin import get_model
    from hemx.parallel.mesh import make_mesh
    from hemx_torch.convert import to_jax
    model = get_model("cnn")(make_args(latent_size=latent), make_mesh(1))
    model._net = model._build((2, hw, hw, 3))
    params, mstate = to_jax(port_net)
    tree = lambda t: jax.tree_util.tree_map(jnp.asarray, t)  # noqa: E731
    return model, {"params": tree(params), "mstate": tree(mstate)}


def test_visualize_parameters_equals_hemx():
    from hemx.utils.misc import visualize_parameters as H
    from hemx_torch.utils.misc import visualize_parameters as T
    _, net = _port_cnn()
    _, ts = _hemx_cnn(net)
    table = T(net)
    assert table == H(ts["params"])
    total = sum(p.numel() for p in net.parameters())
    assert table.splitlines()[-1].split()[-1] == f"{total:,d}"


def test_fid_math_equals_hemx():
    from hemx.metrics import fid as H
    from hemx_torch.metrics import fid as T
    rng = np.random.default_rng(7)
    a = rng.normal(size=(64, 6))
    b = rng.normal(size=(48, 6)) * 1.3 + 0.2
    for got, want in zip(T.gaussian_stats(a), H.gaussian_stats(a)):
        np.testing.assert_allclose(got, want, rtol=1e-10)
    m = np.cov(a, rowvar=False)
    np.testing.assert_allclose(T._sqrtm_psd(m), H._sqrtm_psd(m), rtol=1e-10,
                               atol=1e-12)
    mu1, s1 = H.gaussian_stats(a)
    mu2, s2 = H.gaussian_stats(b)
    np.testing.assert_allclose(T.frechet_distance(mu1, s1, mu2, s2),
                               H.frechet_distance(mu1, s1, mu2, s2),
                               rtol=1e-10)
    np.testing.assert_allclose(T.fid_from_features(a, b),
                               H.fid_from_features(a, b), rtol=1e-10)
    assert abs(T.fid_from_features(a, a)) < 1e-6 * np.trace(s1)
    x, y = _images(1, 8, 19), _images(2, 8, 19)  # 19 px: the crop matters
    for size in (8, 4):
        np.testing.assert_allclose(T.pixel_features(x, size),
                                   H.pixel_features(x, size), rtol=1e-6,
                                   atol=1e-7)
    np.testing.assert_allclose(
        T.pixel_features(torch.from_numpy(x).permute(0, 3, 1, 2)),
        H.pixel_features(x), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(T.fid_from_images(x, y), H.fid_from_images(x, y),
                               rtol=1e-6)


def test_encoder_features_equal_hemx():
    from hemx.metrics.fid import encoder_features as H
    from hemx_torch.metrics.fid import encoder_features as T
    model, net = _port_cnn()
    hmodel, hts = _hemx_cnn(net)
    from hemx_torch.models import common
    ts = common.TrainState(nets=net, opt=None, step=0, rng=common.prng_key(5))
    x = _images(4, 4, 16)
    got = T(model, ts)(x)
    want = np.asarray(H(hmodel, hts)(jnp.asarray(x)))
    assert got.shape == want.shape == (4, 8)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(T(model, ts)(torch.from_numpy(x).permute(
        0, 3, 1, 2)), got, rtol=0, atol=0)


def test_encoder_features_vae_has_no_latent():
    import types
    from hemx_torch.metrics.fid import encoder_features
    from hemx_torch.models import common
    from hemx_torch.models.vae import VaeModel
    args = types.SimpleNamespace(latent_size=8, dtype="float32")
    model = VaeModel(args, "cpu")
    ts = common.TrainState(nets=model.build_nets((3, 16, 16), 3), opt=None,
                           step=0, rng=common.prng_key(3))
    with pytest.raises(ValueError, match=r"no 'latent' intermediate "
                       r"captured; available: \['c1', 'c2'"):
        encoder_features(model, ts)(_images(0, 2, 16))


def _quiet(fn, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = fn(argv)
    return rc, out.getvalue()


def test_events_main_equals_hemx(runs, tmp_path):
    import events as H
    from hemx_torch import events as T
    for flags in ([], ["--tags", "loss", "--logy"]):
        got = _quiet(T.main, [runs["a"], runs["b"], "--out",
                              str(tmp_path / "t.pdf")] + flags)
        want = _quiet(H.main, [runs["a"], runs["b"], "--out",
                               str(tmp_path / "h.pdf")] + flags)
        count = lambda s: re.search(r"\((\d+) series\)", s).group(1)  # noqa: E731
        assert got[0] == want[0] == 0 and count(got[1]) == count(want[1])
        assert (tmp_path / "t.pdf").stat().st_size > 0
    assert (_quiet(T.main, [runs["a"], "--histogram", "list"])
            == _quiet(H.main, [runs["a"], "--histogram", "list"]))
    out = str(tmp_path / "fan.png")
    assert T.main([runs["a"], "--histogram", "acts/h", "--out", out]) == 0
    with open(out, "rb") as f:
        assert f.read(8) == PNG_MAGIC
    assert T.main([str(tmp_path / "none"), "--out", out]) == 1


@pytest.fixture(scope="module")
def thesis_root(tmp_path_factory):
    """The ``--root`` layout, each run's train events with the tags the
    presets read; some runs left out (the presets skip them)."""
    from hemx_torch.summaries.events import EventsWriter
    root = tmp_path_factory.mktemp("thesis")
    runs = ["standalone/baseline", "standalone/mean_adjusted",
            "cgan/baseline", "cgan/mean_adjusted", "cgan/mean_provided",
            "sampler/baseline_x", "sampler/baseline_e1",
            "sampler/baseline_d4"]
    for k, run in enumerate(runs):
        w = EventsWriter(str(root / run / "train"))
        for step in range(3):
            w.scalars({"metrics_y_hat/linear_rmse": 1.0 / (k + step + 1),
                       "metrics_y_hat/log_rmse": 0.3 + k,
                       "losses/d_fake": 0.7 - 0.1 * step,
                       "metrics_y_sampler/linear_rmse": 0.2 * k + step,
                       "sampler/sample_variance": 1e-3 * (k + 1),
                       "sampler/mean_sample_l2": 2.0 + k,
                       "sampler/min_sample_l2": 1.0 + k}, step)
        w.close()
    return str(root)


@pytest.mark.parametrize("experiment", ["1", "1b", "2"])
def test_paper_visualize_presets_equal_hemx(thesis_root, tmp_path,
                                            experiment):
    import paper_visualize as H
    from hemx_torch import paper_visualize as T
    name = {"1": "render_experiment1", "1b": "render_experiment1b",
            "2": "render_experiment2"}[experiment]
    got = getattr(T, name)(thesis_root, str(tmp_path / "t.pdf"))
    want = getattr(H, name)(thesis_root, str(tmp_path / "h.pdf"))
    assert got == want > 0
    rc, text = _quiet(T.main, ["--experiment", experiment, "--root",
                               thesis_root, "--out", str(tmp_path / "m.pdf")])
    assert rc == 0 and f"({got} series)" in text
    assert T.main(["--experiment", experiment, "--root",
                   str(tmp_path / "empty"), "--out",
                   str(tmp_path / "e.pdf")]) == 1


def test_paper_visualize_generic_equals_hemx(thesis_root, tmp_path):
    import paper_visualize as H
    from hemx_torch import paper_visualize as T
    dirs = [os.path.join(thesis_root, r) for r in
            ("cgan/baseline", "standalone/baseline", "sampler/baseline_x")]
    assert sorted(T.find_metric_tags(dirs[0])) == sorted(
        H.find_metric_tags(dirs[0]))
    for metrics in (["linear_rmse", "log_rmse", "t1"], ["linear_rmse"]):
        got = T.render_experiment(dirs, metrics, str(tmp_path / "t.pdf"))
        want = H.render_experiment(dirs, metrics, str(tmp_path / "h.pdf"))
        assert got == want > 0


@pytest.fixture(scope="module")
def servers(runs):
    import visualize_gui as H
    from hemx_torch import visualize_gui as T
    out, httpds = {}, []
    for side, mod in (("hemx", H), ("port", T)):
        httpd, n = mod.make_server(runs["root"], 0)
        threading.Thread(target=httpd.serve_forever, daemon=True).start()
        httpds.append(httpd)
        out[side] = (f"http://127.0.0.1:{httpd.server_address[1]}", n)
    yield out
    for httpd in httpds:
        httpd.shutdown()
        httpd.server_close()


def _get(base, path):
    try:
        with urllib.request.urlopen(base + path, timeout=30) as r:
            return r.status, r.headers["Content-Type"], r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers["Content-Type"], e.read()


HTML_ROUTES = ["/", "/run/0", "/run/1",
               "/images?run=0&phase=train&tag=examples%2Fout",
               "/images?run=0&phase=validate&tag=examples%2Fout"]
PNG_ROUTES = ["/chart?run=0&phase=train&tag=losses%2Floss",
              "/chart?run=1&phase=train&tag=losses%2Fd_loss",
              "/hist?run=0&phase=train&tag=acts%2Fh"]
NOT_FOUND = ["/run/-1", "/run/2", "/run/x", "/chart?run=-1&phase=train&tag=t",
             "/chart?run=0&phase=train", "/image.png?run=0&phase=train&"
             "tag=examples%2Fout&step=99", "/nowhere"]


def test_gui_routes_equal_hemx(servers, runs):
    from hemx_torch import visualize_gui as T
    (hemx, n_hemx), (port, n_port) = servers["hemx"], servers["port"]
    assert n_hemx == n_port == 2
    assert T.discover_runs(runs["root"]) == [runs["a"], runs["b"]]
    for path in HTML_ROUTES:
        got, want = _get(port, path), _get(hemx, path)
        assert got[0] == want[0] == 200, path
        assert got == want, path
    for path in PNG_ROUTES:
        code, ctype, body = _get(port, path)
        assert (code, ctype) == (200, "image/png") and body[:8] == PNG_MAGIC
    for step in (0, 3, 5):
        path = f"/image.png?run=0&phase=train&tag=examples%2Fout&step={step}"
        got, want = _get(port, path), _get(hemx, path)
        assert got == want and got[2][:8] == PNG_MAGIC, path
    for path in NOT_FOUND:
        assert _get(port, path)[0] == _get(hemx, path)[0] == 404, path


def test_gui_escapes_names(tmp_path):
    import visualize_gui as H
    from hemx_torch import visualize_gui as T
    from hemx_torch.summaries.events import EventsWriter
    run = tmp_path / "<b>run&"
    w = EventsWriter(str(run / "train"))
    w.scalar("losses/<i>x</i>", 1.0, 0)
    w.close()
    assert T.index_html([str(run)]) == H.index_html([str(run)])
    page = T.run_html(0, str(run))
    assert page == H.run_html(0, str(run))
    assert "<i>x</i>" not in page and "&lt;i&gt;x&lt;/i&gt;" in page
    assert "<b>run&" not in T.index_html([str(run)])


@pytest.fixture(scope="module")
def vae_family(tmp_path_factory):
    return compare_family(tmp_path_factory.mktemp("visualize_vae"), "vae")


def test_vae_visualize_file_set(vae_family):
    check_file_set(vae_family)


def test_vae_visualize_weight_grids(vae_family):
    check_weight_grids(vae_family)


def test_vae_visualize_images(vae_family):
    check_images(vae_family)


def test_vae_visualize_bestfit_first_step(vae_family):
    check_bestfit_first_step(vae_family)
