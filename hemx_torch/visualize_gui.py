"""Run browser (counterpart of the root ``visualize_gui.py``).

    python -m hemx_torch.visualize_gui --workspace workspace [--list]
    python -m hemx_torch.visualize_gui --serve --workspace workspace \
        [--port 6006]

Two frontends over the same data:

* terminal browser (default): list the workspace's runs, their
  checkpoints and scalar tags, render any tag to a PNG chart;
* web GUI (``--serve``): a stdlib ``http.server`` app on 127.0.0.1 with
  the routes ``/`` (the run list), ``/run/N`` (a run's tags), ``/chart``
  (a scalar chart), ``/hist`` (a histogram's percentile fan), ``/images``
  (an image tag's gallery) and ``/image.png`` (one image event). A run is
  named by its index: a negative, out-of-range or missing one is a 404,
  and every name on a page is HTML-escaped.

Runs written by hemx and by the port read alike. matplotlib is imported
only to draw a chart. wxPython is looked for, as hemx does, but there is no
wx frontend.
"""

from __future__ import annotations

import argparse
import html
import io
import os
import sys
import urllib.parse

from hemx_torch.summaries.reader import (get_all_events,
                                         get_histogram_plot_data,
                                         get_image_values, get_tag_index,
                                         get_tag_values)
from hemx_torch.train.checkpoint import CheckpointManager
from hemx_torch.utils.terminal import message

PHASES = ("train", "validate", "test")


def discover_runs(workspace: str) -> list[str]:
    runs = []
    for root, dirs, files in os.walk(workspace):
        if "options.config" in files or any(
                d in dirs for d in ("train", "validate")):
            runs.append(root)
            dirs.clear()
    return sorted(runs)


def describe_run(run_dir: str) -> None:
    print(f"\n== {run_dir}")
    ckpts = CheckpointManager(run_dir).checkpoints()
    print(f"   checkpoints: {[e for e, _ in ckpts]}")
    for phase in ("train", "validate", "test"):
        tags = sorted(get_all_events(os.path.join(run_dir, phase)))
        if tags:
            print(f"   {phase} tags: {', '.join(tags[:12])}"
                  + (" ..." if len(tags) > 12 else ""))


def plot_tag(run_dir: str, phase: str, tag: str, out: str) -> None:
    series = get_tag_values(os.path.join(run_dir, phase), tag)
    if not series:
        message(f"no data for {phase}/{tag}")
        return
    with open(out, "wb") as f:
        f.write(render_scalar_png(run_dir, phase, tag, series=series))
    message(f"wrote {out}")


def tui(workspace: str) -> int:
    runs = discover_runs(workspace)
    if not runs:
        message(f"no runs under {workspace}")
        return 1
    for i, r in enumerate(runs):
        print(f"[{i}] {r}")
    try:
        while True:
            cmd = input("\n(run#, 'run# phase tag out.png' to plot, "
                        "q to quit)> ").strip()
            if cmd in ("q", "quit", ""):
                return 0
            parts = cmd.split()
            # a typo must reprint the prompt, not end the session with a
            # traceback; reject negative run indices like the web handler
            try:
                idx = int(parts[0])
                if not 0 <= idx < len(runs):
                    raise ValueError(f"run index out of range: {idx}")
                run = runs[idx]
                if len(parts) == 1:
                    describe_run(run)
                elif len(parts) < 3:
                    raise ValueError("usage: run# phase tag [out.png]")
                else:
                    phase, tag = parts[1], parts[2]
                    out = parts[3] if len(parts) > 3 else "tag.png"
                    plot_tag(run, phase, tag, out)
            except ValueError as e:
                message(str(e))
    except (EOFError, KeyboardInterrupt):
        return 0


# ---------------------------------------------------------------------------
# Web GUI (--serve): stdlib http.server + matplotlib-Agg chart rendering.

_STYLE = """<style>
body{font-family:system-ui,sans-serif;margin:2em;max-width:70em}
a{color:#06c;text-decoration:none} a:hover{text-decoration:underline}
h1,h2{font-weight:600} code{background:#f3f3f3;padding:0 .3em}
img{max-width:100%;border:1px solid #ddd;margin:.3em 0}
ul{line-height:1.7}.dim{color:#888}
</style>"""


def _page(title: str, body: str) -> str:
    return (f"<!doctype html><html><head><meta charset='utf-8'>"
            f"<title>{html.escape(title)}</title>{_STYLE}</head>"
            f"<body><h1>{html.escape(title)}</h1>{body}</body></html>")


def index_html(runs: list[str]) -> str:
    items = "".join(
        f"<li><a href='/run/{i}'>{html.escape(r)}</a></li>"
        for i, r in enumerate(runs))
    return _page("hemx runs", f"<ul>{items}</ul>" if items
                 else "<p class='dim'>no runs found</p>")


def run_html(idx: int, run_dir: str) -> str:
    ckpts = [e for e, _ in CheckpointManager(run_dir).checkpoints()]
    parts = [f"<p><a href='/'>&larr; all runs</a></p>",
             f"<p>checkpoints: <code>{html.escape(str(ckpts))}</code></p>"]
    for phase in PHASES:
        logdir = os.path.join(run_dir, phase)
        index = get_tag_index(logdir)  # one parse for all three tag kinds
        scalars = index["scalars"]
        histos = index["histograms"]
        images = index["images"]
        if not (scalars or histos or images):
            continue
        parts.append(f"<h2>{phase}</h2><ul>")
        q = lambda tag: urllib.parse.urlencode(
            {"run": idx, "phase": phase, "tag": tag})
        for t in scalars:
            parts.append(f"<li><a href='/chart?{q(t)}'>"
                         f"{html.escape(t)}</a></li>")
        for t in histos:
            parts.append(f"<li><a href='/hist?{q(t)}'>{html.escape(t)}</a>"
                         " <span class='dim'>(histogram)</span></li>")
        for t in images:
            parts.append(f"<li><a href='/images?{q(t)}'>{html.escape(t)}</a>"
                         " <span class='dim'>(images)</span></li>")
        parts.append("</ul>")
    return _page(os.path.basename(run_dir) or run_dir, "".join(parts))


def _chart_figure():
    """(fig, ax) via the thread-safe OO API — request handlers run on
    ThreadingHTTPServer worker threads, and pyplot's global state machine is
    not thread-safe (two concurrent chart requests could cross-contaminate
    figures)."""
    from matplotlib.backends.backend_agg import FigureCanvasAgg
    from matplotlib.figure import Figure

    fig = Figure(figsize=(8, 4.5))
    FigureCanvasAgg(fig)  # attaches itself as fig.canvas
    return fig, fig.add_subplot(111)


def _fig_png(fig) -> bytes:
    buf = io.BytesIO()
    fig.savefig(buf, format="png", bbox_inches="tight")
    return buf.getvalue()


def render_scalar_png(run_dir: str, phase: str, tag: str, series=None) -> bytes:
    if series is None:
        series = get_tag_values(os.path.join(run_dir, phase), tag)
    fig, ax = _chart_figure()
    if series:
        ax.plot([s for s, _ in series], [v for _, v in series])
    ax.set_title(f"{os.path.basename(run_dir)} {phase}/{tag}")
    ax.set_xlabel("step")
    ax.grid(alpha=0.3)
    return _fig_png(fig)


def render_histogram_png(run_dir: str, phase: str, tag: str) -> bytes:
    """TensorBoard-style percentile fan."""
    steps, series = get_histogram_plot_data(os.path.join(run_dir, phase), tag)
    fig, ax = _chart_figure()
    qs = sorted(series)
    for lo, hi in zip(qs, qs[::-1]):
        if lo >= hi:
            break
        ax.fill_between(steps, series[lo], series[hi], alpha=0.25,
                        color="#3465a4", linewidth=0)
    if 50 in series:
        ax.plot(steps, series[50], color="#204a87")
    ax.set_title(f"{os.path.basename(run_dir)} {phase}/{tag}")
    ax.set_xlabel("step")
    ax.grid(alpha=0.3)
    return _fig_png(fig)


def images_html(idx: int, run_dir: str, phase: str, tag: str,
                last_n: int = 8) -> str:
    rows = get_image_values(os.path.join(run_dir, phase), tag)
    parts = [f"<p><a href='/run/{idx}'>&larr; {html.escape(run_dir)}</a></p>"]
    for step, _ in rows[-last_n:][::-1]:
        q = urllib.parse.urlencode({"run": idx, "phase": phase, "tag": tag,
                                    "step": step})
        parts.append(f"<h2>step {step}</h2><img src='/image.png?{q}'>")
    if not rows:
        parts.append("<p class='dim'>no image events</p>")
    return _page(f"{phase}/{tag}", "".join(parts))


class _NotFound(Exception):
    """Raised by handlers for bad run indices -> 404 (not 500)."""


def make_server(workspace: str, port: int):
    """Build the web-GUI HTTP server without starting it (port 0 binds an
    ephemeral port — read it back from server_address; lets tests run and
    shut the server down deterministically)."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    runs = discover_runs(workspace)

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *args):
            pass

        def _send(self, body: bytes, ctype: str = "text/html; charset=utf-8",
                  code: int = 200) -> None:
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _run_index(self, raw) -> int:
            """Validated run index — rejects non-integers, out-of-range AND
            negative values (raw int() indexing would silently resolve
            /run/-1 to the last run via Python negative indexing, and a
            non-numeric value would 500 instead of 404)."""
            try:
                i = int(raw)
            except (TypeError, ValueError):
                raise _NotFound(f"run {raw!r}")
            if i not in range(len(runs)):
                raise _NotFound(f"run {i}")
            return i

        @staticmethod
        def _param(qs, key) -> str:
            """Required query param -> 404 when absent (a missing ?run=/
            ?phase=/?tag= is a client error, not a server fault)."""
            try:
                return qs[key][0]
            except (KeyError, IndexError):
                raise _NotFound(f"missing query param {key!r}")

        def _qs_run(self, qs) -> tuple[str, str, str]:
            # index, not a path: no traversal
            run_dir = runs[self._run_index(self._param(qs, "run"))]
            return run_dir, self._param(qs, "phase"), self._param(qs, "tag")

        def do_GET(self):
            try:
                parsed = urllib.parse.urlparse(self.path)
                qs = urllib.parse.parse_qs(parsed.query)
                if parsed.path == "/":
                    self._send(index_html(runs).encode())
                elif parsed.path.startswith("/run/"):
                    i = self._run_index(parsed.path.split("/")[2])
                    self._send(run_html(i, runs[i]).encode())
                elif parsed.path == "/chart":
                    d, p, t = self._qs_run(qs)
                    self._send(render_scalar_png(d, p, t), "image/png")
                elif parsed.path == "/hist":
                    d, p, t = self._qs_run(qs)
                    self._send(render_histogram_png(d, p, t), "image/png")
                elif parsed.path == "/images":
                    i = self._run_index(self._param(qs, "run"))
                    self._send(images_html(i, runs[i],
                                           self._param(qs, "phase"),
                                           self._param(qs, "tag")).encode())
                elif parsed.path == "/image.png":
                    d, p, t = self._qs_run(qs)
                    try:
                        step = int(self._param(qs, "step"))
                    except ValueError:
                        raise _NotFound("step")
                    png = dict(get_image_values(
                        os.path.join(d, p), t)).get(step)
                    if png is None:  # unknown/stale step: 404, not an
                        raise _NotFound(f"step {step}")  # empty 200 image
                    self._send(png, "image/png")
                else:
                    self._send(b"not found", "text/plain", 404)
            except _NotFound as e:
                self._send(f"not found: {e}".encode(), "text/plain", 404)
            except Exception as e:  # one bad request must not kill the server
                self._send(f"error: {e}".encode(), "text/plain", 500)

    return ThreadingHTTPServer(("127.0.0.1", port), Handler), len(runs)


def serve(workspace: str, port: int) -> int:
    httpd, n_runs = make_server(workspace, port)
    message(f"serving {n_runs} runs at "
            f"http://127.0.0.1:{httpd.server_address[1]}/ (ctrl-c to stop)")
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.server_close()
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="hemx_torch run browser")
    parser.add_argument("--workspace", default="workspace")
    parser.add_argument("--list", action="store_true",
                        help="Describe all runs and exit (non-interactive).")
    parser.add_argument("--serve", action="store_true",
                        help="Serve the web GUI instead of the terminal UI.")
    parser.add_argument("--port", type=int, default=6006)
    a = parser.parse_args(argv)
    if a.serve:
        return serve(a.workspace, a.port)
    try:
        import wx  # noqa: F401  (hemx's check, copied as it is)
        message("wxPython found but the wx frontend is not implemented; use "
                "--serve for the graphical (web) browser.")
    except ImportError:
        pass
    if a.list:
        for run in discover_runs(a.workspace):
            describe_run(run)
        return 0
    return tui(a.workspace)


if __name__ == "__main__":
    sys.exit(main())
