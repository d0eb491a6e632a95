"""Thesis charts from tfevents across run dirs (counterpart of the root
``paper_visualize.py``).

    python -m hemx_torch.paper_visualize RUN [RUN ...] [--metrics ...] \
        [--variant y_hat|y_0|y_mean|y_sampler] [--phase train] [--out F]
    python -m hemx_torch.paper_visualize --experiment 1|1b|2 \
        [--root workspace/thesis] [--out F]

Two modes:

* generic (positional dirs): one comparison figure of Eigen metric
  curves (``metrics_<variant>/<metric>``) across arbitrary runs;
* ``--experiment 1|1b|2``: the thesis's three figures (``experiment1.pdf``,
  ``experiment1b.pdf``, ``experiment2.pdf``) with their fixed run lists,
  tags and layouts, over the ``--root`` layout:

      <root>/standalone/<version>     paper_standalone runs
      <root>/cgan/<version>           paper_cgan runs
      <root>/sampler/baseline_<site>  paper_sampler --noise_layer runs

  Missing runs are skipped. The tags are the ones the paper models write
  (``metrics_y_hat/linear_rmse``, ``losses/d_fake``,
  ``sampler/sample_variance``, ``sampler/{mean,min}_sample_l2``), in hemx's
  event files and the port's alike.

matplotlib is imported only to render.
"""

from __future__ import annotations

import argparse
import os
import sys

from hemx_torch.summaries.reader import get_all_events, get_tag_values
from hemx_torch.utils.terminal import message

def _pyplot():
    """matplotlib's pyplot on the Agg backend, imported on first use."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


DEFAULT_METRICS = ["linear_rmse", "log_rmse", "abs_rel_diff",
                   "scale_invariant_log_rmse", "t1", "t2", "t3"]


def find_metric_tags(run_dir: str, phase: str = "train") -> list[str]:
    return [t for t in get_all_events(os.path.join(run_dir, phase))
            if t.startswith("metrics_")]


def render_experiment(run_dirs: list[str], metrics: list[str], out: str,
                      variant: str = "y_hat", phase: str = "train") -> int:
    plt = _pyplot()
    n = len(metrics)
    ncols = min(n, 3)
    nrows = -(-n // ncols)
    fig, axes = plt.subplots(nrows, ncols, figsize=(5 * ncols, 3.5 * nrows),
                             squeeze=False)
    plotted = 0
    # one event-file parse per run (get_tag_values per metric would
    # re-parse the same logdir len(metrics) times)
    events_by_run = {r: get_all_events(os.path.join(r, phase))
                     for r in run_dirs}
    for i, metric in enumerate(metrics):
        ax = axes[i // ncols][i % ncols]
        for run_dir in run_dirs:
            tag = f"metrics_{variant}/{metric}"
            series = get_tag_values(os.path.join(run_dir, phase), tag,
                                    events=events_by_run[run_dir])
            if not series:
                continue
            ax.plot([s for s, _ in series], [v for _, v in series],
                    label=os.path.basename(os.path.normpath(run_dir)))
            plotted += 1
        ax.set_title(metric)
        ax.grid(alpha=0.3)
        if i == 0:
            ax.legend(fontsize=7)
    for j in range(n, nrows * ncols):
        axes[j // ncols][j % ncols].axis("off")
    fig.savefig(out, bbox_inches="tight")
    plt.close(fig)
    return plotted


def _series(run_dir: str, tag: str, phase: str = "train",
            cache: dict | None = None):
    """[(step, value)] for one tag, with per-(run, phase) event caching."""
    logdir = os.path.join(run_dir, phase)
    if cache is not None:
        if logdir not in cache:
            cache[logdir] = get_all_events(logdir)
        return get_tag_values(logdir, tag, events=cache[logdir])
    return get_tag_values(logdir, tag)


def _panel_style(ax):
    """The thesis's spartan panel styling: dotted y-grid, no spines, ticks
    out."""
    ax.yaxis.grid(True, linestyle="dotted")
    ax.xaxis.grid(False)
    ax.set_axisbelow(True)
    for s in ("right", "top", "bottom", "left"):
        ax.spines[s].set_visible(False)


# Preset run lists under --root. Labels use plain mathtext (no LaTeX
# toolchain needed).
_EXP1_VERSIONS = [("baseline", r"(a) $G(x) = \hat{y}$"),
                  ("mean_adjusted", r"(b) $G(x) = \hat{y} - \bar{y}$"),
                  ("mean_provided", r"(c) $G(x, \bar{y}) = \hat{y} - \bar{y}$")]
_EXP1_FAMILIES = [("standalone", r"$G_{\ell_2}$"),
                  ("cgan", r"$G_{cGAN}$")]
_EXP2_SITES = [("cgan/mean_adjusted", "none"), ("sampler/baseline_x", "$x$"),
               ("sampler/baseline_e1", "$e_1$"),
               ("sampler/baseline_e2", "$e_2$"),
               ("sampler/baseline_e3", "$e_3$"),
               ("sampler/baseline_e4-512", "$e_4$"),
               ("sampler/baseline_d2", "$d_2$"),
               ("sampler/baseline_d3", "$d_3$"),
               ("sampler/baseline_d4", "$d_4$")]


def render_experiment1(root: str, out: str, phase: str = "train") -> int:
    """experiment1.pdf: RMSE(y, y_hat) training curves, one panel per
    model_version, standalone-vs-cgan per panel."""
    plt = _pyplot()
    cache: dict = {}
    fig, axes = plt.subplots(1, 3, figsize=(9, 3), sharey=True)
    plotted = 0
    for ax, (version, title) in zip(axes, _EXP1_VERSIONS):
        _panel_style(ax)
        for fam, label in _EXP1_FAMILIES:
            run = os.path.join(root, fam, version)
            s = _series(run, "metrics_y_hat/linear_rmse", phase, cache)
            if not s:
                continue
            ax.plot([x for x, _ in s], [v for _, v in s],
                    linewidth=1.0, label=label)
            plotted += 1
        ax.set_title(title, fontsize=9)
        ax.set_xlabel("Step", fontsize=8)
    if plotted:
        axes[-1].legend(fontsize=8, loc="upper right")
        axes[0].set_ylabel(r"RMSE$(y, \hat{y})$", fontsize=8)
    fig.tight_layout(pad=2)
    fig.savefig(out, bbox_inches="tight")
    plt.close(fig)
    return plotted


def render_experiment1b(root: str, out: str, phase: str = "train") -> int:
    """experiment1b.pdf: cGAN D-fake loss (left axis) + mean RMSE (right
    axis, twinx) per model_version panel."""
    plt = _pyplot()
    cache: dict = {}
    fig, axes = plt.subplots(1, 3, figsize=(9, 3))
    plotted = 0
    handles, labels = [], []
    for ax, (version, title) in zip(axes, _EXP1_VERSIONS):
        _panel_style(ax)
        axb = ax.twinx()
        run = os.path.join(root, "cgan", version)
        d = _series(run, "losses/d_fake", phase, cache)
        r = _series(run, "metrics_y_hat/linear_rmse", phase, cache)
        if d:
            (h1,) = ax.plot([x for x, _ in d], [v for _, v in d],
                            linewidth=1.0, color="tab:blue")
            plotted += 1
        if r:
            (h2,) = axb.plot([x for x, _ in r], [v for _, v in r],
                             linewidth=1.0, color="tab:orange")
            plotted += 1
        if d and r and not handles:
            handles, labels = [h1, h2], ["$D$ loss", "Mean RMSE"]
        ax.set_title(title, fontsize=9)
        ax.set_xlabel("Step", fontsize=8)
    if handles:
        axes[-1].legend(handles, labels, fontsize=8, loc="lower right")
        axes[0].set_ylabel(r"$L_{D(x,\hat{y})}$", fontsize=8)
    fig.tight_layout(pad=2)
    fig.savefig(out, bbox_inches="tight")
    plt.close(fig)
    return plotted


def render_experiment2(root: str, out: str, phase: str = "train") -> int:
    """experiment2.pdf: noise-injection-site comparison — final sampler
    RMSE bars, per-image sample variance curves (semilogy), and
    mean-minus-min sample-L2 bars (the sampler/{mean,min}_sample_l2
    tags)."""
    plt = _pyplot()
    cache: dict = {}
    fig, axes = plt.subplots(1, 3, figsize=(9, 3))
    for ax in axes:
        _panel_style(ax)
    plotted = 0
    bars, var_runs = [], []
    for sub, label in _EXP2_SITES:
        run = os.path.join(root, sub)
        s = _series(run, "metrics_y_sampler/linear_rmse", phase, cache)
        if s:
            bars.append((label, s[-1][1]))
        if sub.startswith("sampler/"):
            v = _series(run, "sampler/sample_variance", phase, cache)
            if v:
                var_runs.append((label, v))
    if bars:
        axes[0].bar(range(len(bars)), [v for _, v in bars], 0.5,
                    tick_label=[l for l, _ in bars])
        axes[0].tick_params(axis="x", labelsize=7)
        plotted += len(bars)
    for label, v in var_runs:
        axes[1].semilogy([x for x, _ in v], [y for _, y in v],
                         linewidth=1.0, label=label)
        plotted += 1
    if var_runs:
        axes[1].legend(fontsize=6, ncol=2)
    mm = []
    for sub, label in _EXP2_SITES:
        if not sub.startswith("sampler/"):
            continue
        run = os.path.join(root, sub)
        mean = _series(run, "sampler/mean_sample_l2", phase, cache)
        mn = _series(run, "sampler/min_sample_l2", phase, cache)
        if mean and mn:
            mm.append((label, mean[-1][1] - mn[-1][1]))
    if mm:
        axes[2].set_yscale("log")
        axes[2].bar(range(len(mm)), [max(v, 1e-12) for _, v in mm], 0.5,
                    tick_label=[l for l, _ in mm])
        axes[2].tick_params(axis="x", labelsize=7)
        plotted += len(mm)
    for ax, title in zip(axes, ("RMSE", "Var", "Mean - Min")):
        ax.set_title(title, fontsize=9)
        ax.set_xlabel("Step" if ax is axes[1] else "", fontsize=8)
    fig.tight_layout(pad=2)
    fig.savefig(out, bbox_inches="tight")
    plt.close(fig)
    return plotted


_PRESETS = {"1": (render_experiment1, "experiment1.pdf"),
            "1b": (render_experiment1b, "experiment1b.pdf"),
            "2": (render_experiment2, "experiment2.pdf")}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="hemx_torch thesis chart renderer")
    parser.add_argument("dirs", nargs="*", help="Run workspace dirs "
                        "(generic mode; ignored with --experiment).")
    parser.add_argument("--metrics", nargs="*", default=DEFAULT_METRICS)
    parser.add_argument("--variant", default="y_hat",
                        choices=["y_hat", "y_0", "y_mean", "y_sampler"])
    parser.add_argument("--phase", default="train")
    parser.add_argument("--out", default=None)
    parser.add_argument("--experiment", choices=sorted(_PRESETS),
                        help="Render one of the three thesis figures from "
                             "the --root run layout.")
    parser.add_argument("--root", default="workspace/thesis",
                        help="Run-dir root for --experiment presets.")
    a = parser.parse_args(argv)

    if a.experiment:
        fn, default_out = _PRESETS[a.experiment]
        out = a.out or default_out
        n = fn(a.root, out, a.phase)
        if n == 0:
            message(f"experiment {a.experiment}: no series found under "
                    f"{a.root} (train the preset runs with "
                    f"python -m hemx_torch.paper_train first)")
            return 1
        message(f"wrote {out} ({n} series)")
        return 0

    if not a.dirs:
        parser.error("positional run dirs required (or use --experiment)")
    out = a.out or "experiment.pdf"
    n = render_experiment(a.dirs, a.metrics, out, a.variant, a.phase)
    if n == 0:
        avail = sorted({t for d in a.dirs
                        for t in find_metric_tags(d, a.phase)})
        message("no metric series found (train the paper_* models first)"
                + (f"; available metric tags: {', '.join(avail)}"
                   if avail else ""))
        return 1
    message(f"wrote {out} ({n} series)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
