"""Loss-curve plotter from tfevents (counterpart of the root
``events.py``).

    python -m hemx_torch.events workspace/iwgan workspace/gan \
        [--tags d_loss g_loss] [--out losses.pdf] [--logy]
    python -m hemx_torch.events workspace/cnn --histogram list
    python -m hemx_torch.events workspace/cnn --histogram TAG [--out h.png]

Renders the train (solid) and validate (dashed) ``losses/*`` curves of one
or more runs into one PDF/PNG, or with ``--histogram TAG`` the percentile
fan of one histogram tag of the first run's train events (``list`` prints
the tags). Reads hemx's and the port's event files alike; matplotlib is
imported only to render."""

from __future__ import annotations

import argparse
import os
import sys

from hemx_torch.summaries.reader import (get_all_events, get_histogram_tags,
                                         render_histogram_plot)
from hemx_torch.utils.terminal import message


def plot_run(ax, run_dir: str, tags=None, phases=("train", "validate")):
    plotted = 0
    for phase in phases:
        events = get_all_events(os.path.join(run_dir, phase))
        for tag, rows in sorted(events.items()):
            if not tag.startswith("losses/"):
                continue
            short = tag.split("/", 1)[1]
            if tags and short not in tags:
                continue
            steps = [r[1] for r in rows]
            vals = [r[2] for r in rows]
            style = "-" if phase == "train" else "--"
            ax.plot(steps, vals, style,
                    label=f"{os.path.basename(run_dir)} {phase}/{short}")
            plotted += 1
    return plotted


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="hemx_torch events plotter")
    parser.add_argument("dirs", nargs="+", help="Run workspace dirs.")
    parser.add_argument("--tags", nargs="*", default=None,
                        help="Loss names to include (default all).")
    parser.add_argument("--out", default="losses.pdf")
    parser.add_argument("--logy", action="store_true")
    parser.add_argument("--histogram", default=None, metavar="TAG",
                        help="Render TAG's histogram evolution as a "
                             "percentile-fan chart instead of loss curves. "
                             "Use --histogram list to enumerate tags.")
    a = parser.parse_args(argv)

    if a.histogram:
        run = os.path.join(a.dirs[0], "train")
        if a.histogram == "list":
            for t in get_histogram_tags(run):
                print(t)
            return 0
        out = a.out if a.out != "losses.pdf" else "histogram.png"
        render_histogram_plot(run, a.histogram, out)
        message(f"wrote {out}")
        return 0

    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(9, 5.5))
    total = 0
    for run_dir in a.dirs:
        total += plot_run(ax, run_dir, a.tags)
    if total == 0:
        plt.close(fig)
        message("no loss series found")
        return 1
    if a.logy:
        ax.set_yscale("log")
    ax.set_xlabel("step")
    ax.set_ylabel("loss")
    ax.legend(fontsize=8)
    ax.grid(alpha=0.3)
    fig.savefig(a.out, bbox_inches="tight")
    plt.close(fig)
    message(f"wrote {a.out} ({total} series)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
