"""Post-training visualization of a run (counterpart of the root
``visualize.py``).

    python -m hemx_torch.visualize --dir workspace/iwgan --all
    python -m hemx_torch.visualize --dir workspace/cnn --bestfit \\
        --layer encoder/c1 [--device cpu]

Flags are hemx's: ``--sample``, ``--timelapse``, ``--activations``,
``--weights``, ``--bestfit`` (``--layer``), ``--loss`` and ``--all``, plus
``--device`` (default ``cuda``). The run is rebuilt from its
``options.json`` and its latest checkpoint at hemx's global batch
(``hemx_torch.runs.restore_run``); the images a tool feeds a net are the
train split's first unshuffled global batch, placed on the device as
training places them (``gather_u8_normalize`` for uint8 images). Outputs
go to ``<dir>/visualize/``, under hemx's names:

* ``samples.png``: ``examples`` generated images (the GAN family),
  decoded N(0, 1) samples (the VAE) or reconstructions of the batch (the
  CNN);
* ``timelapse-<epoch:04d>.png``: per checkpoint, ``min(16, examples)``
  samples or the first 16 reconstructions on a 4x4 grid;
* ``activations-<name, / as _>.png``: each 4-D capture of the model's
  main net on the batch, the first example's filters as images, min/max
  normalized per layer. The net is the model's forward (CNN, VAE), its
  bare net (the estimator, the standalone generators) or, for the GAN
  family, the critic on ``2(x - 0.5)``;
* ``weights-<tree path joined by _>.png``: every hemx-layout kernel of
  rank 4 with ``shape[0] >= 3`` and ``shape[2]`` in {1, 3, 4} (a conv's
  HWIO input channels, a deconv's ``[H, W, out, in]`` output channels);
* ``bestfit-<layer>.png``: gradient ascent in image space on up to 16
  filters of ``--layer`` (default: the first captured layer by name);
  each from ``U(0, 1) * 0.2 + 0.4``, 20 steps of the normalized input
  gradient of the filter's mean activation (``x += 0.1 g``, then
  ``x *= 1 - 1e-4``, then on steps 0, 4, ... a 5-tap sigma-1 Gaussian
  blur), min/max normalized;
* ``loss.pdf``: the ``losses/*`` scalars of train and validate
  (matplotlib, imported here).

What ``--all`` writes, model by model (hemx's own tool writes the same):

=============================  ==============================================
model                          ``--all``
=============================  ==============================================
cnn                            samples (reconstructions), timelapse,
                               activations (``encoder/*``, ``decoder/*``),
                               weights (``encoder_c1_w``, ``decoder_dc4_w``),
                               bestfit-decoder, loss
vae                            samples (decoded samples), timelapse,
                               activations (flat names; the decoder's ``c1``
                               ... replace the encoder's), weights, bestfit-c1,
                               loss
gan, wgan, iwgan               samples, timelapse, activations ``c1``-``c3``
                               (the critic), weights (``discriminator_c1_w``,
                               the generator's last deconv), bestfit-c1, loss
mean_depth_estimator           activations ``l1``-``l6``, weights-l1_w,
                               bestfit-l1, loss
paper_standalone,              weights-e1_w, loss (the depth nets capture
paper_baseline_standalone      nothing; bestfit warns); versions
                               ``mean_provided``, ``mean_provided2``: ValueError
                               in activations, nothing written
artist                         weights (encoder e1, each decoder's last
                               deconv), loss
info_gan                       weights (d1, g1, g8), loss
paper_cgan, paper_sampler,     TypeError in activations (the critic takes an
paper_noise,                   (image, depth) pair), nothing written
paper_baseline_sampler,
sampler_gan, improved_sampler,
experimental_sampler
pix2pix                        ValueError in activations (the PatchGAN takes
                               image and depth channels), nothing written
test                           KeyError('params') in weights (its state holds
                               no network), nothing written
=============================  ==============================================

Noise comes from ``torch.Generator``s seeded 0 (samples, the VAE's eps)
and the filter index (bestfit's start images); every function takes it
through a seam instead (``z``, ``noise``, ``starts``), as the models do.
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from hemx_torch import convert
from hemx_torch.cli import CliError
from hemx_torch.data.pipeline import place_batch
from hemx_torch.models.artist import Artist
from hemx_torch.models.cnn import CnnModel
from hemx_torch.models.conditional import ConditionalGanBase
from hemx_torch.models.fake import FakeTestModel
from hemx_torch.models.gan import GanModel
from hemx_torch.models.mean_depth_estimator import MeanDepthEstimator
from hemx_torch.models.paper_family import PaperStandalone
from hemx_torch.models.pix2pix import Pix2Pix
from hemx_torch.models.vae import VaeModel
from hemx_torch.runs import check_device, restore_run
from hemx_torch.summaries.montage import montage, to_uint8
from hemx_torch.summaries.png import encode_png
from hemx_torch.summaries.reader import get_all_events
from hemx_torch.train.checkpoint import CheckpointManager
from hemx_torch.utils import terminal as term


class Run(NamedTuple):
    args: object
    splits: dict
    model: object
    ts: object
    batch: dict  # the host batch (NHWC numpy)
    mgr: CheckpointManager
    device: torch.device


def load_run(run_dir: str, device="cuda") -> Run:
    """Rebuild the model and restore the latest checkpoint of a run."""
    device = torch.device(device)
    args, splits, model, ts, batch, _ = restore_run(run_dir, device)
    return Run(args, splits, model, ts, batch, CheckpointManager(run_dir),
               device)


def _save(out_dir: str, name: str, image: np.ndarray) -> str:
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, name)
    with open(path, "wb") as f:
        f.write(encode_png(to_uint8(np.clip(image, 0, 1))))
    return path


def _host(t: torch.Tensor) -> np.ndarray:
    """NCHW tensor -> NHWC float32 numpy."""
    return t.detach().float().permute(0, 2, 3, 1).cpu().numpy()


def placed_batch(run: Run) -> dict:
    """The run's host batch on the device, as training places it."""
    return place_batch(run.batch, run.splits["train"], run.device,
                       run.model.batch_keys)


def _normal(shape, device, seed: int = 0) -> torch.Tensor:
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return torch.randn(shape, generator=gen, device=device)


def _model_samples(run: Run, ts, n: int, z=None,
                   placed=None) -> Optional[np.ndarray]:
    """``n`` generated (GAN family) or decoded N(0, 1) (VAE) images, NHWC;
    None for the other models. ``z``: the (n, latent) noise; ``placed``:
    the placed batch (the VAE reconstructs it on the way)."""
    model = run.model
    if z is None and isinstance(model, (GanModel, VaeModel)):
        z = _normal((n, run.args.latent_size), run.device)
    if isinstance(model, GanModel):
        return _host(model.sample(ts, n, z=z))
    if isinstance(model, VaeModel):
        # the reconstructions' eps is drawn by the model; only the samples
        # are kept
        return _host(model.recon_and_samples(ts, placed, n,
                                             noise={"z": z})[1])
    return None


def _recon(run: Run, ts, placed: dict) -> Optional[np.ndarray]:
    if isinstance(run.model, CnnModel):
        return _host(run.model.recon(ts, placed))
    return None


def visualize_samples(run: Run, out_dir: str, z=None) -> None:
    """``samples.png``: ``examples`` samples (``z`` their noise) or the
    CNN's reconstructions of the batch."""
    n = getattr(run.args, "examples", 64)
    placed = None if isinstance(run.model, GanModel) else placed_batch(run)
    samples = _model_samples(run, run.ts, n, z, placed)
    if samples is None and isinstance(run.model, CnnModel):
        samples = _recon(run, run.ts, placed)[:n]
    if samples is not None:
        _save(out_dir, "samples.png", montage(samples))
        term.message(f"wrote {out_dir}/samples.png")


def visualize_timelapse(run: Run, out_dir: str, z=None) -> None:
    """One sample grid per checkpoint: generative models sample (the same
    noise every frame), autoencoders reconstruct a fixed batch; the other
    models write none. The train state ends at the last checkpoint, the
    latest, which :func:`load_run` restored."""
    placed = placed_batch(run)
    if not isinstance(run.model, (GanModel, VaeModel, CnnModel)):
        return
    n = min(16, run.args.examples)
    frames = 0
    for epoch, path in run.mgr.checkpoints():
        convert.load_checkpoint(run.ts, run.mgr.restore(path))
        s = _model_samples(run, run.ts, n, z, placed)
        if s is None:
            s = _recon(run, run.ts, placed)[:16]
        _save(out_dir, f"timelapse-{epoch:04d}.png", montage(s, grid=(4, 4)))
        frames += 1
    if frames:
        term.message(f"wrote {frames} timelapse frames to {out_dir}")


def captured_forward(model, ts, x: torch.Tensor, noise=None) -> dict:
    """{name: output} of the model's main net on the [0, 1] NCHW images
    ``x``, named and ordered as hemx's ``Ctx(capture=True)`` records them:
    the forward of the CNN (which rescales to [-1, 1]) and the VAE (its
    eps: ``noise["eps"]``, else N(0, 1) from seed 0); the bare net of the
    estimator and the standalone generators; the artist's three nets; the
    GAN critic on ``2(x - 0.5)``. The depth nets record nothing. The
    conditional critics cannot take the image alone: they raise hemx's
    exception."""
    capture: dict = {}
    if isinstance(model, CnnModel):
        model._forward(ts.nets, x, capture)
    elif isinstance(model, VaeModel):
        eps = (noise or {}).get("eps")
        if eps is None:
            eps = _normal((x.shape[0], model.args.latent_size), x.device)
        model._forward(ts.nets, x, eps.to(x.device), capture)
    elif isinstance(model, Artist):
        e, _ = ts.nets["encoder"](x)
        ts.nets["x_decoder"](e)
        ts.nets["y_decoder"](e)
    elif isinstance(model, PaperStandalone):
        if model.args.model_version in ("mean_provided", "mean_provided2"):
            # hemx's net takes (x, y_bar), or a fourth channel
            raise ValueError(
                f"{model.name} --model_version {model.args.model_version}: "
                f"its generator does not take the image alone")
        ts.nets(x)
    elif isinstance(model, MeanDepthEstimator):
        ts.nets(x, capture)
    elif isinstance(model, GanModel):
        ts.nets["discriminator"](2.0 * (x - 0.5), capture)
    elif isinstance(model, ConditionalGanBase):
        error = ValueError if isinstance(model, Pix2Pix) else TypeError
        raise error(f"{model.name}: its discriminator takes an (image, "
                    f"depth) pair, not the image alone")
    return capture


def capture_layers(run: Run, x=None, noise=None) -> dict:
    """The 4-D captures of the model's main net on the placed batch
    (``x``), NCHW."""
    if x is None:
        x = placed_batch(run)["image"]
    with torch.no_grad():
        caps = captured_forward(run.model, run.ts, x, noise)
    return {k: v for k, v in caps.items() if v.dim() == 4}


def visualize_activations(run: Run, out_dir: str, noise=None) -> None:
    """Filter-response montages per captured conv layer."""
    layers = capture_layers(run, noise=noise)
    for name, act in layers.items():
        a = act[0].detach().float().cpu().numpy()[:, :, :, None]
        lo, hi = a.min(), a.max()
        a = (a - lo) / max(hi - lo, 1e-12)
        _save(out_dir, f"activations-{name.replace('/', '_')}.png", montage(a))
    if layers:
        term.message(f"wrote {len(layers)} activation montages to {out_dir}")


def visualize_weights(run: Run, out_dir: str) -> None:
    """Filter grids of the kernels with displayable channels, read in
    hemx's layout."""
    if isinstance(run.model, FakeTestModel):
        # hemx's test plugin keeps {"step"} alone as its train state
        raise KeyError("params")
    params = convert.to_jax(run.ts.nets)[0]
    count = 0
    for path, arr in sorted(convert.flatten_tree(params).items()):
        if arr.ndim == 4 and arr.shape[0] >= 3 and arr.shape[2] in (1, 3, 4):
            k = np.transpose(arr[:, :, :3, :], (3, 0, 1, 2))
            lo, hi = k.min(), k.max()
            k = (k - lo) / max(hi - lo, 1e-12)
            _save(out_dir, f"weights-{'_'.join(path)}.png", montage(k))
            count += 1
    term.message(f"wrote {count} weight grids to {out_dir}")


def _gaussian_blur(x: torch.Tensor, sigma: float = 1.0) -> torch.Tensor:
    """Separable 5-tap Gaussian blur of an NCHW batch, per channel, SAME
    (two pixels of zeros on each side)."""
    r = torch.arange(-2, 3, dtype=torch.float32, device=x.device)
    k = torch.exp(-(r ** 2) / (2 * sigma ** 2))
    k = k / k.sum()
    c = x.shape[1]
    x = F.conv2d(x, k.view(1, 1, 5, 1).repeat(c, 1, 1, 1), padding=(2, 0),
                 groups=c)
    return F.conv2d(x, k.view(1, 1, 1, 5).repeat(c, 1, 1, 1), padding=(0, 2),
                    groups=c)


def bestfit_images(run: Run, layer: str, n_filters: int, starts=None,
                   noise=None, steps: int = 20) -> list:
    """The gradient ascent's images (NCHW, one row each, not normalized)
    for filters ``0 .. n_filters-1`` of ``layer`` after ``steps`` steps
    (hemx takes 20). ``starts``: optional (n_filters, C, H, W) start
    images."""
    c, h, w = run.model.input_shape(run.batch)
    if noise is None and isinstance(run.model, VaeModel):
        noise = {"eps": _normal((1, run.args.latent_size), run.device)}
    out = []
    for idx in range(n_filters):
        if starts is not None:
            x = starts[idx:idx + 1].to(run.device, torch.float32)
        else:
            gen = torch.Generator(device=run.device)
            gen.manual_seed(idx)
            x = torch.rand((1, c, h, w), generator=gen,
                           device=run.device) * 0.2 + 0.4
        for i in range(steps):
            x = x.detach().requires_grad_(True)
            act = captured_forward(run.model, run.ts, x, noise)[layer]
            (g,) = torch.autograd.grad(act[:, idx].float().mean(), x)
            with torch.no_grad():
                g = g / (torch.sqrt(torch.mean(g ** 2)) + 1e-8)
                x = x + 0.1 * g
                x = x * (1.0 - 1e-4)
                if i % 4 == 0:
                    x = _gaussian_blur(x)
        out.append(x.detach())
    return out


def visualize_bestfit(run: Run, out_dir: str, layer: str | None = None,
                      n_filters: int = 16, starts=None, noise=None) -> None:
    """Gradient ascent in image space on a layer's filters."""
    layers = capture_layers(run, noise=noise)
    if not layers:
        term.message("no conv layers to fit")
        return
    layer = layer or sorted(layers)[0]
    n_filters = min(n_filters, int(layers[layer].shape[1]))
    images = []
    for x in bestfit_images(run, layer, n_filters, starts, noise):
        img = _host(x)[0]
        lo, hi = img.min(), img.max()
        images.append((img - lo) / max(hi - lo, 1e-12))
    _save(out_dir, f"bestfit-{layer.replace('/', '_')}.png",
          montage(np.stack(images)))
    term.message(f"wrote bestfit montage for layer '{layer}'")


def visualize_loss(run: Run, out_dir: str) -> None:
    """Loss curves from the run's tfevents."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(8, 5))
    found = False
    for phase in ("train", "validate"):
        events = get_all_events(os.path.join(run.args.dir, phase))
        for tag, rows in sorted(events.items()):
            if not tag.startswith("losses/"):
                continue
            ax.plot([r[1] for r in rows], [r[2] for r in rows],
                    label=f"{phase}/{tag.split('/', 1)[1]}")
            found = True
    if not found:
        plt.close(fig)
        term.message("no loss events found")
        return
    ax.set_xlabel("step")
    ax.set_ylabel("loss")
    ax.legend()
    os.makedirs(out_dir, exist_ok=True)
    fig.savefig(os.path.join(out_dir, "loss.pdf"), bbox_inches="tight")
    plt.close(fig)
    term.message(f"wrote {out_dir}/loss.pdf")


def run(argv=None) -> dict:
    """Parse the flags and write what they ask for: {"out_dir", "seconds":
    {tool: wall seconds}}."""
    parser = argparse.ArgumentParser(description="hemx_torch run visualizer")
    parser.add_argument("--dir", required=True)
    parser.add_argument("--sample", action="store_true")
    parser.add_argument("--timelapse", action="store_true")
    parser.add_argument("--activations", action="store_true")
    parser.add_argument("--weights", action="store_true")
    parser.add_argument("--bestfit", action="store_true")
    parser.add_argument("--loss", action="store_true")
    parser.add_argument("--layer", default=None,
                        help="Layer name for --bestfit.")
    parser.add_argument("--all", action="store_true")
    parser.add_argument("--device", default="cuda")
    a = parser.parse_args(argv)

    r = load_run(a.dir, check_device(a.device))
    r.ts.nets.eval()
    out_dir = os.path.join(a.dir, "visualize")
    tools = [("sample", visualize_samples), ("timelapse", visualize_timelapse),
             ("activations", visualize_activations),
             ("weights", visualize_weights),
             ("bestfit", lambda run, out: visualize_bestfit(run, out,
                                                            a.layer)),
             ("loss", visualize_loss)]
    seconds = {}
    for name, tool in tools:
        if getattr(a, name) or a.all:
            t0 = time.perf_counter()
            tool(r, out_dir)
            seconds[name] = time.perf_counter() - t0
    return {"out_dir": out_dir, "seconds": seconds}


def main(argv=None) -> int:
    try:
        run(argv)
    except CliError as e:
        print(f"ERROR: {e}", file=sys.stderr)
        return e.code
    return 0


if __name__ == "__main__":
    sys.exit(main())
