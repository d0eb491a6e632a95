"""Shared training-state machinery (counterpart of ``hemx.models.common``).

The train state holds what ``hemx``'s dict pytree holds — the parameters
and BN buffers of ``nets``, ``opt``, ``step`` and ``rng`` — as live PyTorch
objects that the train call updates in place; ``hemx_torch.convert`` turns
it into ``hemx``'s checkpoint tree and back. ``step`` increments once per
train call (critic substeps keep it fixed), as in ``hemx``.

Random numbers. ``rng`` is hemx's uint32[2] key: the port writes
``[seed >> 32, seed & 0xffffffff]``, which equals
``jax.random.PRNGKey(seed)``, and keeps it; a key read from a hemx
checkpoint (which hemx advances every substep) is kept as read. Each train
call, eval call and summary sample draws its noise from a fresh
``torch.Generator`` seeded from ``(key words, step, stream)``, so the noise
is a function of the checkpointed state and a resumed run draws what an
uninterrupted one would. The stream is the port's own, not JAX's threefry
(which PyTorch cannot reproduce); equality tests draw noise with
``jax.random`` and pass it through the noise seam (``train(ts, stream,
noise)``, ``eval_losses(ts, batch, noise)``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn as nn

from hemx_torch.convert import jax_view
from hemx_torch.parallel import dp, sp, tp

# noise streams drawn at one (key, step)
TRAIN, EVAL, SAMPLE, REPORT, DIAG = range(5)


@dataclasses.dataclass
class TrainState:
    nets: nn.Module
    opt: object  # one Optimizer over ``nets``, or {name: Optimizer}
    step: int
    rng: np.ndarray  # uint32[2], jax.random.PRNGKey's layout


def prng_key(seed: int) -> np.ndarray:
    """``jax.random.PRNGKey(seed)`` for a seed in [0, 2**64)."""
    return np.array([(seed >> 32) & 0xFFFFFFFF, seed & 0xFFFFFFFF], np.uint32)


def new_train_state(nets: nn.Module, opt, seed: int) -> TrainState:
    return TrainState(nets=nets, opt=opt, step=0, rng=prng_key(seed))


def generator(ts: TrainState, stream: int, device) -> torch.Generator:
    """A generator on ``device`` seeded from the state's key, its step and
    ``stream``."""
    words = [int(w) for w in ts.rng] + [ts.step, stream]
    seed = int(np.random.SeedSequence(words).generate_state(1, np.uint64)[0])
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    return g


def draw_noise(gen: torch.Generator, batch: int, latent: int, *,
               alpha: bool = False, key: str = "z") -> dict:
    """One substep's noise: ``key`` (B, latent) standard normal (GAN ``z``,
    VAE ``eps``), plus the GP's ``alpha`` (B, 1) uniform for an IWGAN
    critic substep (``hemx/models/gan.py:229-231,254,289-291``). In a
    process group each draw is made for the global batch and this rank
    keeps its rows, so every rank's generator stays in step (the ranks of
    one data index, its slices or bands, draw the same rows)."""
    dev = gen.device
    rows = batch * dp.data_axis_size()
    out = {key: torch.randn((rows, latent), generator=gen, device=dev)}
    if alpha:
        out["alpha"] = torch.rand((rows, 1), generator=gen, device=dev)
    return {k: dp.slice_rows(v) for k, v in out.items()}


def seam(noise: dict, device) -> dict:
    """Noise handed in through the seam, drawn for the global batch (the
    whole of it without a process group), as this rank's rows on
    ``device``."""
    return {k: dp.slice_rows(v.to(device)) for k, v in noise.items()}


def _path(prefix: str, name: str) -> str:
    """hemx's tree path of parameter ``name`` under ``prefix`` ('' for a
    model whose parameter tree is the network's own)."""
    path = name.replace(".", "/")
    return f"{prefix}/{path}" if prefix else path


def grad_finite_report(prefix: str, net: nn.Module, grads) -> dict:
    """Per-parameter finite-ness flags (0-d bool tensors on the device),
    named by hemx's tree path, e.g. ``d/c1/w``, or ``encoder/c1/w`` with no
    prefix (``--check_numerics``)."""
    return {_path(prefix, n): torch.isfinite(g).all()
            for (n, _), g in zip(net.named_parameters(), grads)}


def and_flags(flags: dict, new: dict) -> dict:
    """AND finite-ness flags of several substeps, key by key."""
    return {**flags, **{k: flags[k] & v if k in flags else v
                        for k, v in new.items()}}


def raise_on_bad_grads(metrics: dict) -> None:
    """Raise FloatingPointError naming every parameter whose gradient had a
    NaN or Inf (the host side of ``--check_numerics``)."""
    bad = [n for n, ok in metrics.get("grad_finite", {}).items() if not ok]
    if bad:
        raise FloatingPointError(
            "GRADIENT ERROR (NaN/Inf) on parameter(s): " + ", ".join(sorted(bad)))


def grad_norm(grads, net: nn.Module | None = None) -> torch.Tensor:
    """Global L2 norm of a sequence of gradients (``optax.global_norm``);
    given ``net`` (the gradients in its ``parameters()`` order), the norm
    of the whole kernels under the model axis."""
    if net is None:
        return torch.sqrt(sum(torch.sum(g.float() ** 2) for g in grads))
    return torch.sqrt(tp.sum_squares(grads, list(net.parameters())))


def host_scalars(metrics: dict) -> dict:
    """Metrics to host floats, and ``grad_finite`` flags to bools, in one
    device-to-host copy."""
    flags = metrics.get("grad_finite", {})
    keys = [k for k in metrics if k != "grad_finite"]
    vals = [metrics[k].float().reshape(()) for k in keys]
    vals += [f.float().reshape(()) for f in flags.values()]
    host = torch.stack(vals).cpu().tolist() if vals else []
    out = dict(zip(keys, host))
    if flags:
        out["grad_finite"] = {n: v == 1.0
                              for n, v in zip(flags, host[len(keys):])}
    return out


def summarizable_stats(tree: dict, max_sample: int = 65536) -> dict:
    """Per-tensor summary stats for ``--summarize_activations`` and
    ``--summarize_gradients``: mean, zero fraction and the first
    ``max_sample`` values, reduced on the device. Tensors come in hemx's
    layout (NHWC activations, hemx-layout gradients) so the sample is the
    same slice hemx takes."""
    out = {}
    for name, t in tree.items():
        v = t.detach().reshape(-1).float()
        out[name] = {"mean": v.mean(), "zero_fraction": (v == 0).float().mean(),
                     "sample": v[:max_sample]}
    return out


def write_stat_summaries(writer, step: int, stats: dict, prefix: str) -> None:
    """Write :func:`summarizable_stats` under hemx's tag names."""
    for name, s in stats.items():
        writer.scalar(f"{prefix}/{name}/mean", float(s["mean"]), step)
        writer.scalar(f"{prefix}/{name}/zero_fraction",
                      float(s["zero_fraction"]), step)
        writer.histogram(f"{prefix}/{name}", s["sample"].cpu().numpy(), step)


def grads_by_path(prefix: str, net: nn.Module, grads) -> dict:
    """``{prefix/layer/leaf: gradient in hemx layout}`` (no prefix: the
    path within ``net``)."""
    return {_path(prefix, n): jax_view(net, n, g)
            for (n, _), g in zip(net.named_parameters(), grads)}


def nhwc(t: torch.Tensor) -> torch.Tensor:
    """An activation in hemx's layout (NCHW -> NHWC; 2-D unchanged)."""
    return t.permute(0, 2, 3, 1) if t.dim() == 4 else t


class Unflatten(nn.Module):
    """(B, h*w*c) -> (B, c, h, w), reading the flat vector in NHWC order
    like ``hemx.models.common.unflatten``; the result is channels_last in
    memory. In a spatial scope (``sp.bands``) it is cut to this rank's
    band, and the network runs on bands from here."""

    def __init__(self, h: int, w: int, c: int):
        super().__init__()
        self.hwc = (h, w, c)

    def forward(self, x):
        y = x.reshape((x.shape[0],) + self.hwc).permute(0, 3, 1, 2)
        return sp.enter(y), {}
