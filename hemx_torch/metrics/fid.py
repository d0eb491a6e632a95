"""Fréchet distance between feature sets (counterpart of
``hemx.metrics.fid``).

* :func:`gaussian_stats`, :func:`frechet_distance` (the matrix square
  root by an eigendecomposition of the symmetrized product),
  :func:`fid_from_features` and :func:`fid_from_images`: float64 numpy on
  the host, as in hemx;
* :func:`pixel_features`: block means of the images, on the images'
  device (the card in a card run);
* :func:`encoder_features`: the bottleneck of a trained autoencoder
  (``latent``), its forward run on the model's device.

hemx bundles no Inception weights and neither does the port, so the
extractor is pluggable and numbers are comparable only between runs
scored with the same extractor. Images are NCHW tensors in [0, 1] (the
layout the port's nets take), or NHWC numpy arrays (hemx's layout), which
are moved to a tensor first. Features come back as (N, D) float32 numpy
arrays in hemx's NHWC flatten order.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch


def gaussian_stats(features) -> tuple[np.ndarray, np.ndarray]:
    """(mean, covariance) of (N, D) features."""
    f = np.asarray(features, np.float64)
    mu = f.mean(axis=0)
    sigma = np.cov(f, rowvar=False)
    return mu, np.atleast_2d(sigma)


def _sqrtm_psd(mat: np.ndarray) -> np.ndarray:
    """Matrix square root of a (near-)PSD symmetric matrix."""
    vals, vecs = np.linalg.eigh((mat + mat.T) / 2.0)
    vals = np.clip(vals, 0.0, None)
    return (vecs * np.sqrt(vals)) @ vecs.T


def frechet_distance(mu1, sigma1, mu2, sigma2) -> float:
    """FID between N(mu1, sigma1) and N(mu2, sigma2):
    |mu1-mu2|^2 + tr(s1 + s2 - 2 (s1 s2)^(1/2))."""
    mu1, mu2 = np.asarray(mu1, np.float64), np.asarray(mu2, np.float64)
    s1 = np.atleast_2d(np.asarray(sigma1, np.float64))
    s2 = np.atleast_2d(np.asarray(sigma2, np.float64))
    diff = mu1 - mu2
    # sqrt(s1 s2) computed stably as sqrt(sqrt(s1) s2 sqrt(s1))
    rs1 = _sqrtm_psd(s1)
    covmean = _sqrtm_psd(rs1 @ s2 @ rs1)
    return float(diff @ diff + np.trace(s1) + np.trace(s2)
                 - 2.0 * np.trace(covmean))


def fid_from_features(real_features, fake_features) -> float:
    mu1, s1 = gaussian_stats(real_features)
    mu2, s2 = gaussian_stats(fake_features)
    return frechet_distance(mu1, s1, mu2, s2)


def as_nchw(images, device=None) -> torch.Tensor:
    """A float image batch as an NCHW tensor: a tensor as it is, a numpy
    array read as NHWC."""
    if not isinstance(images, torch.Tensor):
        images = torch.from_numpy(np.ascontiguousarray(images)).permute(
            0, 3, 1, 2)
    return images.to(device) if device is not None else images


def _nhwc_rows(t: torch.Tensor) -> np.ndarray:
    """(N, D) float32 numpy, a 4-D tensor flattened in NHWC order."""
    if t.dim() == 4:
        t = t.permute(0, 2, 3, 1)
    return t.detach().float().reshape(t.shape[0], -1).cpu().numpy()


def pixel_features(images, size: int = 8) -> np.ndarray:
    """Cheap extractor: the means of a ``size`` x ``size`` grid of blocks
    (the image cropped to a multiple of ``size``). Only meaningful for
    RELATIVE comparisons between models on the same data."""
    x = as_nchw(images).float()
    n, c, h, w = x.shape
    fh, fw = h // size, w // size
    x = x[:, :, :fh * size, :fw * size]
    x = x.reshape(n, c, size, fh, size, fw).mean(dim=(3, 5))
    return _nhwc_rows(x)


def encoder_features(model, ts) -> Callable:
    """Feature extractor from a trained model's encoder: its forward on the
    model's device, without gradients, with the captures of
    ``hemx_torch.visualize.captured_forward`` (the CNN rescales [0, 1] to
    the [-1, 1] its encoder was trained on). The features are the
    ``latent`` capture, else the first captured name (in capture order)
    that contains ``latent``; a model with neither (the VAE) raises
    ValueError naming what it captured."""
    from hemx_torch.visualize import captured_forward

    def extract(images):
        with torch.no_grad():
            captures = captured_forward(model, ts,
                                        as_nchw(images, model.device).float())
        feats = captures.get("latent")
        if feats is None:
            named = [k for k in captures if "latent" in k]
            if not named:
                raise ValueError(
                    "encoder_features: no 'latent' intermediate captured; "
                    f"available: {sorted(captures)}")
            feats = captures[named[0]]
        return _nhwc_rows(feats)

    return extract


def fid_from_images(real_images, fake_images,
                    extractor: Callable = pixel_features) -> float:
    return fid_from_features(extractor(real_images), extractor(fake_images))
