"""Image-quality metrics: PSNR and SSIM on the tensor's device, and their
host-side numpy spellings.

The port's counterpart of ``innfer_tpu/metrics.py``.  The reference
computes no metrics; these back the CLI's ``--metrics`` option, which
holds a directory of outputs against same-named ground-truth files.

The device ``ssim`` filters with ``ops/filters.filter2d`` in fp32, which
runs true fp32 on the card (no TF32).  ``ssim_np`` is the same math on
numpy with reflect-101 borders: the JAX package's spelling calls
``cv2.filter2D``, and this one needs no OpenCV.
"""
from __future__ import annotations

import numpy as np
import torch

from innfer_tpu_torch.ops.filters import filter2d


def psnr(a: torch.Tensor, b: torch.Tensor, peak: float = 1.0) -> torch.Tensor:
    """Peak signal-to-noise ratio in dB over all elements, in fp32."""
    mse = torch.mean(torch.square(a.float() - b.float()))
    return 10.0 * torch.log10(peak * peak / torch.clamp(mse, min=1e-20))


def _gaussian(size: int, sigma: float) -> np.ndarray:
    """The normalized 1-D gaussian of the SSIM window, float64."""
    x = np.arange(size, dtype=np.float64) - (size - 1) / 2
    g = np.exp(-(x ** 2) / (2 * sigma ** 2))
    return g / g.sum()


def _ssim_map(f, a, b, peak: float):
    """The SSIM map of Wang et al. 2004 with the window filter ``f``."""
    c1 = (0.01 * peak) ** 2
    c2 = (0.03 * peak) ** 2
    mu_a, mu_b = f(a), f(b)
    mu_aa, mu_bb, mu_ab = mu_a * mu_a, mu_b * mu_b, mu_a * mu_b
    var_a = f(a * a) - mu_aa
    var_b = f(b * b) - mu_bb
    cov = f(a * b) - mu_ab
    num = (2 * mu_ab + c1) * (2 * cov + c2)
    den = (mu_aa + mu_bb + c1) * (var_a + var_b + c2)
    return num / den


def ssim(a: torch.Tensor, b: torch.Tensor, peak: float = 1.0, size: int = 11,
         sigma: float = 1.5) -> torch.Tensor:
    """Mean structural similarity on NHWC (or HWC) images, in fp32."""
    if a.dim() == 3:
        a, b = a[None], b[None]
    g = _gaussian(size, sigma)
    k = torch.from_numpy(np.outer(g, g).astype(np.float32))
    return torch.mean(_ssim_map(lambda t: filter2d(t, k), a.float(), b.float(), peak))


def psnr_np(a: np.ndarray, b: np.ndarray, peak: float = 255.0) -> float:
    """Host-side PSNR for uint8 images."""
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return float("inf") if mse == 0 else float(10 * np.log10(peak * peak / mse))


def ssim_np(a: np.ndarray, b: np.ndarray, peak: float = 1.0, size: int = 11,
            sigma: float = 1.5) -> float:
    """Host-side SSIM of HW or HWC images, the same math as :func:`ssim`.

    The window is separable, so each filter is two 1-D passes over an
    image reflect-101-padded by ``size // 2`` (OpenCV's default border,
    and ``filter2d``'s), summed in float64.  It stays on the host: the
    directory loop computes it on the encode pool, and device work queued
    from a pool thread would wait behind later images' forwards."""
    g = _gaussian(size, sigma)
    r = size // 2

    def f(im):
        pad = [(r, r), (r, r)] + [(0, 0)] * (im.ndim - 2)
        p = np.pad(im, pad, mode="reflect")
        h, w = im.shape[:2]
        rows = sum(g[i] * p[i: i + h] for i in range(size))
        return sum(g[j] * rows[:, j: j + w] for j in range(size))

    a64 = np.asarray(a, np.float32).astype(np.float64)
    b64 = np.asarray(b, np.float32).astype(np.float64)
    return float(np.mean(_ssim_map(f, a64, b64, peak)))
