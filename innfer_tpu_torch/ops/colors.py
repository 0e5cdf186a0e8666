"""Color-order and range transforms on NHWC (or HWC) tensors: the port's
counterpart of ``innfer_tpu/ops/colors.py`` (reference utils/colors.py,
utils/utils.py:136-161)."""
from __future__ import annotations

import torch


def bgr_to_rgb(x: torch.Tensor) -> torch.Tensor:
    """Flip the channel axis (works for RGB and stacked 3xRGB video)."""
    return torch.flip(x, dims=(-1,))


rgb_to_bgr = bgr_to_rgb


def bgra_to_rgba(x: torch.Tensor) -> torch.Tensor:
    return x[..., [2, 1, 0, 3]]


rgba_to_bgra = bgra_to_rgba


def norm(x: torch.Tensor) -> torch.Tensor:
    """[0,1] -> [-1,1] with clamp (reference utils.py:152-161)."""
    return torch.clamp((x - 0.5) * 2.0, -1.0, 1.0)


def denorm(x: torch.Tensor) -> torch.Tensor:
    """[-1,1] -> [0,1] with clamp (reference utils.py:136-150)."""
    return torch.clamp((x + 1.0) / 2.0, 0.0, 1.0)


def srgb_to_linear(srgb: torch.Tensor, gamma: float = 2.4, th: float = 0.04045) -> torch.Tensor:
    """sRGB [0, 255] (any dtype) -> linear [0, 1] fp32 (reference
    colors.py:29-46)."""
    a, att = 0.055, 12.92
    x = srgb.float() / 255.0
    return torch.where(x <= th, x / att, torch.pow((x + a) / (1 + a), gamma))


def linear_to_srgb(linear: torch.Tensor, gamma: float = 2.4,
                   th: float = 0.0031308) -> torch.Tensor:
    """linear [0, 1] -> sRGB uint8 [0, 255] (reference colors.py:49-60).
    The cast to uint8 truncates, as the JAX package's ``astype`` does."""
    a, att = 0.055, 12.92
    x = torch.clamp(linear, 0.0, 1.0)
    srgb = torch.where(x <= th, x * att, (1 + a) * torch.pow(x, 1.0 / gamma) - a)
    return torch.clamp(srgb * 255.0, 0.0, 255.0).to(torch.uint8)
