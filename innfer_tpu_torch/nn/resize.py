"""Resize ops, NHWC: the port's copy of ``innfer_tpu/nn/resize.py``.

``interpolate`` has torch.nn.functional.interpolate's semantics, computed
as the JAX package computes it: separable 1-D gathers with index and
weight tables precomputed in numpy (float64, weights cast to fp32), each
axis blended in fp32 in the same tap order, one cast to the input dtype at
the end.  Users in the reference:
  * nearest (integer scale)       -- upconv blocks (block.py:348-361);
  * bilinear, align_corners=True  -- PAN's global input residual
                                     (PAN_arch.py:215-218);
  * bilinear, align_corners=False -- PAN's bilinear PA upsampling, WBC
                                     pt mode (WBCNet_arch.py:65-68);
  * bicubic, align_corners=False  -- FSA's restore (block.py:463-466),
                                     color_fix and linear_resize;
  * ``tf_2x_bilinear``            -- WBC tf mode (WBCNet_arch.py:127-138).
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch


def _source_positions(out_size: int, in_size: int, align_corners: bool,
                      cubic: bool) -> np.ndarray:
    """Fractional source coordinate of each output index (torch's
    area_pixel_compute_source_index: the half-pixel formula clamps at zero
    for linear modes, not for cubic)."""
    dst = np.arange(out_size, dtype=np.float64)
    if align_corners:
        if out_size <= 1:
            return np.zeros(out_size, dtype=np.float64)
        return dst * ((in_size - 1) / (out_size - 1))
    src = (dst + 0.5) * (in_size / out_size) - 0.5
    return src if cubic else np.maximum(src, 0.0)


def _linear_tables(out_size: int, in_size: int, align_corners: bool):
    src = _source_positions(out_size, in_size, align_corners, cubic=False)
    i0 = np.clip(np.floor(src).astype(np.int64), 0, in_size - 1)
    i1 = np.minimum(i0 + 1, in_size - 1)
    w1 = src - i0
    return np.stack([i0, i1], axis=1), np.stack([1.0 - w1, w1], axis=1)


def _cubic_kernel(t: np.ndarray, a: float = -0.75) -> np.ndarray:
    """Keys' cubic convolution kernel with torch's A = -0.75."""
    at = np.abs(t)
    at2, at3 = at * at, at * at * at
    return np.where(
        at <= 1.0, (a + 2.0) * at3 - (a + 3.0) * at2 + 1.0,
        np.where(at < 2.0, a * at3 - 5.0 * a * at2 + 8.0 * a * at - 4.0 * a, 0.0))


def _cubic_tables(out_size: int, in_size: int, align_corners: bool):
    src = _source_positions(out_size, in_size, align_corners, cubic=True)
    i0 = np.floor(src).astype(np.int64)
    frac = src - i0
    taps = np.stack([i0 - 1, i0, i0 + 1, i0 + 2], axis=1)
    wts = _cubic_kernel(np.array([-1.0, 0.0, 1.0, 2.0])[None, :] - frac[:, None])
    return np.clip(taps, 0, in_size - 1), wts


def nearest_table(out_size: int, in_size: int, ratio: Optional[float] = None) -> np.ndarray:
    """torch 'nearest': src = floor(dst * ratio), clamped; ``ratio`` is
    in / out unless given (``cv2.resize`` with ``fx`` takes 1 / fx)."""
    dst = np.arange(out_size, dtype=np.float64)
    ratio = in_size / out_size if ratio is None else ratio
    return np.minimum(np.floor(dst * ratio).astype(np.int64), in_size - 1)


def _apply_1d(x: torch.Tensor, idx: np.ndarray, wts: Optional[np.ndarray],
              dim: int) -> torch.Tensor:
    """Gather along ``dim`` with static tables; with weights, blend the
    taps in fp32 in tap order."""
    if wts is None:
        return x.index_select(dim, torch.from_numpy(idx).to(x.device))
    shape = [1] * x.dim()
    shape[dim] = -1
    acc = None
    for t in range(idx.shape[1]):
        g = x.index_select(dim, torch.from_numpy(np.ascontiguousarray(idx[:, t])).to(x.device))
        w = torch.from_numpy(wts[:, t].astype(np.float32)).to(x.device).reshape(shape)
        g = g.float() * w
        acc = g if acc is None else acc + g
    return acc


def interpolate(x: torch.Tensor, size: Optional[Tuple[int, int]] = None,
                scale_factor: Optional[float] = None, mode: str = "nearest",
                align_corners: Optional[bool] = None) -> torch.Tensor:
    """torch.nn.functional.interpolate for (B, H, W, C) tensors; sizes from
    ``scale_factor`` are floor(in * scale), as torch computes them."""
    _b, h, w, _c = x.shape
    if size is None:
        if scale_factor is None:
            raise ValueError("either size or scale_factor is required")
        sf = (scale_factor if isinstance(scale_factor, (tuple, list))
              else (scale_factor, scale_factor))
        size = (int(np.floor(h * sf[0])), int(np.floor(w * sf[1])))
    oh, ow = size
    if mode == "nearest":
        if oh % h == 0 and ow % w == 0:
            return x.repeat_interleave(oh // h, dim=1).repeat_interleave(ow // w, dim=2)
        out = _apply_1d(x, nearest_table(oh, h), None, dim=1)
        return _apply_1d(out, nearest_table(ow, w), None, dim=2)
    ac = bool(align_corners)
    if mode == "bilinear":
        (ih, wh), (iw, ww) = _linear_tables(oh, h, ac), _linear_tables(ow, w, ac)
    elif mode == "bicubic":
        (ih, wh), (iw, ww) = _cubic_tables(oh, h, ac), _cubic_tables(ow, w, ac)
    else:
        raise NotImplementedError(f"interpolate mode [{mode}]")
    out = _apply_1d(_apply_1d(x, ih, wh, dim=1), iw, ww, dim=2)
    return out.to(x.dtype)


def upsample_nearest(x: torch.Tensor, r: int) -> torch.Tensor:
    """Integer nearest upsample of (B, H, W, C), == interpolate('nearest')."""
    return x.repeat_interleave(r, dim=1).repeat_interleave(r, dim=2)


def tf_2x_bilinear(x: torch.Tensor) -> torch.Tensor:
    """TF-style 2x bilinear upsample of WBC tf-mode checkpoints (reference
    WBCNet_arch.py:127-138): even taps copy the source, odd taps average
    with the replicate-padded next pixel.  The add and the multiply by 0.5
    happen in the activation dtype, as the JAX package computes them."""
    b, h, w, c = x.shape
    pad = torch.cat([x, x[:, -1:]], dim=1)
    pad = torch.cat([pad, pad[:, :, -1:]], dim=2)
    p00 = pad[:, :-1, :-1]
    half = torch.tensor(0.5, dtype=x.dtype)
    e10 = (p00 + pad[:, 1:, :-1]) * half   # next row
    e01 = (p00 + pad[:, :-1, 1:]) * half   # next column
    e11 = (p00 + pad[:, 1:, 1:]) * half    # next row and column
    top = torch.stack([p00, e01], dim=3).reshape(b, h, 2 * w, c)
    bot = torch.stack([e10, e11], dim=3).reshape(b, h, 2 * w, c)
    return torch.stack([top, bot], dim=2).reshape(b, 2 * h, 2 * w, c)
