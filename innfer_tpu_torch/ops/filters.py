"""Device-side image filters: filter2D, the guided filter, a 3x3 gaussian
blur and color_fix, on NHWC tensors.

The port's counterpart of ``innfer_tpu/ops/filters.py`` (reference
utils/utils.py:448-626 for filter2D and the guided filter, utils.py:278-315
for color_fix).  Everything runs on the tensor's device; no kernel of the
port lies here.  The filters compute in fp32 through ``nn/functional``,
so on the card they run true fp32, never TF32: the guided filter's
``mean(xy) - mean(x) mean(y)`` cancels, and TF32's ten-bit mantissa would
show in it.
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch

from innfer_tpu_torch.nn import functional as F
from innfer_tpu_torch.nn import resize as R
from innfer_tpu_torch.ops import colors


def box_kernel(k: int) -> torch.Tensor:
    """Mean-filter kernel (reference utils.py:538-546)."""
    return torch.full((k, k), 1.0 / (k * k), dtype=torch.float32)


def _filter_pads(kh: int, kw: int) -> Tuple[Tuple[int, int], Tuple[int, int]]:
    """(top, bottom), (left, right) pads of the reference compute_padding
    (utils.py:457-481): symmetric for odd kernels, asymmetric for even."""
    top = kh // 2 - (1 if kh % 2 == 0 else 0)
    left = kw // 2 - (1 if kw % 2 == 0 else 0)
    return (top, kh // 2), (left, kw // 2)


def filter2d(x: torch.Tensor, kernel: torch.Tensor, border: str = "reflect",
             normalized: bool = False) -> torch.Tensor:
    """Depthwise 2D filtering with a same-size output (utils.py:484-535):
    the kernel in ``x``'s dtype, an fp32 accumulator, one rounding to
    ``x``'s dtype."""
    kh, kw = kernel.shape
    if normalized:
        kernel = kernel / kernel.abs().sum()
    (pt, pb), (pl, pr) = _filter_pads(kh, kw)
    mode = {"reflect": "reflect", "replicate": "replicate", "constant": "zero"}[border]
    xp = F.pad2d(x, (pl, pr, pt, pb), mode=mode)
    c = x.shape[-1]
    w = kernel.to(x.device).reshape(1, 1, kh, kw).repeat(c, 1, 1, 1)
    return F.conv2d(xp, w, None, groups=c)


def guided_filter(
    x: torch.Tensor,
    y: torch.Tensor,
    x_hr: Optional[torch.Tensor] = None,
    *,
    ks: Optional[int] = None,
    r: Optional[int] = None,
    eps: float = 1e-2,
    mode: str = "regular",
    conv_a: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
) -> torch.Tensor:
    """Edge-preserving guided filter (He et al.), as the reference
    computes it (utils.py:549-626).

    ``x`` is the NHWC guidance, ``y`` the NHWC input to filter.  'regular'
    filters at ``x``'s resolution; 'fast' upsamples the linear
    coefficients to ``x_hr`` (bilinear, align_corners=True) for joint
    upsampling; 'conv' computes A with a learned ``conv_a(cat(cov_xy,
    var_x))`` (utils.py:604-605) and joint-upsamples like 'fast'.  x and y
    are cast to fp32, and the result is rounded once to ``y``'s dtype.
    """
    if ks is None:
        if r is None:
            raise ValueError("either kernel size (ks) or radius (r) is required")
        ks = 2 * r + 1
    k = box_kernel(ks)

    x32, y32 = x.float(), y.float()
    # the border mean divides by the filtered ones, not by 1
    n = filter2d(torch.ones((1, x.shape[1], x.shape[2], 1), device=x.device), k)
    mean_x = filter2d(x32, k) / n
    mean_y = filter2d(y32, k) / n
    cov_xy = filter2d(x32 * y32, k) / n - mean_x * mean_y
    var_x = filter2d(x32 * x32, k) / n - mean_x * mean_x

    if mode == "conv":
        if conv_a is None:
            raise ValueError("conv mode requires the conv_a callable")
        a = conv_a(torch.cat([cov_xy, var_x], dim=-1)).float()
    else:
        a = cov_xy / (var_x + eps)
    b = mean_y - a * mean_x

    if mode in ("fast", "conv"):
        if x_hr is None:
            raise ValueError(f"{mode} mode requires x_hr")
        size = (x_hr.shape[1], x_hr.shape[2])
        mean_a = R.interpolate(a, size=size, mode="bilinear", align_corners=True)
        mean_b = R.interpolate(b, size=size, mode="bilinear", align_corners=True)
        out = mean_a * x_hr.float() + mean_b
    elif mode == "regular":
        mean_a = filter2d(a, k) / n
        mean_b = filter2d(b, k) / n
        out = mean_a * x32 + mean_b
    else:
        raise NotImplementedError(f"guided_filter mode [{mode}]")
    return out.to(y.dtype)


# cv2.getGaussianKernel(3, 0) == [0.25, 0.5, 0.25]
_GAUSS3 = np.outer([0.25, 0.5, 0.25], [0.25, 0.5, 0.25]).astype(np.float32)


def gaussian_blur3(x: torch.Tensor) -> torch.Tensor:
    """3x3 gaussian blur with cv2's sigma=0 semantics (reflect-101 border)."""
    return filter2d(x, torch.from_numpy(_GAUSS3), border="reflect")


def color_fix(img_ref: torch.Tensor, img_out: torch.Tensor) -> torch.Tensor:
    """Transfer the low-frequency color of ``img_ref`` to ``img_out``
    (reference utils.py:278-315, which runs on the host): both to linear
    light, the output bicubic-downscaled to the reference's size where it
    is larger, the difference blurred (3x3 gaussian) and upscaled back,
    added, and returned to sRGB uint8.  HWC or NHWC, uint8 or float
    [0, 255]; the result keeps the rank."""
    squeeze = img_ref.dim() == 3
    if squeeze:
        img_ref, img_out = img_ref[None], img_out[None]
    lin_a = colors.srgb_to_linear(img_ref)
    lin_b = colors.srgb_to_linear(img_out)
    ha, wa = lin_a.shape[1], lin_a.shape[2]
    hb, wb = lin_b.shape[1], lin_b.shape[2]
    if ha < hb and wa < wb:
        ds = R.interpolate(lin_b, size=(ha, wa), mode="bicubic", align_corners=False)
        diff = gaussian_blur3(lin_a - ds)
        diff = R.interpolate(diff, size=(hb, wb), mode="bicubic", align_corners=False)
    else:
        diff = gaussian_blur3(lin_a - lin_b)
    out = colors.linear_to_srgb(diff + lin_b)
    return out[0] if squeeze else out
