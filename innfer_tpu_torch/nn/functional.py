"""Functional NN ops with PyTorch inference semantics, in the JAX package's
NHWC layout.

The port's counterpart of ``innfer_tpu/nn/functional.py`` for the ops the
ESRGAN and CycleGAN paths need.  Activations are NHWC tensors, as the JAX package's
public functions take them; conv weights stay OIHW, as in the checkpoint.
A contiguous NHWC tensor viewed with ``permute(0, 3, 1, 2)`` is a
channels-last NCHW tensor, so cuDNN runs on it without a copy.

fp32 is the parity path and runs true fp32: cuDNN convolutions and cuBLAS
matmuls would otherwise take TF32 on the card (``allow_tf32``), keeping
about three decimal digits -- the same class of error as the round-5 TPU
precision bug (``innfer_tpu/nn/functional.py::_mm_precision``).
"""
from __future__ import annotations

import contextlib
from typing import Optional

import torch
import torch.nn.functional as TF


@contextlib.contextmanager
def true_fp32(dtype: torch.dtype):
    """Disable TF32 for cuDNN and matmul while an fp32/fp64 op runs; other
    dtypes are unaffected.  The previous flags are restored on exit."""
    if dtype not in (torch.float32, torch.float64):
        yield
        return
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    prev = (cudnn.allow_tf32, matmul.allow_tf32)
    cudnn.allow_tf32 = matmul.allow_tf32 = False
    try:
        yield
    finally:
        cudnn.allow_tf32, matmul.allow_tf32 = prev


def nhwc_to_nchw(x: torch.Tensor) -> torch.Tensor:
    """NHWC -> NCHW view (channels-last memory when ``x`` is contiguous)."""
    return x.permute(0, 3, 1, 2)


def nchw_to_nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def conv2d(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None,
           *, stride: int = 1, padding: int = 0) -> torch.Tensor:
    """2D convolution, NHWC x OIHW -> NHWC.  Matches torch.nn.Conv2d.

    Weights and bias are cast to the activation dtype (bf16 activations run
    over fp32-stored biases); cuDNN accumulates in fp32 and adds the bias
    in its epilogue before the single rounding to the activation dtype.
    """
    bias = None if b is None else b.to(x.dtype)
    with true_fp32(x.dtype):
        out = TF.conv2d(nhwc_to_nchw(x), w.to(x.dtype), bias, stride=stride,
                        padding=padding)
    return nchw_to_nhwc(out)


def conv_transpose2d(x: torch.Tensor, w: torch.Tensor,
                     b: Optional[torch.Tensor] = None, *, stride: int = 2,
                     padding: int = 1, output_padding: int = 0) -> torch.Tensor:
    """Transposed convolution, NHWC -> NHWC, matching torch.nn.ConvTranspose2d.
    ``w`` keeps the checkpoint's (I, O, kh, kw) layout, so no flip is needed:
    out = (in - 1) * stride - 2 * padding + kh + output_padding."""
    bias = None if b is None else b.to(x.dtype)
    with true_fp32(x.dtype):
        out = TF.conv_transpose2d(nhwc_to_nchw(x), w.to(x.dtype), bias, stride=stride,
                                  padding=padding, output_padding=output_padding)
    return nchw_to_nhwc(out)


def pad2d(x: torch.Tensor, pad: int, mode: str = "zero") -> torch.Tensor:
    """Spatial padding of an NHWC tensor on all four sides: 'zero' |
    'reflect' | 'replicate' (nn.ZeroPad2d / ReflectionPad2d /
    ReplicationPad2d)."""
    if mode not in ("zero", "reflect", "replicate"):
        raise NotImplementedError(f"padding mode [{mode}] is not implemented")
    out = TF.pad(nhwc_to_nchw(x), (pad,) * 4,
                 mode="constant" if mode == "zero" else mode)
    return nchw_to_nhwc(out).contiguous()


def relu(x: torch.Tensor) -> torch.Tensor:
    return torch.relu(x)


def tanh(x: torch.Tensor) -> torch.Tensor:
    return torch.tanh(x)


def _spatial_stats(x32: torch.Tensor):
    """Per (image, channel) mean and biased variance over H x W, two-pass
    in fp32: the mean first, then the mean of the centred squares."""
    mean = x32.mean(dim=(1, 2), keepdim=True)
    var = (x32 - mean).square().mean(dim=(1, 2), keepdim=True)
    return mean, var


def instance_norm(x: torch.Tensor, *, eps: float = 1e-5) -> torch.Tensor:
    """InstanceNorm2d(affine=False, track_running_stats=False): per-image
    statistics in fp32, cast back to the activation dtype."""
    x32 = x.float()
    mean, var = _spatial_stats(x32)
    return ((x32 - mean) * torch.rsqrt(var + eps)).to(x.dtype)


def batch_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               running_mean: Optional[torch.Tensor],
               running_var: Optional[torch.Tensor], *, training: bool = False,
               eps: float = 1e-5) -> torch.Tensor:
    """BatchNorm2d.  ``training=True`` (or no running stats) normalizes with
    PER-IMAGE statistics over H x W, not torch's statistics pooled over the
    batch: the reference forwards one image at a time, where the two agree,
    and a batched forward must not mix unrelated images.  Otherwise the
    stored running statistics."""
    x32 = x.float()
    if training or running_mean is None:
        mean, var = _spatial_stats(x32)
    else:
        mean, var = running_mean.float(), running_var.float()
    scale = weight.float() * torch.rsqrt(var + eps)
    shift = bias.float() - mean * scale
    return (x32 * scale + shift).to(x.dtype)


def leaky_relu(x: torch.Tensor, neg_slope: float = 0.2) -> torch.Tensor:
    """The slope multiplies in the activation dtype, as the JAX package's
    ``x * jnp.asarray(neg_slope, x.dtype)``: in bf16 that is bf16(0.2), not
    the fp32 0.2f a Python scalar would bring."""
    return torch.where(x >= 0, x, x * torch.tensor(neg_slope, dtype=x.dtype))


def act(kind: Optional[str], x: torch.Tensor) -> torch.Tensor:
    """Activation dispatcher (reference block.py:81-101), parameter-free
    kinds only; prelu/swish come with the RRDB variants of a later slice."""
    if kind is None:
        return x
    kind = kind.lower()
    if kind == "relu":
        return torch.relu(x)
    if kind in ("leakyrelu", "lrelu"):
        return leaky_relu(x)
    if kind == "tanh":
        return torch.tanh(x)
    if kind == "sigmoid":
        return torch.sigmoid(x)
    if kind in ("prelu", "swish"):
        raise NotImplementedError(
            f"{kind} activation is not ported to innfer_tpu_torch yet "
            "(ROADMAP.md queue A5, RRDB variants)")
    raise NotImplementedError(f"activation layer [{kind}] is not found")


def pixel_shuffle(x: torch.Tensor, r: int) -> torch.Tensor:
    """PixelShuffle with torch channel ordering, in NHWC:
    out[b, h*r+i, w*r+j, c] = in[b, h, w, c*r*r + i*r + j]."""
    b, h, w, crr = x.shape
    c = crr // (r * r)
    x = x.reshape(b, h, w, c, r, r).permute(0, 1, 4, 2, 5, 3)
    return x.reshape(b, h * r, w * r, c)
