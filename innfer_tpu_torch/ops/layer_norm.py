"""LayerNorm over the channels of bf16 tokens on one hand-written kernel
(``csrc/layer_norm.cu``), and its plain version.

Replaces no TPU kernel: the JAX package has no SwinIR.  ``models/swinir.py``
runs its LayerNorms (two a Swin transformer layer, one after the first
conv, one after the groups) on it wherever :func:`fusable` holds.  For
tokens ``x`` (..., C) it computes, per token, in fp32 from the bf16 values:

    y = bf16((x - mean) * rsqrt(var + eps) * w + b)      biased var, eps 1e-5

with the fp32 weight and bias, rounded once, into rows of ``out_width``
channels (zeros after C): the next GEMM reads 16-byte rows.  Bytes bound it (a token read
once and written once); the kernel holds a row in a warp's registers, so
the variance is a second pass over registers.  PyTorch's CUDA LayerNorm
takes no fp32 affine for a bf16 input, and ran rows of 180 at a sixth of
the byte bound on an H100 (PERF.md).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as TF

from innfer_tpu_torch.nn.functional import true_fp32

EPS = 1e-5
MAX_C = 1024   # a row's 8-byte pieces, 8 a lane


def takes(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> bool:
    """Whether the kernel takes ``x`` on whatever device: bf16 with C, its
    last axis, a multiple of 4 of at most 1024, and fp32 (C,) w and b."""
    c = x.shape[-1] if x.dim() else 0
    return (x.dtype == torch.bfloat16 and x.dim() >= 2 and 0 < c <= MAX_C and c % 4 == 0
            and x.numel() > 0
            and all(t.dtype == torch.float32 and tuple(t.shape) == (c,) for t in (w, b)))


def fusable(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> bool:
    """:func:`takes`, on a CUDA tensor: the gate of ``models/swinir.py``,
    which runs :func:`layer_norm_reference` elsewhere."""
    return x.is_cuda and takes(x, w, b)


def layer_norm_reference(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, *,
                         eps: float = EPS, out_width: Optional[int] = None) -> torch.Tensor:
    """The plain version: ``nn.LayerNorm`` in true fp32 (float64 for a
    float64 ``x``) on x's values with the fp32 affine, rounded once to x's
    dtype, zero-padded to ``out_width`` channels.  Runs on any device."""
    acc = torch.float64 if x.dtype == torch.float64 else torch.float32
    c = x.shape[-1]
    with true_fp32(acc):
        y = TF.layer_norm(x.to(acc), (c,), w.to(acc), b.to(acc), eps)
    return TF.pad(y.to(x.dtype), (0, (out_width or c) - c))


def fused_layer_norm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, *,
                     eps: float = EPS, out_width: Optional[int] = None) -> torch.Tensor:
    """LayerNorm of ``x`` over its last axis, into rows of ``out_width``
    channels (a multiple of 4, at least C; default C) with zeros after C.
    A CUDA tensor launches the kernel (or raises where :func:`takes` does
    not hold); a CPU tensor takes :func:`layer_norm_reference`.
    ``fused_layer_norm.launches`` counts kernel launches."""
    c = x.shape[-1]
    co = out_width or c
    if x.device.type == "cpu":
        return layer_norm_reference(x, w, b, eps=eps, out_width=co)
    if x.device.type != "cuda":
        raise ValueError(f"fused_layer_norm runs on CUDA or CPU tensors, not {x.device}")
    if not takes(x, w, b) or co < c or co % 4:
        raise ValueError(
            f"fused_layer_norm takes bf16 tokens (..., C) with C % 4 == 0 and C <= {MAX_C}, "
            f"and fp32 (C,) w and b, into out_width >= C channels, a multiple of 4; got "
            f"{x.dtype} {tuple(x.shape)}, w {w.dtype} {tuple(w.shape)}, b {b.dtype} "
            f"{tuple(b.shape)}, out_width {co}")
    x, w, b = x.contiguous(), w.contiguous(), b.contiguous()
    if x.data_ptr() % 8 or w.data_ptr() % 16 or b.data_ptr() % 16:
        raise ValueError("the kernel reads x in 8-byte and w, b in 16-byte pieces: align them")
    y = torch.empty((*x.shape[:-1], co), dtype=x.dtype, device=x.device)
    from innfer_tpu_torch.ops import _build

    lib = _build.layer_norm_library()
    _build.launch(lib, "innfer_layer_norm", "fused_layer_norm", x.device, x.data_ptr(),
                  w.data_ptr(), b.data_ptr(), y.data_ptr(), x.numel() // c, c, co, eps)
    fused_layer_norm.launches += 1
    return y


fused_layer_norm.launches = 0
