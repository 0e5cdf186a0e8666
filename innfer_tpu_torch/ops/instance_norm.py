"""Instance norm + ReLU on a conv's fp32 accumulator: one hand-written CUDA
kernel (``csrc/instance_norm.cu``) and its plain version.

Replaces no TPU kernel: the JAX package leaves instance norm to XLA
(``innfer_tpu/nn/functional.py::instance_norm``).  ``models/resnet.py``
runs the norm + ReLU after each of the CycleGAN generator's five plain
convs on it wherever :func:`fusable` holds.  For an NHWC fp32 accumulator
``acc`` that already holds the conv's fp32 bias it computes what the
model's plain composition does:

    x   = bf16(acc)                             one rounding, to nearest even
    out = ReLU(bf16((x - mean) * rsqrt(var + eps)))

with the mean and the biased variance of x per (image, channel) over H x
W, in fp32, eps 1e-5.  Bytes bound it (a few operations an element): the
kernel reads ``acc`` twice (statistics, then the normalization) and writes
bf16 once, where the plain composition makes a dozen passes; the
statistics are per-chunk Welford sums merged with Chan's formula in a
fixed order, never a sum of squares, since a conv's bias can make the
mean large against the spread.
"""
from __future__ import annotations

from typing import Optional

import torch

from innfer_tpu_torch.nn import functional as F

EPS = 1e-5
VEC = 8       # channels a kernel thread reads: two 16-byte loads
MAX_C = 1024  # the kernel's merge holds a block's channels in shared memory


def takes(acc: torch.Tensor, *, dtype: torch.dtype) -> bool:
    """Whether the kernel takes ``acc`` (NHWC) on whatever device: a 4-D
    fp32 accumulator, a bf16 activation dtype, C a multiple of 8 (at most
    1024) and H * W >= 2."""
    return (acc.dim() == 4 and acc.dtype == torch.float32 and dtype == torch.bfloat16
            and acc.shape[-1] % VEC == 0 and 0 < acc.shape[-1] <= MAX_C
            and acc.shape[0] > 0 and acc.shape[1] * acc.shape[2] >= 2)


def fusable(acc: torch.Tensor, *, dtype: torch.dtype) -> bool:
    """:func:`takes`, on a CUDA tensor: the gate of ``models/resnet.py``,
    which runs the plain composition elsewhere."""
    return acc.is_cuda and takes(acc, dtype=dtype)


def instance_norm_reference(acc: torch.Tensor, *, relu: bool = True,
                            out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """The plain version: the model's composition, ``acc`` rounded once to
    ``out_dtype``, then ``nn/functional.instance_norm`` and ReLU."""
    out = F.instance_norm(acc.to(out_dtype), eps=EPS)
    return F.relu(out) if relu else out


def fused_instance_norm(acc: torch.Tensor, *, relu: bool = True,
                        out_dtype: torch.dtype = torch.bfloat16,
                        stats: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Instance norm (+ ReLU) of the fp32 accumulator ``acc`` (B, H, W, C),
    rounded to ``out_dtype``.  A CUDA tensor launches the kernel (or
    raises); a CPU tensor takes :func:`instance_norm_reference`.  ``stats``,
    a (B, 2, C) fp32 tensor on ``acc``'s device, receives each (image,
    channel)'s mean and biased variance.  ``fused_instance_norm.launches``
    counts calls on the kernel."""
    if not takes(acc, dtype=out_dtype):
        raise ValueError(
            f"fused_instance_norm takes a 4-D fp32 (B, H, W, C) accumulator with C % {VEC} "
            f"== 0, C <= {MAX_C} and H * W >= 2, into bf16; got {acc.dtype} "
            f"{tuple(acc.shape)} into {out_dtype}")
    b, h, w, c = acc.shape
    if stats is not None and (stats.shape != (b, 2, c) or stats.dtype != torch.float32
                              or stats.device != acc.device or not stats.is_contiguous()):
        raise ValueError(f"stats must be a contiguous ({b}, 2, {c}) fp32 tensor on "
                         f"{acc.device}")
    if acc.device.type == "cpu":
        if stats is not None:
            x32 = acc.to(out_dtype).float()
            mean = x32.mean(dim=(1, 2))
            var = (x32 - mean[:, None, None]).square().mean(dim=(1, 2))
            stats.copy_(torch.stack([mean, var], 1))
        return instance_norm_reference(acc, relu=relu, out_dtype=out_dtype)
    if acc.device.type != "cuda":
        raise ValueError(f"fused_instance_norm runs on CUDA or CPU tensors, not {acc.device}")
    acc = acc.contiguous()
    if acc.data_ptr() % 16:
        raise ValueError("the kernel reads 16-byte pieces: acc must be 16-byte aligned")
    from innfer_tpu_torch.ops import _build

    lib = _build.instance_norm_library()
    part = torch.empty(b * lib.innfer_instance_norm_chunks(b, h, w, c) * 2 * c,
                       dtype=torch.float64, device=acc.device)
    out = torch.empty(acc.shape, dtype=out_dtype, device=acc.device)
    _build.launch(lib, "innfer_instance_norm", "fused_instance_norm", acc.device,
                  acc.data_ptr(), out.data_ptr(), part.data_ptr(),
                  None if stats is None else stats.data_ptr(), b, h, w, c, EPS, int(relu))
    fused_instance_norm.launches += 1
    return out


fused_instance_norm.launches = 0
