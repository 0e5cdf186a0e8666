"""Fused CycleGAN ResnetBlock: the hand-written CUDA kernel
(``csrc/resnet_block.cu`` on the shared conv core ``csrc/conv3x3_tc.cuh``:
bf16 on the tensor cores, fp32 on the FP32 pipes) and its plain PyTorch
version.

Replaces ``innfer_tpu/ops/pallas/resnet_block.py::fused_resnet_block``.
One block (reference ResNet_arch.py build_conv_block, instance norm,
reflect padding) computes

    h1  = cast(ReLU(IN(conv3x3(reflpad(x)) + b1)))
    h2  = cast(IN(conv3x3(reflpad(h1)) + b2))
    out = cast(fp32(x) + fp32(h2))

IN is per (image, channel) over H x W: biased variance, eps 1e-5, no
affine, fp32 mean and centred variance (the plain version two-pass; the
bf16 kernel per-tile mean and M2 merged with Chan's formula).  These are the Pallas kernel's rounding
points (resnet_block.py:88-103), not the plain model path's: the conv sum
goes into IN in fp32 without a rounding to the activation dtype.

Layouts follow the JAX package: x is NHWC (B, H, W, C); weights stay OIHW
as in the checkpoint, (C, C, 3, 3); biases are (C,) fp32 or None.

The kernel's gate (:func:`resnet_block_ok`): fp32 or bf16, H and W >= 2
(reflect padding needs two rows and columns), C a multiple of 32 (the
published 4*ngf = 256 and the goldens' 32).  Unlike the TPU kernel it takes
any W and any H*W: ``w % 16`` and ``h*w <= 8192`` were Mosaic's layout and
VMEM limits.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as TF

from innfer_tpu_torch.nn.functional import nchw_to_nhwc, nhwc_to_nchw, true_fp32
from innfer_tpu_torch.ops.conv3x3 import pack_conv3x3

EPS = 1e-5
CH_GROUP = 32
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


class PackedBlock(NamedTuple):
    """Kernel-layout parameters of one block: each conv's weights in the
    packed layout of ``ops/conv3x3.py``, in the activation dtype; biases
    fp32 (zeros for a bias-free conv)."""

    w1: torch.Tensor
    b1: torch.Tensor
    w2: torch.Tensor
    b2: torch.Tensor


def pack_resnet_block(w1: torch.Tensor, b1: Optional[torch.Tensor], w2: torch.Tensor,
                      b2: Optional[torch.Tensor], dtype: torch.dtype) -> PackedBlock:
    def pack_b(b):
        if b is None:
            return torch.zeros(w1.shape[0], dtype=torch.float32, device=w1.device)
        return b.to(torch.float32).contiguous()

    return PackedBlock(pack_conv3x3(w1, dtype), pack_b(b1), pack_conv3x3(w2, dtype), pack_b(b2))


def resnet_block_ok(shape: Tuple[int, ...], dtype: torch.dtype) -> bool:
    """Whether the kernel takes an NHWC activation of this shape and dtype."""
    return (len(shape) == 4 and dtype in _DTYPE_CODE and shape[1] >= 2
            and shape[2] >= 2 and shape[3] % CH_GROUP == 0)


def _check(x, w1, b1, w2, b2):
    if not resnet_block_ok(tuple(x.shape), x.dtype):
        raise ValueError(
            f"fused_resnet_block takes fp32/bf16 NHWC x with H, W >= 2 and C % "
            f"{CH_GROUP} == 0; got {tuple(x.shape)} {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("fused_resnet_block needs a contiguous NHWC x")
    c = x.shape[-1]
    for name, w, b in (("conv1", w1, b1), ("conv2", w2, b2)):
        if tuple(w.shape) != (c, c, 3, 3):
            raise ValueError(f"{name} weight {tuple(w.shape)}; expected {(c, c, 3, 3)}")
        if b is not None and tuple(b.shape) != (c,):
            raise ValueError(f"{name} bias {tuple(b.shape)}; expected {(c,)}")
        if w.device != x.device or (b is not None and b.device != x.device):
            raise ValueError(f"{name} parameters must be on x's device {x.device}")


def resnet_block_reference(x: torch.Tensor, w1: torch.Tensor, b1: Optional[torch.Tensor],
                           w2: torch.Tensor, b2: Optional[torch.Tensor], *,
                           eps: float = EPS) -> torch.Tensor:
    """The plain version: reflect pad, PyTorch convs in true fp32 on the
    activation-dtype operands (products of bf16 operands are exact in
    fp32), fp32 two-pass IN, the kernel's rounding points.  Runs on any
    device."""
    dt = x.dtype

    def conv_in(t, w, b, relu):
        t = TF.pad(nhwc_to_nchw(t).float(), (1, 1, 1, 1), mode="reflect")
        with true_fp32(torch.float32):
            acc = TF.conv2d(t, w.to(dt).float(), None if b is None else b.float())
        mean = acc.mean(dim=(2, 3), keepdim=True)
        d = acc - mean
        out = d * torch.rsqrt(d.square().mean(dim=(2, 3), keepdim=True) + eps)
        if relu:
            out = torch.relu(out)
        return nchw_to_nhwc(out.to(dt))

    h2 = conv_in(conv_in(x, w1, b1, True), w2, b2, False)
    return (x.float() + h2.float()).to(dt).contiguous()


def fused_resnet_block(x: torch.Tensor, w1: torch.Tensor, b1: Optional[torch.Tensor],
                       w2: torch.Tensor, b2: Optional[torch.Tensor], *,
                       eps: float = EPS,
                       packed: Optional[PackedBlock] = None) -> torch.Tensor:
    """One ResnetBlock forward.  A CUDA tensor launches the kernel (or
    raises); a CPU tensor takes :func:`resnet_block_reference`.  ``packed``
    is the kernel layout from :func:`pack_resnet_block`, cached by the
    caller per parameter set.  ``fused_resnet_block.launches`` counts
    kernel launches."""
    _check(x, w1, b1, w2, b2)
    if x.device.type == "cpu":
        return resnet_block_reference(x, w1, b1, w2, b2, eps=eps)
    if x.device.type != "cuda":
        raise ValueError(f"fused_resnet_block runs on CUDA or CPU tensors, not {x.device}")
    if packed is None:
        packed = pack_resnet_block(w1, b1, w2, b2, x.dtype)
    if packed.w1.dtype != x.dtype or packed.w1.device != x.device:
        raise ValueError("packed weights do not match x's dtype and device")
    if x.data_ptr() % 16:
        raise ValueError("the kernel stages 16-byte pieces: x must be 16-byte aligned")
    from innfer_tpu_torch.ops import _build

    lib = _build.resnet_block_library()
    b, h, w, c = x.shape
    out = torch.empty_like(x)
    acc = torch.empty(x.shape, dtype=torch.float32, device=x.device)
    stats = torch.empty(lib.innfer_resnet_block_stats_floats(b, h, w, c, _DTYPE_CODE[x.dtype]),
                        dtype=torch.float32, device=x.device)
    err = lib.innfer_resnet_block_forward(
        x.data_ptr(), out.data_ptr(), acc.data_ptr(), stats.data_ptr(),
        packed.w1.data_ptr(), packed.b1.data_ptr(), packed.w2.data_ptr(),
        packed.b2.data_ptr(), b, h, w, c, eps, _DTYPE_CODE[x.dtype],
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, err, "fused_resnet_block")
    fused_resnet_block.launches += 1
    return out


fused_resnet_block.launches = 0
