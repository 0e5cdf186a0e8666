"""PPON's dilated multi-rate block (``_ResBlock_32``) on one hand-written
bf16 kernel (``csrc/dilated_block.cu`` on the TMA conv core
``csrc/conv3x3_tma.cuh``), and its plain fp32 composition.

Replaces no TPU kernel: the JAX package leaves the block to XLA's convs
(``innfer_tpu/models/ppon.py::_res_block_32``).  One block of x (B, H, W,
64) computes

    h   = lrelu(conv3x3(x; c1))                       64 ch.
    s_r = s_{r-1} + conv3x3_dilated(h, r; d_r)        32 ch, r = 1..8 (s_0 = 0)
    o   = conv1x1(lrelu(cat(s_1..s_8)); c2)           64 ch.
    y   = x + o * 0.2

and, for the last block of an RRBlock, ``y * 0.2 + res`` with ``res`` the
RRBlock's input.  The rounding points are those of the plain path in
``models/ppon.py::_res_block_32`` on bf16 tensors: each conv's fp32 sum plus
its fp32 bias rounded once, then the cascade's adds, the LeakyReLUs (slope
bf16(0.2), the product rounded) and the 0.2 residuals in bf16.

Weights stay OIHW as in the checkpoint: ``weights`` is (c1, d1..d8, c2):
(64, 64, 3, 3), eight (32, 64, 3, 3), (64, 256, 1, 1); ``biases`` their
fp32 biases.  :func:`pack_block` lays them out for the kernel: the 3x3 convs
as ``ops/conv3x3.pack_conv3x3`` packs the TMA conv's, and c2 as the mma.sync
B fragments :func:`pack_fuse` describes.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import torch
import torch.nn.functional as TF

from innfer_tpu_torch.nn.functional import nchw_to_nhwc, nhwc_to_nchw, true_fp32
from innfer_tpu_torch.ops.conv3x3 import pack_conv3x3, tma_channels

NF, GC, RATES = 64, 32, 8
SLOPE = 0.2


class PackedBlock(NamedTuple):
    """Kernel-layout parameters of one block: c1's and d1..d8's weights
    packed back to back (bf16, TMA column order), their 320 fp32 biases,
    c2's B fragments (bf16) and its 64 fp32 biases."""

    w: torch.Tensor
    b: torch.Tensor
    w2: torch.Tensor
    b2: torch.Tensor


def _fuse_k_order() -> torch.Tensor:
    """The channel of the concat that logical K index k of c2's mma.sync
    reads: lane t of k-step j = 2 m + e holds k = 16 j + 2 t (+1) in word
    2 e and 16 j + 2 t + 8 (+1) in word 2 e + 1 of its 16-byte load of
    channels 32 m + 8 t .. + 7 (``dilated_block.cu``)."""
    k = torch.arange(RATES * GC)
    j, r = k // 16, k % 16
    t, hi, e = (r % 8) // 2, r // 8, r % 2
    return 32 * (j // 2) + 8 * t + 4 * (j % 2) + 2 * hi + e


def pack_fuse(w2: torch.Tensor) -> torch.Tensor:
    """c2 (64, 256, 1, 1) as the kernel's B fragments, flat bf16:
    [k-step j][n8 tile i][lane (g, t)][b0 lo, b0 hi, b1 lo, b1 hi] with b0
    = B[k 2 t, 2 t + 1][n g], b1 = B[k 2 t + 8, 2 t + 9][n g] of logical K
    (:func:`_fuse_k_order`) and logical column n = 8 i + g, which is output
    channel ``tma_channels(64)[n]``."""
    w = w2.reshape(NF, RATES * GC).to(torch.bfloat16)
    kmap = _fuse_k_order().to(w.device)
    chans = tma_channels(NF).to(w.device)
    j = torch.arange(RATES * GC // 16, device=w.device).view(-1, 1, 1, 1)
    i = torch.arange(NF // 8, device=w.device).view(1, -1, 1, 1)
    lane = torch.arange(32, device=w.device).view(1, 1, -1, 1)
    q = torch.tensor([0, 1, 8, 9], device=w.device).view(1, 1, 1, -1)
    k, n = torch.broadcast_tensors(16 * j + 2 * (lane % 4) + q, chans[8 * i + lane // 4])
    return w[n, kmap[k]].contiguous().reshape(-1)


def pack_block(weights: Sequence[torch.Tensor], biases: Sequence[torch.Tensor]) -> PackedBlock:
    """The kernel layout of one block's (c1, d1..d8, c2) on their device."""
    w = torch.cat([pack_conv3x3(wc, torch.bfloat16, tma=True) for wc in weights[:9]])
    b = torch.cat([bc.to(torch.float32).reshape(-1) for bc in biases[:9]])
    return PackedBlock(w.contiguous(), b.contiguous(), pack_fuse(weights[9]),
                       biases[9].to(torch.float32).contiguous())


def _shapes_ok(weights: Sequence[torch.Tensor], biases: Sequence[torch.Tensor]) -> bool:
    want = [(NF, NF, 3, 3)] + [(GC, NF, 3, 3)] * RATES + [(NF, RATES * GC, 1, 1)]
    return (len(weights) == len(biases) == len(want)
            and all(w is not None and tuple(w.shape) == s for w, s in zip(weights, want))
            and all(b is not None and tuple(b.shape) == s[:1] for b, s in zip(biases, want)))


def takes(x: torch.Tensor, weights: Sequence[torch.Tensor],
          biases: Sequence[torch.Tensor]) -> bool:
    """Whether the kernel takes the block of ``x`` (NHWC) on whatever
    device: bf16, 64 channels, the block's weight shapes with every bias,
    and no tensor-parallel sharded weight."""
    return (x.dtype == torch.bfloat16 and x.dim() == 4 and x.shape[-1] == NF
            and _shapes_ok(weights, biases)
            and not any(hasattr(w, "tp_shards") for w in weights))


def fusable(x: torch.Tensor, weights: Sequence[torch.Tensor],
            biases: Sequence[torch.Tensor]) -> bool:
    """:func:`takes`, on a CUDA tensor: the gate of ``models/ppon.py``,
    which runs the plain composition elsewhere."""
    return x.is_cuda and takes(x, weights, biases)


def dilated_block_reference(x: torch.Tensor, weights: Sequence[torch.Tensor],
                            biases: Sequence[torch.Tensor], *,
                            res: Optional[torch.Tensor] = None,
                            acc: torch.dtype = torch.float32) -> torch.Tensor:
    """The plain version: PyTorch convs on the block's values, summed with
    their bias in ``acc`` (true fp32 by default; products of bf16 operands
    are exact in fp32, and float64 sums them with no rounding of its own)
    and rounded through x's dtype where the kernel rounds; the elementwise
    steps in fp32.  Runs on any device and dtype."""
    dt = x.dtype
    rnd = lambda t: t.to(dt).float()  # noqa: E731
    s = torch.tensor(SLOPE, dtype=dt).float()
    lrelu = lambda t: torch.where(t >= 0, t, rnd(t * s))  # noqa: E731
    wf = [w.to(dt).to(acc) for w in weights]
    bf = [b.to(acc) for b in biases]

    def conv(t, i, **kw):
        return rnd(TF.conv2d(t.to(acc), wf[i], bf[i], **kw))

    xf = nhwc_to_nchw(x).float()
    with true_fp32(acc):
        h = lrelu(conv(xf, 0, padding=1))
        total, sums = None, []
        for r in range(1, RATES + 1):
            v = conv(h, r, padding=r, dilation=r)
            total = v if total is None else rnd(total + v)
            sums.append(total)
        o = conv(lrelu(torch.cat(sums, 1)), 9)
    y = rnd(xf + rnd(o * s))
    if res is not None:
        y = rnd(rnd(y * s) + nhwc_to_nchw(res).float())
    return nchw_to_nhwc(y.to(dt)).contiguous()


def fused_dilated_block(x: torch.Tensor, weights: Sequence[torch.Tensor],
                        biases: Sequence[torch.Tensor], *, res: Optional[torch.Tensor] = None,
                        packed: Optional[PackedBlock] = None) -> torch.Tensor:
    """One block forward (``res``: the RRBlock's input, whose residual the
    last block of an RRBlock applies) on the kernel, for a CUDA tensor
    (another device raises).  ``packed`` is :func:`pack_block`'s layout, cached by the caller per
    parameter set.  ``fused_dilated_block.launches`` counts blocks run on
    the kernel."""
    if not takes(x, weights, biases):
        raise ValueError(
            f"fused_dilated_block takes a bf16 (B, H, W, {NF}) x and the block's "
            f"unsharded weights (c1, d1..d8, c2) with biases; got {x.dtype} {tuple(x.shape)}")
    if res is not None and (res.shape != x.shape or res.dtype != x.dtype
                            or res.device != x.device):
        raise ValueError("res must match x's shape, dtype and device")
    if x.device.type != "cuda":
        raise ValueError(f"fused_dilated_block runs on CUDA tensors, not {x.device}")
    if packed is None:
        packed = pack_block(weights, biases)
    if packed.w.device != x.device:
        raise ValueError("packed weights are not on x's device")
    x = x.contiguous()
    res = None if res is None else res.contiguous()
    b, h, w, _ = x.shape
    hbuf = torch.empty_like(x)
    ws = torch.empty((b, h, w, RATES * GC), dtype=x.dtype, device=x.device)
    out = torch.empty_like(x)
    for t in (x, res):
        if t is not None and t.data_ptr() % 16:
            raise ValueError("the kernel moves 16-byte pieces: x and res must be 16-byte aligned")
    from innfer_tpu_torch.ops import _build

    lib = _build.dilated_block_library()
    _build.launch(lib, "innfer_dilated_block", "fused_dilated_block", x.device,
                  x.data_ptr(), hbuf.data_ptr(), ws.data_ptr(), out.data_ptr(),
                  None if res is None else res.data_ptr(), packed.w.data_ptr(),
                  packed.b.data_ptr(), packed.w2.data_ptr(), packed.b2.data_ptr(), b, h, w)
    fused_dilated_block.launches += 1
    return out


fused_dilated_block.launches = 0
