"""Functional NN ops with PyTorch inference semantics, in the JAX package's
NHWC layout.

The port's counterpart of ``innfer_tpu/nn/functional.py`` for the ops the
ESRGAN (evsrgan's Conv3D too), CycleGAN, SRResNet, PAN, PPON, pix2pix UNet
and WBC paths and the image filters (``ops/filters.py``) need.  Activations are NHWC tensors, as the JAX package's
public functions take them; conv weights stay OIHW, as in the checkpoint.
A contiguous NHWC tensor viewed with ``permute(0, 3, 1, 2)`` is a
channels-last NCHW tensor, so cuDNN runs on it without a copy.

fp32 is the parity path and runs true fp32: cuDNN convolutions and cuBLAS
matmuls would otherwise take TF32 on the card (``allow_tf32``), keeping
about three decimal digits -- the same class of error as the round-5 TPU
precision bug (``innfer_tpu/nn/functional.py::_mm_precision``).

A bf16 convolution computes what the JAX package's does
(``innfer_tpu/nn/functional.py:103-105``): bf16 operands, an fp32
accumulator to which the fp32 bias is added, one rounding to bf16.  It
runs as an fp32 convolution of the bf16-valued operands with TF32 allowed:
bf16 values are exact in TF32 and their products exact in fp32, so TF32
loses nothing here (on the CPU the flag is moot and the conv is true
fp32).  A bf16 cuDNN conv would round the bias to bf16 before adding it.

Tensor parallelism (``parallel/mesh.tp_shard_params``): a conv weight
sharded on its output channels carries its shards as ``w.tp_shards``;
:func:`conv2d` (ungrouped) and :func:`conv_transpose2d` run one shard per
model device and concatenate the outputs on the input's device, each
shard's conv through the same accumulate route and TF32 guard.  Every
other consumer of a sharded parameter (the fused kernels' weight packing,
the tail rewrites' derived weights, norms, PReLU, dense layers) reads the
gathered tensor: a Pallas call on the TPU cannot be partitioned either,
so the kernel route runs on gathered weights.
"""
from __future__ import annotations

import contextlib
from typing import Optional, Sequence, Tuple, Union

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


@contextlib.contextmanager
def _tf32_for_bf16_operands(lib):
    """Allow TF32 in ``lib`` (``torch.backends.cudnn`` for a conv,
    ``torch.backends.cuda.matmul`` for a matmul) while an fp32 op of
    bf16-valued operands runs (exact: see the module docstring); the
    previous flag is restored."""
    prev = lib.allow_tf32
    lib.allow_tf32 = True
    try:
        yield
    finally:
        lib.allow_tf32 = prev


def _fp32_accumulate(fn, lib, x: torch.Tensor, *operands, out_dtype=None):
    """``fn(x, *operands)`` with an fp32 accumulator: true fp32 for fp32/fp64
    ``x``; otherwise fp32 on the bf16 values (TF32 allowed in ``lib``),
    then one rounding to ``out_dtype`` (default ``x.dtype``).  Operands
    come cast as they should multiply: weights to ``x``'s dtype, biases
    fp32."""
    dt = x.dtype
    if dt in (torch.float32, torch.float64):
        with true_fp32(dt):
            out = fn(x, *(None if t is None else t.to(dt) for t in operands))
        return out if out_dtype is None else out.to(out_dtype)
    with _tf32_for_bf16_operands(lib):
        out = fn(x.float(), *(None if t is None else t.float() for t in operands))
    return out.to(out_dtype or dt)


def _conv(fn, x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor], *,
          out_dtype=None, **kw):
    """``fn`` (TF.conv2d, TF.conv_transpose2d or TF.conv3d) on channels-last
    ``x`` (NHWC or NDHWC): true fp32 for fp32/fp64 activations; otherwise
    bf16-valued operands accumulated in fp32 with the fp32 bias, rounded
    once to the activation dtype (or kept in ``out_dtype``).  Moving the
    channel axis to 1 is a view that cuDNN takes as channels_last(_3d)."""
    out = _fp32_accumulate(lambda t, wt, bt: fn(t.movedim(-1, 1), wt, bt, **kw),
                           torch.backends.cudnn, x, w.to(x.dtype), b,
                           out_dtype=out_dtype)
    return out.movedim(1, -1)


def _conv_any(fn, x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor], *,
              out_dtype=None, **kw) -> torch.Tensor:
    """:func:`_conv`, or, where ``w`` is tensor-parallel sharded on its
    output channels (``w.tp_shards``, set by
    ``parallel/mesh.tp_shard_params``) and the conv is not grouped, one
    conv per shard on its model device with ``x`` copied there, the
    outputs concatenated on ``x``'s device: the all-gather XLA inserts in
    the JAX package."""
    shards = getattr(w, "tp_shards", None)
    if shards is None or kw.get("groups", 1) != 1:
        return _conv(fn, x, w, b, out_dtype=out_dtype, **kw)
    # the bias has the weight's output channels, so the same rule shards it
    b_shards = (None,) * len(shards) if b is None else b.tp_shards
    outs = []
    for ws, bs in zip(shards, b_shards):
        dev = ws.device
        xs = x.to(dev, non_blocking=dev.type == "cuda")
        outs.append(_conv(fn, xs, ws, bs, out_dtype=out_dtype, **kw))
    return torch.cat([o.to(x.device, non_blocking=x.device.type == "cuda") for o in outs],
                     dim=-1)


def nhwc_to_nchw(x: torch.Tensor) -> torch.Tensor:
    """NHWC -> NCHW view (channels-last memory when ``x`` is contiguous)."""
    return x.permute(0, 3, 1, 2)


def nchw_to_nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def conv2d(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None,
           *, stride: int = 1,
           padding: Union[int, Tuple[int, int], Sequence[Tuple[int, int]]] = 0,
           dilation: int = 1, groups: int = 1,
           out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """2D convolution, NHWC x OIHW -> NHWC.  Matches torch.nn.Conv2d;
    ``groups`` = channels with a (C, 1, kh, kw) weight is the depthwise
    filter of ``ops/filters.filter2d``.

    ``padding`` is an int, an (ph, pw) pair, or explicit [(top, bottom),
    (left, right)] zeros, as ``innfer_tpu/nn/functional.py::conv2d`` takes
    them; an asymmetric one pads the conv's own input (the fp32 copy on
    the bias route) inside the accumulate route.

    Weights are cast to the activation dtype; the bias stays fp32 and is
    added to the fp32 accumulator before the one rounding (see the module
    docstring).  ``out_dtype`` (e.g. fp32) keeps the accumulator's dtype
    instead, so a caller can go on accumulating across convs.
    """
    fn = TF.conv2d
    if not isinstance(padding, int) and not isinstance(padding[0], int):
        (top, bottom), (left, right) = padding
        if top == bottom and left == right:
            padding = (top, left)
        else:
            pads = (left, right, top, bottom)
            fn = lambda t, wt, bt, **kw: TF.conv2d(TF.pad(t, pads), wt, bt, **kw)  # noqa: E731
            padding = 0
    return _conv_any(fn, x, w, b, out_dtype=out_dtype, stride=stride, padding=padding,
                     dilation=dilation, groups=groups)


def conv3d(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None,
           *, stride: int = 1, padding: int = 0, dilation: int = 1) -> torch.Tensor:
    """3D convolution, NDHWC x OIDHW (the checkpoint's layout) -> NDHWC,
    matching torch.nn.Conv3d (the reference's evsrgan convtype='Conv3D').
    The accumulate route, bias and rounding of :func:`conv2d`."""
    return _conv(TF.conv3d, x, w, b, stride=stride, padding=padding, dilation=dilation)


@contextlib.contextmanager
def _autotuned_deterministic():
    """cuDNN's ``benchmark`` and ``deterministic`` flags on for the block,
    restored after it."""
    cudnn = torch.backends.cudnn
    saved = cudnn.benchmark, cudnn.deterministic
    cudnn.benchmark, cudnn.deterministic = True, True
    try:
        yield
    finally:
        cudnn.benchmark, cudnn.deterministic = saved


def conv_transpose2d(x: torch.Tensor, w: torch.Tensor,
                     b: Optional[torch.Tensor] = None, *, stride: int = 2,
                     padding: int = 1, output_padding: int = 0,
                     out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Transposed convolution, NHWC -> NHWC, matching torch.nn.ConvTranspose2d.
    ``w`` keeps the checkpoint's (I, O, kh, kw) layout, so no flip is needed:
    out = (in - 1) * stride - 2 * padding + kh + output_padding.  Bias,
    rounding and ``out_dtype`` as :func:`conv2d`.

    cuDNN runs it as a backward-data conv and picks among its deterministic
    algorithms by timing them, once per shape in the process, as the
    reference's flags ask (run.py:336-337).  On the H100, with no flag
    pix2pix unet_256's outputs differed between two passes, and with
    ``deterministic`` alone the heuristic's pick took 238 ms at 1280x2048
    bf16 against 10 ms autotuned (PERF.md, PR 11)."""
    with _autotuned_deterministic():
        return _conv_any(TF.conv_transpose2d, x, w, b, out_dtype=out_dtype, stride=stride,
                         padding=padding, output_padding=output_padding)


_MATMUL = torch.backends.cuda.matmul


def dense(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Channel-mixing matmul over the last axis (a 1x1 Conv1d).  ``w`` keeps
    the checkpoint's Conv1d layout (O, I, 1); the fp32 bias joins the fp32
    accumulator before the one rounding, as ``innfer_tpu/nn/functional.py:
    197-205``."""
    w2 = w.reshape(w.shape[0], -1).t().to(x.dtype)
    out = _fp32_accumulate(torch.matmul, _MATMUL, x, w2, out_dtype=torch.float32)
    if b is not None:
        out = out + b.float()
    return out.to(x.dtype)


@contextlib.contextmanager
def _fp32_bf16_reductions():
    """cuBLAS keeps a bf16 GEMM's split-K partial sums in fp32 while the
    block runs (``allow_bf16_reduced_precision_reduction`` off); the
    previous flag is restored."""
    prev = _MATMUL.allow_bf16_reduced_precision_reduction
    _MATMUL.allow_bf16_reduced_precision_reduction = False
    try:
        yield
    finally:
        _MATMUL.allow_bf16_reduced_precision_reduction = prev


def linear(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``nn.Linear`` over the last axis, ``w`` in its (out, in) layout.  fp32
    runs true fp32.  A bf16 ``x`` runs one bf16 GEMM on the tensor cores
    (``torch.addmm``) with fp32 accumulation and one rounding of the sum:
    the bias joins the fp32 accumulator before that rounding, but as bf16
    (a caller keeps ``b`` in x's dtype to spare the cast), a departure from
    the conv route's fp32 bias that a GEMM's bias epilogue forces; no fp32
    copy of ``x`` is made.  Transformer linears (SwinIR); the Conv1d
    projections keep :func:`dense`."""
    dt = x.dtype
    b = None if b is None else b.to(dt)
    if dt in (torch.float32, torch.float64):
        with true_fp32(dt):
            return TF.linear(x, w.to(dt), b)
    x2 = x.reshape(-1, x.shape[-1])
    wt = w.to(dt).t()
    with _fp32_bf16_reductions():
        out = torch.mm(x2, wt) if b is None else torch.addmm(b, x2, wt)
    return out.reshape(*x.shape[:-1], w.shape[0])


def matmul(a: torch.Tensor, b: torch.Tensor, *,
           out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``a @ b`` (batched) with an fp32 accumulator, rounded once to
    ``out_dtype`` (default ``a.dtype``): ``jnp.einsum`` with
    ``preferred_element_type=float32``.  A bf16 ``torch.matmul`` would
    round its result to bf16 first."""
    return _fp32_accumulate(torch.matmul, _MATMUL, a, b.to(a.dtype), out_dtype=out_dtype)


def pad2d(x: torch.Tensor, pad: Union[int, Tuple[int, int, int, int]],
          mode: str = "zero") -> torch.Tensor:
    """Spatial padding of an NHWC tensor: ``pad`` is an int (all sides) or
    torch-F.pad-ordered (left, right, top, bottom); ``mode`` 'zero' |
    'reflect' | 'replicate' (nn.ZeroPad2d / ReflectionPad2d /
    ReplicationPad2d)."""
    if mode not in ("zero", "reflect", "replicate"):
        raise NotImplementedError(f"padding mode [{mode}] is not implemented")
    pads = (pad,) * 4 if isinstance(pad, int) else tuple(pad)
    out = TF.pad(nhwc_to_nchw(x), pads, mode="constant" if mode == "zero" else mode)
    return nchw_to_nhwc(out).contiguous()


def tf_same_padding(x: torch.Tensor, k_size: int = 3) -> torch.Tensor:
    """TF-style asymmetric SAME padding before a stride-2 conv (WBC tf
    mode, reference WBCNet_arch.py:141-143): zeros of (left, right, top,
    bottom) = (j-1, j, j-1, j) with j = k // 2."""
    j = k_size // 2
    return pad2d(x, (j - 1, j, j - 1, j), mode="zero")


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


def prelu(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """PReLU with a per-channel (or single) weight; channel is the last
    axis.  The weight multiplies in the activation dtype."""
    w = weight.to(x.dtype)
    if w.numel() > 1:
        w = w.reshape((1,) * (x.dim() - 1) + (-1,))
    return torch.where(x >= 0, x, x * w)


def swish(x: torch.Tensor, beta: torch.Tensor, slope: float = 1.67653251702,
          inplace: bool = False) -> torch.Tensor:
    """Learnable-beta Swish, ``slope * x * sigmoid(beta * x)`` (reference
    block.py:14-78).  ``inplace=True`` reproduces the reference's in-place
    swish_func (block.py:36-40), which discards the sigmoid and computes
    ``slope * x * x``: conv_block activations default to in place, so
    checkpoints trained with swish embody it (golden esrgan_swish_x2)."""
    s = torch.tensor(slope, dtype=x.dtype)
    if inplace:
        return s * x * x
    return s * x * torch.sigmoid(beta.to(x.dtype) * x)


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    return torch.sigmoid(x)


def act(kind: Optional[str], x: torch.Tensor, *, neg_slope: float = 0.2,
        params=None, key: str = "", inplace: bool = True) -> torch.Tensor:
    """Activation dispatcher (reference block.py:81-101).  prelu and swish
    read ``params[key + ".weight"]`` / ``params[key + ".beta"]``;
    ``inplace`` mirrors the reference act() default and changes only
    swish (see :func:`swish`)."""
    if kind is None:
        return x
    kind = kind.lower()
    if kind == "relu":
        return torch.relu(x)
    if kind in ("leakyrelu", "lrelu"):
        return leaky_relu(x, neg_slope)
    if kind == "tanh":
        return torch.tanh(x)
    if kind == "sigmoid":
        return torch.sigmoid(x)
    if kind in ("prelu", "swish"):
        if params is None or not key:
            raise NotImplementedError(
                f"{kind} activation needs parameter plumbing at this call site")
        if kind == "prelu":
            return prelu(x, params[key + ".weight"])
        return swish(x, params[key + ".beta"], inplace=inplace)
    raise NotImplementedError(f"activation layer [{kind}] is not found")


def pixel_shuffle(x: torch.Tensor, r: int) -> torch.Tensor:
    """PixelShuffle with torch channel ordering, in NHWC:
    out[b, h*r+i, w*r+j, c] = in[b, h, w, c*r*r + i*r + j]."""
    b, h, w, crr = x.shape
    c = crr // (r * r)
    x = x.reshape(b, h, w, c, r, r).permute(0, 1, 4, 2, 5, 3)
    return x.reshape(b, h * r, w * r, c)


def max_pool2d(x: torch.Tensor, kernel: int, stride: Optional[int] = None) -> torch.Tensor:
    """MaxPool2d with no padding (nn.MaxPool2d(k, s)), NHWC."""
    return nchw_to_nhwc(TF.max_pool2d(nhwc_to_nchw(x), kernel, stride or kernel))


def softmax(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Softmax computed in fp32, cast back to ``x``'s dtype."""
    return torch.softmax(x.float(), dim=dim).to(x.dtype)
