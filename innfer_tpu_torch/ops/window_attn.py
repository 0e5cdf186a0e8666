"""SwinIR's shifted-window attention on one hand-written bf16 kernel
(``csrc/window_attn.cu``), and its plain PyTorch version.

Replaces no TPU kernel: the JAX package has no SwinIR.  One launch per
Swin transformer layer computes, from the qkv projection's output in image
layout ``qkv`` (B, Hp, Wp, 3 x heads x 32), what the published
``WindowAttention`` computes between its ``qkv`` and ``proj`` linears
(``network_swinir.py``), with the roll, the window partition, the window
reverse and the roll back done by index arithmetic: window (wr, wc) of a
layer shifted by s (0, or half the window) holds, at its position (a, b),
the token at source pixel ((w wr + a + s) mod Hp, (w wc + b + s) mod Wp),
and its output goes back to that pixel.  For each window and head:

    q'  = bf16(q * hd ** -0.5)                    q rounded once, as ``q * scale``
    S   = q' k^T  + B[h]  + M                     fp32: the products of bf16
                                                  values summed in fp32, the
                                                  layer's relative-position bias
                                                  and, shifted, the mask
    P   = bf16(softmax(S))                        fp32 softmax, rounded once
    O   = bf16(P v)                               fp32 sums, rounded once

The layout is the GEMMs' (``models/swinir.py``): each head's q, k and v
padded from hd to :data:`HEAD_STRIDE` channels by zero rows of the packed
qkv weight (:func:`pack_qkv`), so that a token's qkv row is 16-byte
aligned (3 x 6 x 32 = 576 channels for SwinIR-M, not 540); the output
(B, Hp, Wp, :func:`padded` (C)) holds head h's hd channels at h x hd and
zeros after C = heads x hd, so that the proj GEMM reads 16-byte rows too.

``B`` is the layer's table gathered by its relative-position index into a
(heads, 64, 64) fp32 tensor once (:func:`gather_bias`); ``M`` is -100
between positions of the rolled canvas that lie in different regions of
``calculate_mask`` (rows and columns cut at ``-window`` and ``-shift``),
else 0, computed from the rolled coordinates for the canvas at hand.
:func:`window_attn_reference` is the same arithmetic in plain PyTorch
(roll, partition, matmuls), run on the CPU and by ``ops.plain_path()``.

The kernel (source note in ``csrc/window_attn.cu``): one block per window,
the window's 64 qkv rows staged in shared memory once, each head's two
products on ``mma.sync`` with the head width padded to 32 in registers and
the softmax in fp32 registers; the output leaves through shared memory in
whole rows.  Bytes bound it: q, k and v read once and the output written
once, 8 C bytes a token, against 4 x 64 x C operations a token.
"""
from __future__ import annotations

from typing import Optional

import torch

from innfer_tpu_torch.nn.functional import true_fp32

WINDOW = 8          # the kernel's window: 64 tokens, four m16 row tiles
HEAD_STRIDE = 32    # a head's q, k, v width in qkv: two k16 steps, four n8 tiles
MASK = -100.0
SMEM_MAX = 232448   # an H100 block's shared memory: a window's qkv and output rows


def padded(c: int) -> int:
    """A token width rounded up to 8 channels: 16-byte bf16 rows, which the
    tensor-core GEMMs need to read and write at full speed."""
    return -(-c // 8) * 8


def pack_qkv(w: torch.Tensor, b: torch.Tensor, heads: int, k_width: int):
    """The qkv linear's (3 C, C) weight and (3 C,) bias in the kernel's
    layout: each head's q, k and v rows padded with zero rows to
    :data:`HEAD_STRIDE`, and the input columns with zeros to ``k_width``;
    (3 heads 32, k_width) in w's dtype and (3 heads 32,) fp32."""
    c = w.shape[1]
    hd = c // heads
    wp = w.new_zeros(3, heads, HEAD_STRIDE, k_width)
    wp[..., :hd, :c] = w.reshape(3, heads, hd, c)
    bp = torch.zeros(3, heads, HEAD_STRIDE, dtype=torch.float32, device=w.device)
    bp[..., :hd] = b.float().reshape(3, heads, hd)
    return wp.reshape(-1, k_width).contiguous(), bp.reshape(-1)


def gather_bias(table: torch.Tensor, window: int) -> torch.Tensor:
    """A layer's relative-position bias table ((2 window - 1)^2, heads) as
    the (heads, N, N) fp32 tensor that the scores add, N = window^2: entry
    (h, i, j) is the table's row for the offset between positions i and j
    of a window (the published ``relative_position_index``)."""
    ar = torch.arange(window, device=table.device)
    coords = torch.stack(torch.meshgrid(ar, ar, indexing="ij")).flatten(1)
    rel = coords[:, :, None] - coords[:, None, :] + (window - 1)
    index = rel[0] * (2 * window - 1) + rel[1]
    n = window * window
    return table.float()[index.reshape(-1)].reshape(n, n, -1).permute(2, 0, 1).contiguous()


def shift_mask(hp: int, wp: int, window: int, shift: int, device=None) -> torch.Tensor:
    """(windows, N, N) fp32: -100 between two positions of a window of the
    rolled canvas whose regions differ, else 0 (``calculate_mask`` for a
    canvas of hp x wp)."""
    def regions(n):
        r = torch.zeros(n, dtype=torch.long, device=device)
        r[n - window:n - shift] = 1
        r[n - shift:] = 2
        return r

    reg = 3 * regions(hp)[:, None] + regions(wp)[None, :]
    win = reg.reshape(hp // window, window, wp // window, window).permute(0, 2, 1, 3)
    win = win.reshape(-1, window * window)
    return torch.where(win[:, None, :] != win[:, :, None], MASK, 0.0).float()


def window_attn_reference(qkv: torch.Tensor, bias: torch.Tensor, *, heads: int, head_dim: int,
                          window: int, shift: int, acc: torch.dtype = torch.float32
                          ) -> torch.Tensor:
    """The plain version: the published roll and partition, the products in
    ``acc`` (true fp32 by default; float64 sums the bf16 products with no
    rounding of its own) and the rounding points of the module docstring,
    through ``qkv``'s dtype; (B, Hp, Wp, padded(heads head_dim)), zeros
    after heads x head_dim.  Runs on any device."""
    b, hp, wp, _ = qkv.shape
    hd, w, n = head_dim, window, window * window
    c = heads * hd
    nw = (hp // w) * (wp // w)
    dt = qkv.dtype
    rnd = lambda t: t.to(dt).to(acc)  # noqa: E731
    x = torch.roll(qkv, (-shift, -shift), (1, 2)) if shift else qkv
    x = x.reshape(b, hp, wp, 3, heads, -1)[..., :hd]
    win = x.reshape(b, hp // w, w, wp // w, w, 3, heads, hd).permute(5, 0, 1, 3, 6, 2, 4, 7)
    q, k, v = win.reshape(3, b * nw, heads, n, hd).to(acc)
    with true_fp32(acc):
        q = rnd(q * (hd ** -0.5))
        s = q @ k.transpose(-2, -1) + bias.to(acc)
        if shift:
            mask = shift_mask(hp, wp, w, shift, qkv.device).to(acc)
            s = (s.reshape(b, nw, heads, n, n) + mask[None, :, None]).reshape(b * nw, heads, n, n)
        p = rnd(torch.softmax(s, dim=-1))
        o = rnd(p @ v)
    o = o.reshape(b, hp // w, wp // w, heads, w, w, hd).permute(0, 1, 4, 2, 5, 3, 6)
    o = o.reshape(b, hp, wp, c)
    if shift:
        o = torch.roll(o, (shift, shift), (1, 2))
    return torch.nn.functional.pad(o.to(dt), (0, padded(c) - c)).contiguous()


def _smem(heads: int, cout: int) -> int:
    return 64 * (3 * heads * HEAD_STRIDE + 8 + cout) * 2


def takes(qkv: torch.Tensor, bias: torch.Tensor, *, heads: int, head_dim: int, window: int,
          shift: int, weight: Optional[torch.Tensor] = None) -> bool:
    """Whether the kernel takes the layer on whatever device: bf16 (B, Hp,
    Wp, 3 heads 32) with Hp and Wp multiples of an 8-wide window, heads of
    an even width of at most 32, a shift of 0 or 4, the (heads, 64, 64)
    fp32 bias, a window's rows within shared memory, and a qkv ``weight``
    that is not tensor-parallel sharded."""
    return (qkv.dtype == torch.bfloat16 and qkv.dim() == 4 and heads > 0
            and qkv.shape[-1] == 3 * heads * HEAD_STRIDE and window == WINDOW
            and shift in (0, WINDOW // 2) and head_dim % 2 == 0 and 0 < head_dim <= HEAD_STRIDE
            and qkv.shape[0] > 0 and qkv.shape[1] > 0 and qkv.shape[2] > 0
            and qkv.shape[1] % WINDOW == 0 and qkv.shape[2] % WINDOW == 0
            and _smem(heads, padded(heads * head_dim)) <= SMEM_MAX
            and bias.dtype == torch.float32 and tuple(bias.shape) == (heads, 64, 64)
            and not hasattr(weight, "tp_shards"))


def fusable(qkv: torch.Tensor, bias: torch.Tensor, *, heads: int, head_dim: int, window: int,
            shift: int, weight: Optional[torch.Tensor] = None) -> bool:
    """:func:`takes`, on a CUDA tensor: the gate of ``models/swinir.py``,
    which runs :func:`window_attn_reference` elsewhere."""
    return qkv.is_cuda and takes(qkv, bias, heads=heads, head_dim=head_dim, window=window,
                                 shift=shift, weight=weight)


def window_attn(qkv: torch.Tensor, bias: torch.Tensor, *, heads: int, head_dim: int,
                window: int, shift: int) -> torch.Tensor:
    """One layer's attention, (B, Hp, Wp, padded(heads head_dim)) bf16 at
    the pixels the tokens came from.  A CUDA tensor launches the kernel (or
    raises where :func:`takes` does not hold); a CPU tensor takes
    :func:`window_attn_reference`.  ``window_attn.launches`` counts kernel
    launches."""
    kw = dict(heads=heads, head_dim=head_dim, window=window, shift=shift)
    if qkv.device.type == "cpu":
        return window_attn_reference(qkv, bias, **kw)
    if qkv.device.type != "cuda":
        raise ValueError(f"window_attn runs on CUDA or CPU tensors, not {qkv.device}")
    if not takes(qkv, bias, **kw):
        raise ValueError(
            f"window_attn's kernel takes a bf16 (B, Hp, Wp, 3 heads {HEAD_STRIDE}) qkv with Hp, "
            f"Wp multiples of {WINDOW}, window {WINDOW}, shift 0 or {WINDOW // 2}, heads of an "
            f"even width <= {HEAD_STRIDE}, and a (heads, 64, 64) fp32 bias; got {qkv.dtype} "
            f"{tuple(qkv.shape)}, heads {heads}, head_dim {head_dim}, window {window}, shift "
            f"{shift}, bias {bias.dtype} {tuple(bias.shape)}")
    if bias.device != qkv.device:
        raise ValueError("the bias is not on qkv's device")
    qkv, bias = qkv.contiguous(), bias.contiguous()
    if qkv.data_ptr() % 16:
        raise ValueError("the kernel reads qkv in 16-byte pieces: qkv must be 16-byte aligned")
    b, hp, wp, _ = qkv.shape
    cout = padded(heads * head_dim)
    out = torch.empty((b, hp, wp, cout), dtype=qkv.dtype, device=qkv.device)
    from innfer_tpu_torch.ops import _build

    lib = _build.window_attn_library()
    _build.launch(lib, "innfer_window_attn", "window_attn", qkv.device, qkv.data_ptr(),
                  bias.data_ptr(), out.data_ptr(), b, hp, wp, heads, head_dim, cout, shift,
                  head_dim ** -0.5)
    window_attn.launches += 1
    return out


window_attn.launches = 0
