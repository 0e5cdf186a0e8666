"""HAT's two attentions on one hand-written bf16 kernel file
(``csrc/hat_attn.cu``), and their plain PyTorch versions.

Replaces no TPU kernel: the JAX package has no HAT.  ``models/hat.py`` runs
each block's attention, between its ``qkv`` and ``proj`` linears, on it
wherever the entry point's ``fusable`` holds:

* :func:`hat_window_attn`, a hybrid attention block's (HAB) window
  attention: Swin's, at windows of 16 x 16 (256 tokens), cyclically shifted
  by 0 or half a window, with the relative-position bias (a (31^2, heads)
  table) and, shifted, the -100 mask of ``calculate_mask``; the roll, the
  partition, the reverse and the roll back are index arithmetic, as in
  ``ops/window_attn.py``.
* :func:`overlap_attn`, an overlapping cross-attention block's (OCA): each
  16 x 16 query window against the 24 x 24 key window around it (the
  published ``nn.Unfold(24, stride 16, padding 4)`` of k and v after the
  linear), so that keys and values outside the canvas are exact zeros
  that take part in the softmax, unmasked: their score is the bias alone.
  The bias table has (16 + 24 - 1)^2 = 1521 rows, read through
  ``calculate_rpi_oca``'s index, which is negative for some pairs and
  which PyTorch's indexing wraps (:func:`oca_index`).

Both read the qkv projection in image layout, (B, Hp, Wp, 3 x heads x 32),
each head's q, k and v padded to 32 channels (``window_attn.pack_qkv``), and
write (B, Hp, Wp, ``window_attn.padded`` (C)) with zeros after C, as
``window_attn`` does.  For each window and head, over tiles of
:data:`KEY_TILE` keys in order (an online softmax, :func:`_attend`):

    q'  = bf16(q * hd ** -0.5)                q rounded once
    S   = q' k^T + B (+ M)                    fp32 sums of the bf16 products
    m'  = max(m, rowmax S),  a = exp(m - m')  fp32 statistics
    P   = exp(S - m')
    l   = a l + rowsum P                      of the unrounded P
    O   = a O + bf16(P) v                     P rounded to bf16 for the product
    out = bf16(O / l)                         normalised in fp32, rounded once

In fp32 nothing is rounded and this is the softmax attention itself.  The
plain versions run on the CPU and inside ``ops.plain_path()``; the kernel
takes exp on the SFU as 2^(x log2 e), about 1e-6 relative from the plain
versions' exp, which flips a bf16(P) rounding now and then.

The kernel (source note in ``csrc/hat_attn.cu``): a block per window and
head, the head's q, k and v staged once in swizzled 64-byte rows with its
column of the table (the bias is read at the index computed from the two
positions, never gathered), q k^T and P v on ``mma.sync`` with the softmax
in fp32 registers.  Bound by bytes (1,440 B a token at C = 180, 0.223 ms a
540p call) and, for the OCA, nearly as much by its 1.79 G exponentials.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as TF

from innfer_tpu_torch.nn.functional import true_fp32
from innfer_tpu_torch.ops.window_attn import HEAD_STRIDE, padded, shift_mask

WINDOW = 16           # the kernel's query window: 256 tokens
KEY_WINDOW = 24       # the OCA's key window: overlap ratio 0.5
KEY_TILE = 32         # keys a step of the online softmax, in the kernel and here


def key_window(window: int, overlap_ratio: float) -> int:
    """The OCA's key window, ``int(window * overlap_ratio) + window``."""
    return int(window * overlap_ratio) + window


def sa_index(window: int, device=None) -> torch.Tensor:
    """The HAB's relative-position index, (N, N) with N = window^2: the
    published ``calculate_rpi_sa`` (Swin's), values 0 .. (2 window - 1)^2 - 1."""
    ar = torch.arange(window, device=device)
    coords = torch.stack(torch.meshgrid(ar, ar, indexing="ij")).flatten(1)
    rel = (coords[:, :, None] - coords[:, None, :]).permute(1, 2, 0) + (window - 1)
    return rel[..., 0] * (2 * window - 1) + rel[..., 1]


def oca_index(window: int, kwin: int, device=None) -> torch.Tensor:
    """The OCA's relative-position index, (window^2, kwin^2): the published
    ``calculate_rpi_oca``.  For query (ih, iw) and key (jh, jw) it is
    ``(jh - ih + window - kwin + 1) (window + kwin - 1) + (jw - iw + window -
    kwin + 1)``, negative for some pairs: the table is read with PyTorch's
    indexing, which wraps a negative row r to rows + r."""
    def grid(n):
        ar = torch.arange(n, device=device)
        return torch.stack(torch.meshgrid(ar, ar, indexing="ij")).flatten(1)

    rel = (grid(kwin)[:, None, :] - grid(window)[:, :, None]).permute(1, 2, 0)
    rel = rel + (window - kwin + 1)
    return rel[..., 0] * (window + kwin - 1) + rel[..., 1]


def _bias(table: torch.Tensor, index: torch.Tensor, acc: torch.dtype) -> torch.Tensor:
    """(heads, N, M): the table's rows at ``index`` (negative rows wrapped)."""
    n, m = index.shape
    return table.to(acc)[index.reshape(-1)].reshape(n, m, -1).permute(2, 0, 1)


def _attend(q, k, v, bias, mask, *, hd: int, dt: torch.dtype, acc: torch.dtype):
    """The module docstring's arithmetic on (windows, heads, N, hd) q and
    (windows, heads, M, hd) k and v, the (heads, N, M) bias and a
    (windows, N, M) mask or None: (windows, heads, N, hd) in ``acc``,
    rounded through ``dt``."""
    rnd = lambda t: t.to(dt).to(acc)  # noqa: E731
    q = rnd(q * (hd ** -0.5))
    m = torch.full(q.shape[:-1], float("-inf"), dtype=acc, device=q.device)
    lsum = torch.zeros_like(m)
    o = torch.zeros_like(q)
    for t0 in range(0, k.shape[-2], KEY_TILE):
        t1 = t0 + KEY_TILE
        s = q @ k[..., t0:t1, :].transpose(-2, -1) + bias[..., t0:t1]
        if mask is not None:
            s = s + mask[:, None, :, t0:t1]
        mn = torch.maximum(m, s.amax(-1))
        a = torch.exp(m - mn)
        p = torch.exp(s - mn[..., None])
        lsum = lsum * a + p.sum(-1)
        o = o * a[..., None] + rnd(p) @ v[..., t0:t1, :]
        m = mn
    return rnd(o / lsum[..., None])


def _heads(qkv: torch.Tensor, heads: int, hd: int) -> torch.Tensor:
    """(3, B, Hp, Wp, heads, hd) views of the packed qkv's q, k and v."""
    b, hp, wp, _ = qkv.shape
    return qkv.reshape(b, hp, wp, 3, heads, HEAD_STRIDE)[..., :hd].permute(3, 0, 1, 2, 4, 5)


def _partition(t: torch.Tensor, w: int) -> torch.Tensor:
    """(B, Hp, Wp, heads, hd) -> (B windows, heads, w^2, hd)."""
    b, hp, wp, nh, hd = t.shape
    t = t.reshape(b, hp // w, w, wp // w, w, nh, hd).permute(0, 1, 3, 5, 2, 4, 6)
    return t.reshape(-1, nh, w * w, hd)


def _reverse(o: torch.Tensor, b: int, hp: int, wp: int, w: int) -> torch.Tensor:
    """(B windows, heads, w^2, hd) -> (B, Hp, Wp, heads hd)."""
    nh, hd = o.shape[1], o.shape[-1]
    o = o.reshape(b, hp // w, wp // w, nh, w, w, hd).permute(0, 1, 4, 2, 5, 3, 6)
    return o.reshape(b, hp, wp, nh * hd)


def _out(o: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    c = o.shape[-1]
    return TF.pad(o.to(dt), (0, padded(c) - c)).contiguous()


def hat_window_attn_reference(qkv: torch.Tensor, table: torch.Tensor, *, heads: int,
                              head_dim: int, window: int, shift: int,
                              acc: torch.dtype = torch.float32) -> torch.Tensor:
    """The plain version of :func:`hat_window_attn`: the published roll and
    partition, the bias gathered through :func:`sa_index`, the mask of
    ``window_attn.shift_mask`` and :func:`_attend`'s arithmetic in ``acc``
    (true fp32 by default; float64 sums the bf16 products with no rounding
    of its own); (B, Hp, Wp, padded(heads head_dim)) in qkv's dtype.  Runs
    on any device."""
    b, hp, wp, _ = qkv.shape
    x = torch.roll(qkv, (-shift, -shift), (1, 2)) if shift else qkv
    q, k, v = (_partition(t, window).to(acc) for t in _heads(x, heads, head_dim))
    bias = _bias(table, sa_index(window, qkv.device), acc)
    mask = None
    if shift:
        mask = shift_mask(hp, wp, window, shift, qkv.device).to(acc).repeat(b, 1, 1)
    with true_fp32(acc):
        o = _attend(q, k, v, bias, mask, hd=head_dim, dt=qkv.dtype, acc=acc)
    o = _reverse(o, b, hp, wp, window)
    if shift:
        o = torch.roll(o, (shift, shift), (1, 2))
    return _out(o, qkv.dtype)


def overlap_attn_reference(qkv: torch.Tensor, table: torch.Tensor, *, heads: int,
                           head_dim: int, window: int, kwin: int,
                           acc: torch.dtype = torch.float32) -> torch.Tensor:
    """The plain version of :func:`overlap_attn`: q partitioned into windows,
    k and v unfolded into the (kwin)^2 key windows with zeros outside the
    canvas (the published ``nn.Unfold``), the bias gathered through
    :func:`oca_index` (negative rows wrapped), :func:`_attend`'s arithmetic
    in ``acc``; (B, Hp, Wp, padded(heads head_dim)) in qkv's dtype.  Runs
    on any device."""
    b, hp, wp, _ = qkv.shape
    pad = (kwin - window) // 2
    q, k, v = _heads(qkv, heads, head_dim)
    q = _partition(q, window).to(acc)

    def unfold(t):   # (B, Hp, Wp, heads, hd) -> (B windows, heads, kwin^2, hd)
        cols = TF.unfold(t.flatten(3).permute(0, 3, 1, 2).to(acc), kwin, padding=pad,
                         stride=window)                       # (B, C kwin^2, windows)
        cols = cols.reshape(b, heads, head_dim, kwin * kwin, -1).permute(0, 4, 1, 3, 2)
        return cols.reshape(-1, heads, kwin * kwin, head_dim)

    bias = _bias(table, oca_index(window, kwin, qkv.device), acc)
    with true_fp32(acc):
        o = _attend(q, unfold(k), unfold(v), bias, None, hd=head_dim, dt=qkv.dtype, acc=acc)
    return _out(_reverse(o, b, hp, wp, window), qkv.dtype)


def takes(qkv: torch.Tensor, table: torch.Tensor, *, heads: int, head_dim: int, window: int,
          shift: int = 0, kwin: Optional[int] = None,
          weight: Optional[torch.Tensor] = None) -> bool:
    """Whether the kernel takes the block on whatever device: the HAB's
    window attention (``kwin`` None) or the OCA (``kwin`` its key window).
    bf16 (B, Hp, Wp, 3 heads 32) with Hp and Wp multiples of the 16-wide
    window, heads of an even width of at most 32, a qkv ``weight`` that is
    not tensor-parallel sharded, and for the HAB a shift of 0 or 8 and the
    (961, heads) fp32 table, for the OCA a 24-wide key window (overlap ratio
    0.5), no shift and the (1521, heads) fp32 table."""
    if kwin is None:
        rows, ok = (2 * WINDOW - 1) ** 2, shift in (0, WINDOW // 2)
    else:
        rows, ok = (WINDOW + KEY_WINDOW - 1) ** 2, kwin == KEY_WINDOW and shift == 0
    return (ok and window == WINDOW and qkv.dtype == torch.bfloat16 and qkv.dim() == 4
            and heads > 0 and qkv.shape[-1] == 3 * heads * HEAD_STRIDE
            and head_dim % 2 == 0 and 0 < head_dim <= HEAD_STRIDE
            and qkv.shape[0] > 0 and qkv.shape[1] > 0 and qkv.shape[2] > 0
            and qkv.shape[1] % WINDOW == 0 and qkv.shape[2] % WINDOW == 0
            and table.dtype == torch.float32 and tuple(table.shape) == (rows, heads)
            and not hasattr(weight, "tp_shards"))


def fusable(qkv: torch.Tensor, table: torch.Tensor, *, heads: int, head_dim: int, window: int,
            shift: int = 0, kwin: Optional[int] = None,
            weight: Optional[torch.Tensor] = None) -> bool:
    """:func:`takes`, on a CUDA tensor: the gate of both blocks in
    ``models/hat.py``, which runs the plain versions elsewhere."""
    return qkv.is_cuda and takes(qkv, table, heads=heads, head_dim=head_dim, window=window,
                                 shift=shift, kwin=kwin, weight=weight)


def _launch(entry: str, what: str, qkv: torch.Tensor, table: torch.Tensor, heads: int,
            head_dim: int, *extra) -> torch.Tensor:
    if table.device != qkv.device:
        raise ValueError("the table is not on qkv's device")
    qkv, table = qkv.contiguous(), table.contiguous()
    if qkv.data_ptr() % 16:
        raise ValueError("the kernel reads qkv in 16-byte pieces: qkv must be 16-byte aligned")
    b, hp, wp, _ = qkv.shape
    cout = padded(heads * head_dim)
    out = torch.empty((b, hp, wp, cout), dtype=qkv.dtype, device=qkv.device)
    from innfer_tpu_torch.ops import _build

    _build.launch(_build.hat_attn_library(), entry, what, qkv.device, qkv.data_ptr(),
                  table.data_ptr(), out.data_ptr(), b, hp, wp, heads, head_dim, cout, *extra,
                  head_dim ** -0.5)
    return out


def hat_window_attn(qkv: torch.Tensor, table: torch.Tensor, *, heads: int, head_dim: int,
                    window: int, shift: int) -> torch.Tensor:
    """One HAB's window attention, (B, Hp, Wp, padded(heads head_dim)) bf16
    at the pixels the tokens came from.  A CUDA tensor launches the kernel
    (or raises where :func:`takes` does not hold); a CPU tensor takes
    :func:`hat_window_attn_reference`.  ``hat_window_attn.launches`` counts
    kernel launches."""
    kw = dict(heads=heads, head_dim=head_dim, window=window, shift=shift)
    if qkv.device.type == "cpu":
        return hat_window_attn_reference(qkv, table, **kw)
    if qkv.device.type != "cuda":
        raise ValueError(f"hat_window_attn runs on CUDA or CPU tensors, not {qkv.device}")
    if not takes(qkv, table, **kw):
        raise ValueError(
            f"hat_window_attn's kernel takes a bf16 (B, Hp, Wp, 3 heads {HEAD_STRIDE}) qkv with "
            f"Hp, Wp multiples of {WINDOW}, window {WINDOW}, shift 0 or {WINDOW // 2}, heads of "
            f"an even width <= {HEAD_STRIDE}, and a ({(2 * WINDOW - 1) ** 2}, heads) fp32 table; "
            f"got {qkv.dtype} {tuple(qkv.shape)}, heads {heads}, head_dim {head_dim}, window "
            f"{window}, shift {shift}, table {table.dtype} {tuple(table.shape)}")
    out = _launch("innfer_hat_window_attn", "hat_window_attn", qkv, table, heads, head_dim, shift)
    hat_window_attn.launches += 1
    return out


def overlap_attn(qkv: torch.Tensor, table: torch.Tensor, *, heads: int, head_dim: int,
                 window: int, kwin: int) -> torch.Tensor:
    """One OCA, (B, Hp, Wp, padded(heads head_dim)) bf16 at the query
    pixels.  A CUDA tensor launches the kernel (or raises where
    :func:`takes` does not hold); a CPU tensor takes
    :func:`overlap_attn_reference`.  ``overlap_attn.launches`` counts kernel
    launches."""
    kw = dict(heads=heads, head_dim=head_dim, window=window, kwin=kwin)
    if qkv.device.type == "cpu":
        return overlap_attn_reference(qkv, table, **kw)
    if qkv.device.type != "cuda":
        raise ValueError(f"overlap_attn runs on CUDA or CPU tensors, not {qkv.device}")
    if not takes(qkv, table, **kw):
        raise ValueError(
            f"overlap_attn's kernel takes a bf16 (B, Hp, Wp, 3 heads {HEAD_STRIDE}) qkv with Hp, "
            f"Wp multiples of {WINDOW}, window {WINDOW}, key window {KEY_WINDOW}, heads of an "
            f"even width <= {HEAD_STRIDE}, and a ({(WINDOW + KEY_WINDOW - 1) ** 2}, heads) fp32 "
            f"table; got {qkv.dtype} {tuple(qkv.shape)}, heads {heads}, head_dim {head_dim}, "
            f"window {window}, key window {kwin}, table {table.dtype} {tuple(table.shape)}")
    out = _launch("innfer_overlap_attn", "overlap_attn", qkv, table, heads, head_dim)
    overlap_attn.launches += 1
    return out


hat_window_attn.launches = 0
overlap_attn.launches = 0

