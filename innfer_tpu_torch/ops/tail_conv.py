"""The SR tail's bf16 3x3 convs on one hand-written kernel
(``csrc/tail_conv.cu`` on the TMA conv core ``csrc/conv3x3_tma.cuh``),
whose epilogue adds the fp32 bias, rounds once to bf16, applies the
activation in bf16 and stores into the layout the next op reads.

``models/common.py`` runs through it the upsample block's conv (written
pixel-shuffled), the phase tail's first conv (written phase-major) and the
phase tail's HR conv and conv_last (on the phase-major grid at the HR
conv's own operation count), wherever :func:`fusable` holds; everything
else keeps the plain composition there (``F.conv2d`` + ``F.act`` +
``pixel_shuffle`` / ``nn/phase.conv_phases``), which is this kernel's plain
version.

A tail conv has 4 * cp outputs, cp per output phase (a, c) of a 2x
upsample, q = 2 a + c.  The kernel's accumulator columns are four blocks
of cpad >= cp channels (8, 16, 32 or 64), one per phase q; padded columns
are zeros.  Two modes:

* plain: a 3x3 conv whose output channels are phase-major (``q * cp + o``),
  packed as ``ops/conv3x3.pack_conv3x3`` packs, in N tiles of
  ``min(4 cpad, 128)`` columns;
* phase: the HR conv ``w`` (cp, C, 3, 3) on a phase-major input of 4 C
  channels.  Each 16-channel chunk of input phase p is 9 weight blocks,
  one per tap :func:`phase_taps` lists, back to back, each
  ``[8-channel half][cpad][8]``.

:func:`emulate` reads the packed weights as the kernel does, in fp32 with
the kernel's rounding points: the wrapper's path for a CPU tensor, and the
CPU tests' check of the packing against the plain composition.
"""
from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as TF

KC = 16
CPADS = (8, 16, 32, 64)
ACTS = {None: 0, "leakyrelu": 1, "lrelu": 1, "relu": 2}
LAYOUTS = {"phase": 0, "shuffle": 1}
SLOPE = 0.2


class PackedTail(NamedTuple):
    """One tail conv in the kernel's layout: the packed bf16 weights, the
    fp32 bias in column order, the input channels, the real and padded
    channels a phase, and the mode."""

    w: torch.Tensor
    b: torch.Tensor
    cin: int
    cp: int
    cpad: int
    phase: bool


def _norm_act(act: Optional[str]) -> Optional[str]:
    return act.lower() if isinstance(act, str) else act


def cpad_for(cp: int) -> Optional[int]:
    """The padded channels a phase for ``cp`` real ones; None past 64."""
    return next((c for c in CPADS if c >= cp), None)


def takes(x: torch.Tensor, w: Optional[torch.Tensor], act: Optional[str], *,
          mode: str) -> bool:
    """Whether the kernel takes a tail conv of ``x`` (NHWC) by the
    checkpoint's 3x3 weight ``w``, on whatever device: bf16, a 3x3 weight
    that is not tensor-parallel sharded, an activation of None, LeakyReLU
    or ReLU, and channel counts the kernel takes (input channels, or in
    phase space each input phase's, a multiple of 16; at most 64 outputs a
    phase).  ``mode`` says how ``w`` maps to the 4 cp outputs: "upconv"
    (cp, cin, 3, 3), collapsed to 4 cp; "pixelshuffle" (4 cp, cin, 3, 3);
    "phase" the HR conv (cp, C, 3, 3) on the phase-major ``x`` of 4 C
    channels."""
    if x.dtype != torch.bfloat16 or x.dim() != 4:
        return False
    if w is None or w.dim() != 4 or tuple(w.shape[2:]) != (3, 3) or hasattr(w, "tp_shards"):
        return False
    if _norm_act(act) not in ACTS:
        return False
    cout, cin = w.shape[:2]
    if mode == "pixelshuffle":
        if cout % 4:
            return False
        cout //= 4
    per_phase_in = 4 * cin if mode == "phase" else cin
    return x.shape[-1] == per_phase_in and cin % KC == 0 and cpad_for(cout) is not None


def fusable(x: torch.Tensor, w: Optional[torch.Tensor], act: Optional[str], *,
            mode: str) -> bool:
    """:func:`takes`, on a CUDA tensor: the gate of ``models/common.py``,
    which runs the plain composition elsewhere."""
    return x.is_cuda and takes(x, w, act, mode=mode)


def _pad_phases(t: torch.Tensor, cpad: int) -> torch.Tensor:
    """A phase-major (4 cp, ...) tensor with each phase's cp channels
    padded with zeros to cpad: the kernel's columns."""
    t = t.reshape(4, -1, *t.shape[1:])
    out = t.new_zeros((4, cpad, *t.shape[2:]))
    out[:, :t.shape[1]] = t
    return out.reshape(4 * cpad, *t.shape[2:])


def pack_plain(w: torch.Tensor, b: Optional[torch.Tensor]) -> PackedTail:
    """A 3x3 conv ``w`` (4 cp, cin, 3, 3) with phase-major output channels
    (``nn/phase.cmajor_to_phase_major``) and its phase-major bias, in the
    kernel's plain layout: [N tile][16-channel chunk][tap][half][n][8]."""
    cout, cin = w.shape[:2]
    cp = cout // 4
    cpad = cpad_for(cp)
    nt = min(4 * cpad, 128)
    groups, chunks = 4 * cpad // nt, cin // KC
    # (g, n, chunk, half, e, tap) -> (g, chunk, tap, half, n, e)
    p = _pad_phases(w.to(torch.bfloat16), cpad).reshape(groups, nt, chunks, 2, 8, 9)
    p = p.permute(0, 2, 5, 3, 1, 4)
    bias = torch.zeros(cout, device=w.device) if b is None else b.float()
    return PackedTail(p.contiguous().reshape(-1), _pad_phases(bias, cpad).contiguous(),
                      cin, cp, cpad, False)


def phase_taps(p: int) -> List[Tuple[int, int, int, int, int]]:
    """The 9 (output phase q = 2 a + c, grid row offset, grid column offset,
    dy, dx) whose HR tap (dy, dx) reads input phase p = 2 pr + pc:
    (a + dy) mod 2 = pr, (c + dx) mod 2 = pc, at grid offset
    (floor((a + dy) / 2), floor((c + dx) / 2)); by q, dy, dx, as
    ``tail_conv.cu::ph_tap`` lists them."""
    taps = []
    for q in range(4):
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                a, c = q // 2 + dy, q % 2 + dx
                if (a % 2, c % 2) == divmod(p, 2):
                    taps.append((q, a // 2, c // 2, dy, dx))
    return taps


def _kernel_block(wk: torch.Tensor) -> torch.Tensor:
    """(n, 16) weights, input channel h * 8 + e, as the kernel's B block
    [half h][n][e], flat."""
    return wk.reshape(-1, 2, 8).permute(1, 0, 2).reshape(-1)


def pack_phase(w: torch.Tensor, b: Optional[torch.Tensor]) -> PackedTail:
    """The HR conv ``w`` (cp, C, 3, 3) and its bias in the kernel's phase
    layout: per chunk (input phase p, 16 channels) one block per tap of
    :func:`phase_taps`, the tap's weights of cpad output channels."""
    cp, c = w.shape[:2]
    cpad = cpad_for(cp)
    wb = torch.zeros(cpad, c, 3, 3, dtype=torch.bfloat16, device=w.device)
    wb[:cp] = w.to(torch.bfloat16)
    blocks = [_kernel_block(wb[:, k * KC:(k + 1) * KC, dy + 1, dx + 1])
              for p in range(4) for k in range(c // KC)
              for _q, _oy, _ox, dy, dx in phase_taps(p)]
    bias = torch.zeros(cpad, device=w.device)
    if b is not None:
        bias[:cp] = b.float()
    return PackedTail(torch.cat(blocks).contiguous(), bias.repeat(4).contiguous(),
                      4 * c, cp, cpad, True)


def _round_act(v: torch.Tensor, act: Optional[str]) -> torch.Tensor:
    """One rounding to bf16, then the activation in bf16 as ``F.act``."""
    r = v.to(torch.bfloat16)
    if act in ("leakyrelu", "lrelu"):
        return torch.where(r >= 0, r, r * torch.tensor(SLOPE, dtype=torch.bfloat16))
    if act == "relu":
        return torch.relu(r)
    return r


def _shift(x: torch.Tensor, oy: int, ox: int) -> torch.Tensor:
    """x at grid offset (oy, ox) in {-1, 0, 1}^2, zeros outside."""
    _b, h, w, _c = x.shape
    xp = TF.pad(x, (0, 0, 1, 1, 1, 1))
    return xp[:, 1 + oy:1 + oy + h, 1 + ox:1 + ox + w]


def _layout(acc: torch.Tensor, packed: PackedTail, layout: str) -> torch.Tensor:
    """Accumulator columns (B, H, W, 4 cpad) -> the output layout."""
    bsz, h, w, _ = acc.shape
    cp, cpad = packed.cp, packed.cpad
    ph = acc.reshape(bsz, h, w, 4, cpad)[..., :cp]
    if layout == "phase":
        return ph.reshape(bsz, h, w, 4 * cp).contiguous()
    t = ph.reshape(bsz, h, w, 2, 2, cp).permute(0, 1, 3, 2, 4, 5)
    return t.reshape(bsz, 2 * h, 2 * w, cp).contiguous()


def emulate(x: torch.Tensor, packed: PackedTail, *, act: Optional[str],
            layout: str) -> torch.Tensor:
    """The kernel's arithmetic on any device: each chunk's packed weight
    blocks applied to the shifted input in fp32 (bf16 operands, exact
    products), the fp32 bias, one rounding, the activation in bf16, the
    output layout."""
    act = _norm_act(act)
    bsz, h, w, _ = x.shape
    xf = x.to(torch.bfloat16).float()
    ncols, cpad = 4 * packed.cpad, packed.cpad
    acc = torch.zeros(bsz, h, w, ncols, device=x.device)
    wf = packed.w.float()
    chunks = packed.cin // KC
    if packed.phase:
        blocks = wf.reshape(chunks, 9, 2, cpad, 8)
        for k in range(chunks):
            xs = xf[..., k * KC:(k + 1) * KC]
            for j, (q, oy, ox, _dy, _dx) in enumerate(phase_taps(k // (chunks // 4))):
                blk = blocks[k, j].permute(0, 2, 1).reshape(KC, cpad)
                acc[..., q * cpad:(q + 1) * cpad] += _shift(xs, oy, ox) @ blk
    else:
        nt = min(ncols, 128)
        blocks = wf.reshape(ncols // nt, chunks, 9, 2, nt, 8)
        for g in range(ncols // nt):
            for k in range(chunks):
                xs = xf[..., k * KC:(k + 1) * KC]
                for tap in range(9):
                    blk = blocks[g, k, tap].permute(0, 2, 1).reshape(KC, nt)
                    acc[..., g * nt:(g + 1) * nt] += _shift(xs, tap // 3 - 1, tap % 3 - 1) @ blk
    return _layout(_round_act(acc + packed.b, act), packed, layout)


def tail_conv(x: torch.Tensor, packed: PackedTail, *, act: Optional[str],
              layout: str) -> torch.Tensor:
    """One tail conv (:class:`PackedTail`) of the NHWC bf16 ``x`` with the
    activation ``act`` fused, written in ``layout``: "phase" (B, H, W, 4 cp)
    phase-major, or "shuffle" (B, 2 H, 2 W, cp).  A CUDA tensor launches the
    kernel (or raises); a CPU one takes :func:`emulate`.
    ``tail_conv.launches`` counts kernel launches."""
    act = _norm_act(act)
    if act not in ACTS or layout not in LAYOUTS:
        raise ValueError(f"tail_conv takes acts {sorted(map(str, ACTS))} and layouts "
                         f"{sorted(LAYOUTS)}, not {act!r} / {layout!r}")
    if x.dim() != 4 or x.shape[-1] != packed.cin or x.dtype != torch.bfloat16:
        raise ValueError(f"x must be bf16 (B, H, W, {packed.cin}); got {x.dtype} "
                         f"{tuple(x.shape)}")
    if x.device.type == "cpu":
        return emulate(x, packed, act=act, layout=layout)
    if x.device.type != "cuda":
        raise ValueError(f"tail_conv runs on CUDA or CPU tensors, not {x.device}")
    if packed.w.device != x.device or packed.w.dtype != torch.bfloat16:
        raise ValueError("packed weights do not match x's device and dtype")
    x = x.contiguous()
    if x.data_ptr() % 16:
        raise ValueError("the kernel reads 16-byte pieces: x must be 16-byte aligned")
    bsz, h, w, _ = x.shape
    cp = packed.cp
    shape = (bsz, h, w, 4 * cp) if layout == "phase" else (bsz, 2 * h, 2 * w, cp)
    out = torch.empty(shape, dtype=torch.bfloat16, device=x.device)
    from innfer_tpu_torch.ops import _build

    lib = _build.tail_conv_library()
    _build.launch(lib, "innfer_tail_conv", "tail_conv", x.device,
                  x.data_ptr(), packed.w.data_ptr(), packed.b.data_ptr(), out.data_ptr(),
                  bsz, h, w, packed.cin, 4 * packed.cpad, cp, int(packed.phase), ACTS[act],
                  LAYOUTS[layout])
    tail_conv.launches += 1
    return out


tail_conv.launches = 0
