"""Fused Residual Dense Block (RDB_5C): the hand-written CUDA kernel
(``csrc/rdb.cu`` on the TMA conv core ``csrc/conv3x3_tma.cuh``: bf16 on
the tensor cores, fp32 on the FP32 pipes) and its plain PyTorch version.
``models/rrdb.py`` runs an RDB on it wherever :func:`fusable` holds.

Replaces ``innfer_tpu/ops/pallas/rdb.py::fused_rdb``.  One RDB computes

    x_c = LReLU0.2(conv3x3(cat(x, x1..x_{c-1})) + b_c)     c = 1..4, gc ch.
    x5  = conv3x3(cat(x, x1..x4)) + b5                      nf ch.
    out = x5 * 0.2 + x

with the ESRGAN+ ``plus`` cross-residuals x2 += conv1x1(x) and x4 += x2
after activation.  Accumulation is fp32; each x_c is rounded to the
activation dtype once, the plus adds happen in the activation dtype, and
the output is cast(fp32(x5) * 0.2 + fp32(x)) -- the Pallas kernel's
rounding points (rdb.py:242-292), which both versions here share.

Layouts follow the JAX package: x is NHWC (B, H, W, nf); weights stay
OIHW as in the checkpoint: weights[c] (gc | nf, nf + c*gc, 3, 3),
conv1x1_w (gc, nf, 1, 1); biases are fp32.

Chain mode replaces ``rdb.py::fused_rdb_padded`` and ``fused_rrdb_trunk``:
:func:`fused_rdb_padded` runs one RDB whose input is the x-slice of a
persistent (B, H, W, nf + 4*gc) workspace and writes into the x-slice of
another, optionally with the RRDB residual fused into the write
(``cast(rdb * s + res)``, s = 0.2 in the activation dtype, as
``rdb.py:304``); :func:`fused_rrdb_trunk` carries a whole nb x RRDB trunk
on three workspaces.  The TPU version's zero-margined 128-lane layout was
Mosaic's need; the function is kept, not the layout.
"""
from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence

import torch
import torch.nn.functional as TF

from innfer_tpu_torch.nn.functional import nchw_to_nhwc, nhwc_to_nchw, true_fp32
from innfer_tpu_torch.ops.conv3x3 import pack_conv3x3

NEG_SLOPE = 0.2
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def res_scale(dtype: torch.dtype) -> torch.Tensor:
    """The 0.2 of an RDB or RRDB residual as a 0-d tensor of the activation
    dtype, as the JAX package's ``jnp.asarray(0.2, x.dtype)``: in bf16 it
    is bf16(0.2) = 0.2001953125 and ``t * s + x`` rounds after each op.  A
    Python 0.2 would multiply in fp32 by 0.2f instead."""
    return torch.tensor(0.2, dtype=dtype)


class PackedRDB(NamedTuple):
    """Kernel-layout parameters of one RDB: the five conv weights in the
    packed layout of ``ops/conv3x3.py`` back to back (bf16 in the TMA
    conv's column order), the biases back to back (fp32), and the conv1x1
    weights as [nf][gc] (None without plus)."""

    w: torch.Tensor
    b: torch.Tensor
    w1: Optional[torch.Tensor]


def pack_rdb(weights: Sequence[torch.Tensor], biases: Sequence[torch.Tensor],
             conv1x1_w: Optional[torch.Tensor], dtype: torch.dtype) -> PackedRDB:
    """bf16 packs for the TMA conv (columns in ``tma_channels`` order), fp32
    for the FFMA conv (plain order)."""
    w = torch.cat([pack_conv3x3(wc, dtype, tma=dtype == torch.bfloat16) for wc in weights])
    b = torch.cat([bc.to(torch.float32).reshape(-1) for bc in biases])
    w1 = None
    if conv1x1_w is not None:
        w1 = conv1x1_w.to(dtype)[:, :, 0, 0].t().contiguous()
    return PackedRDB(w.contiguous(), b.contiguous(), w1)


def config_ok(act_type: Optional[str], norm_type: Optional[str]) -> bool:
    """Whether the kernel computes an RDB of this configuration: LeakyReLU
    and no norm layers (prelu/swish and norm layers take the plain path,
    as they take XLA's in the JAX package)."""
    return act_type in ("leakyrelu", "lrelu") and norm_type in (None, "none")


def takes(x: torch.Tensor, weights: Sequence[torch.Tensor],
          biases: Sequence[Optional[torch.Tensor]], *, act_type: Optional[str],
          norm_type: Optional[str]) -> bool:
    """Whether the kernel takes the RDB of ``x`` (NHWC) on whatever device:
    fp32 or bf16, five biased convs and :func:`config_ok`."""
    return (x.dim() == 4 and x.dtype in _DTYPE_CODE and config_ok(act_type, norm_type)
            and len(weights) == len(biases) == 5 and all(b is not None for b in biases))


def fusable(x: torch.Tensor, weights: Sequence[torch.Tensor],
            biases: Sequence[Optional[torch.Tensor]], *, act_type: Optional[str],
            norm_type: Optional[str]) -> bool:
    """:func:`takes`, on a CUDA tensor: the gate of ``models/rrdb.py``,
    which runs the plain gather form elsewhere (a 5-D Conv3D clip too)."""
    return x.is_cuda and takes(x, weights, biases, act_type=act_type, norm_type=norm_type)


def _check(x, weights, biases, plus, conv1x1_w, contiguous=True):
    if x.dim() != 4:
        raise ValueError(f"x must be (B, H, W, nf); got shape {tuple(x.shape)}")
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"fused_rdb supports float32 and bfloat16, not {x.dtype}")
    if contiguous and not x.is_contiguous():
        raise ValueError("fused_rdb needs a contiguous NHWC x")
    if len(weights) != 5 or len(biases) != 5:
        raise ValueError("an RDB has five convs: pass five weights and five biases")
    nf = x.shape[-1]
    gc = weights[0].shape[0]
    if nf % 8 or gc % 8:
        raise ValueError(f"fused_rdb needs nf % 8 == 0 and gc % 8 == 0; got nf={nf}, gc={gc}")
    for c, (w, b) in enumerate(zip(weights, biases)):
        want = (gc if c < 4 else nf, nf + c * gc, 3, 3)
        if tuple(w.shape) != want or b is None or tuple(b.shape) != want[:1]:
            raise ValueError(f"conv{c + 1}: weight {tuple(w.shape)} / bias "
                             f"{None if b is None else tuple(b.shape)}; expected "
                             f"weight {want}, bias {want[:1]}")
        if w.device != x.device or b.device != x.device:
            raise ValueError(f"conv{c + 1} parameters are on {w.device}, x on {x.device}")
    if plus:
        if conv1x1_w is None or tuple(conv1x1_w.shape) != (gc, nf, 1, 1):
            raise ValueError(f"plus needs conv1x1_w of shape {(gc, nf, 1, 1)}")
        if conv1x1_w.device != x.device:
            raise ValueError("conv1x1_w must be on x's device")
    return nf, gc


def rdb_reference(x: torch.Tensor, weights: Sequence[torch.Tensor],
                  biases: Sequence[torch.Tensor], *, plus: bool = False,
                  conv1x1_w: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The plain version: PyTorch convs on ``cat`` of the growing feature
    list, in true fp32 (products of bf16 operands are exact in fp32), with
    the kernel's rounding points.  Runs on any device."""
    dt = x.dtype
    rnd = lambda t: t.to(dt).float()  # noqa: E731  (round through the act dtype)
    feats: List[torch.Tensor] = [nhwc_to_nchw(x).float()]
    x2 = None
    with true_fp32(torch.float32):
        for c in range(4):
            acc = TF.conv2d(torch.cat(feats, 1), weights[c].to(dt).float(),
                            biases[c].float(), padding=1)
            a = rnd(torch.where(acc >= 0, acc, acc * NEG_SLOPE))
            if plus and c == 1:
                a = rnd(a + rnd(TF.conv2d(feats[0], conv1x1_w.to(dt).float())))
                x2 = a
            if plus and c == 3:
                a = rnd(a + x2)
            feats.append(a)
        acc = TF.conv2d(torch.cat(feats, 1), weights[4].to(dt).float(),
                        biases[4].float(), padding=1)
    out = (acc * NEG_SLOPE + feats[0]).to(dt)
    return nchw_to_nhwc(out).contiguous()


def fused_rdb(x: torch.Tensor, weights: Sequence[torch.Tensor],
              biases: Sequence[torch.Tensor], *, plus: bool = False,
              conv1x1_w: Optional[torch.Tensor] = None,
              packed: Optional[PackedRDB] = None) -> torch.Tensor:
    """One RDB forward.  A CUDA tensor launches the kernel (or raises); a
    CPU tensor takes :func:`rdb_reference`.  ``packed`` is the kernel
    layout from :func:`pack_rdb`, cached by the caller per parameter set.
    ``fused_rdb.launches`` counts kernel launches."""
    nf, gc = _check(x, weights, biases, plus, conv1x1_w)
    if x.device.type == "cpu":
        return rdb_reference(x, weights, biases, plus=plus, conv1x1_w=conv1x1_w)
    if x.device.type != "cuda":
        raise ValueError(f"fused_rdb runs on CUDA or CPU tensors, not {x.device}")
    packed = _packed_for(x, weights, biases, plus, conv1x1_w, packed)
    from innfer_tpu_torch.ops import _build

    lib = _build.rdb_library()
    b, h, w, _ = x.shape
    ws = torch.empty((b, h, w, nf + 4 * gc), dtype=x.dtype, device=x.device)
    out = torch.empty_like(x)
    w1 = packed.w1.data_ptr() if (plus and packed.w1 is not None) else None
    _build.launch(lib, "innfer_rdb_forward", "fused_rdb", x.device,
                  x.data_ptr(), ws.data_ptr(), out.data_ptr(), packed.w.data_ptr(),
                  packed.b.data_ptr(), w1, b, h, w, nf, gc, int(plus), _DTYPE_CODE[x.dtype])
    fused_rdb.launches += 1
    return out


fused_rdb.launches = 0


def _packed_for(x, weights, biases, plus, conv1x1_w, packed):
    if packed is None:
        packed = pack_rdb(weights, biases, conv1x1_w if plus else None, x.dtype)
    if packed.w.dtype != x.dtype or packed.w.device != x.device:
        raise ValueError("packed weights do not match x's dtype and device")
    if x.data_ptr() % 16:
        raise ValueError("the kernel stages 16-byte pieces: x must be 16-byte aligned")
    return packed


def rdb_padded_reference(ws: torch.Tensor, weights: Sequence[torch.Tensor],
                         biases: Sequence[torch.Tensor], out_ws: torch.Tensor, *,
                         res: Optional[torch.Tensor] = None, plus: bool = False,
                         conv1x1_w: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The plain version of :func:`fused_rdb_padded`: :func:`rdb_reference`
    on the x-slice of ``ws``, then ``y * s + res`` in the activation dtype,
    written into the x-slice of ``out_ws`` (in place; the other slices of
    both workspaces are left as they are)."""
    nf = weights[0].shape[1]
    y = rdb_reference(ws[..., :nf].contiguous(), weights, biases, plus=plus,
                      conv1x1_w=conv1x1_w)
    if res is not None:
        y = y * res_scale(y.dtype) + res[..., :nf]
    out_ws[..., :nf] = y
    return out_ws


def fused_rdb_padded(ws: torch.Tensor, weights: Sequence[torch.Tensor],
                     biases: Sequence[torch.Tensor], out_ws: torch.Tensor, *,
                     res: Optional[torch.Tensor] = None, plus: bool = False,
                     conv1x1_w: Optional[torch.Tensor] = None,
                     packed: Optional[PackedRDB] = None) -> torch.Tensor:
    """One RDB in chain mode.  ``ws`` and ``out_ws`` are (B, H, W, nf +
    4*gc) workspaces: the input x is channels [0, nf) of ``ws`` (the kernel
    fills ws's other channels with x1..x4), and the output goes to channels
    [0, nf) of ``out_ws``, which must not be ``ws``.  ``res``: None, or a
    workspace whose x-slice holds the RRDB input; the output is then
    ``cast(rdb(x) * s + res)``.  ``res`` may be ``out_ws`` itself: each
    output element reads res only at its own position, in the thread that
    writes it, and no conv of this call reads ``out_ws``, so the output
    can replace the RRDB input in place.  Returns ``out_ws``.  A CUDA
    workspace launches the kernel (or raises); a CPU one takes
    :func:`rdb_padded_reference`.  ``fused_rdb_padded.launches`` counts
    kernel launches."""
    nf = weights[0].shape[1]
    _check(ws[..., :nf], weights, biases, plus, conv1x1_w, contiguous=False)
    gc = weights[0].shape[0]
    for name, t in (("ws", ws), ("out_ws", out_ws), ("res", res)):
        if t is not None and (tuple(t.shape) != (*ws.shape[:3], nf + 4 * gc)
                              or t.dtype != ws.dtype or t.device != ws.device
                              or not t.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous {ws.dtype} workspace of "
                             f"shape {(*ws.shape[:3], nf + 4 * gc)} on {ws.device}")
    if out_ws.data_ptr() == ws.data_ptr():
        raise ValueError("out_ws must not be ws: the convs read ws's halo")
    if ws.device.type == "cpu":
        return rdb_padded_reference(ws, weights, biases, out_ws, res=res, plus=plus,
                                    conv1x1_w=conv1x1_w)
    if ws.device.type != "cuda":
        raise ValueError(f"fused_rdb_padded runs on CUDA or CPU tensors, not {ws.device}")
    packed = _packed_for(ws, weights, biases, plus, conv1x1_w, packed)
    from innfer_tpu_torch.ops import _build

    lib = _build.rdb_library()
    b, h, w, _ = ws.shape
    w1 = packed.w1.data_ptr() if (plus and packed.w1 is not None) else None
    _build.launch(lib, "innfer_rdb_forward_ws", "fused_rdb_padded", ws.device,
                  ws.data_ptr(), out_ws.data_ptr(), None if res is None else res.data_ptr(),
                  packed.w.data_ptr(), packed.b.data_ptr(), w1, b, h, w, nf, gc, int(plus),
                  _DTYPE_CODE[ws.dtype], res_scale(ws.dtype).item())
    fused_rdb_padded.launches += 1
    return out_ws


fused_rdb_padded.launches = 0


def rrdb_trunk_reference(x: torch.Tensor, weights, biases, *, nb: int, nr: int = 3,
                         plus: bool = False, conv1x1_ws=None) -> torch.Tensor:
    """The plain version of :func:`fused_rrdb_trunk`: nb RRDBs, each nr
    :func:`rdb_reference` calls, then ``out * s + x`` in the activation
    dtype (reference RRDBNet_arch.py:27-43)."""
    s = res_scale(x.dtype)
    for r in range(nb):
        z = x
        for c in range(nr):
            z = rdb_reference(z, weights[r][c], biases[r][c], plus=plus,
                              conv1x1_w=conv1x1_ws[r][c] if plus else None)
        x = z * s + x
    return x


def fused_rrdb_trunk(x: torch.Tensor, weights, biases, *, nb: int, nr: int = 3,
                     gc: int = 32, plus: bool = False, conv1x1_ws=None,
                     packed=None) -> torch.Tensor:
    """The whole nb x RRDB trunk as nb*nr :func:`fused_rdb_padded` calls
    (reference RRDBNet_arch.py:27-43, 64-98).

    x: (B, H, W, nf); weights[r][c] / biases[r][c]: the five convs of RDB c
    of RRDB r (OIHW, fp32 biases); conv1x1_ws[r][c]: ESRGAN+ 1x1 weights;
    packed[r][c]: optional :func:`pack_rdb` results.  x is copied once into
    the x-slice of workspace A, which holds every RRDB's input; the RDBs of
    an RRDB alternate between workspaces P0 and P1, and the last one writes
    its residual output back over A's x-slice in place (see
    :func:`fused_rdb_padded`; with nr == 1 it writes to P0, and A and P0
    swap).  Three workspaces carry the trunk; the result is copied out once
    at the end.  A CUDA x launches kernels; a CPU x runs the same loop over
    the plain versions.  ``fused_rrdb_trunk.launches`` counts trunks run on
    the card."""
    _check(x, weights[0][0], biases[0][0], plus,
           conv1x1_ws[0][0] if plus else None)
    if weights[0][0][0].shape[0] != gc:
        raise ValueError(f"gc={gc} does not match the weights' {weights[0][0][0].shape[0]}")
    b, h, w, nf = x.shape
    a = torch.empty((b, h, w, nf + 4 * gc), dtype=x.dtype, device=x.device)
    pool = [torch.empty_like(a), torch.empty_like(a)]
    a[..., :nf] = x
    for r in range(nb):
        src = a
        for c in range(nr):
            last = c == nr - 1
            dst = a if (last and nr > 1) else pool[c % 2]
            fused_rdb_padded(src, weights[r][c], biases[r][c], dst,
                             res=a if last else None, plus=plus,
                             conv1x1_w=conv1x1_ws[r][c] if plus else None,
                             packed=None if packed is None else packed[r][c])
            src = dst
        if nr == 1:
            a, pool[0] = pool[0], a
    if x.is_cuda:
        fused_rrdb_trunk.launches += 1
    return a[..., :nf].contiguous()


fused_rrdb_trunk.launches = 0
