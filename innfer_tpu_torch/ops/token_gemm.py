"""SwinIR's token linears with their epilogues on one hand-written bf16
GEMM (``csrc/token_gemm.cu``), and its plain PyTorch version.

Replaces no TPU kernel: the JAX package has no SwinIR.  ``models/swinir.py``
runs three of a Swin transformer layer's four linears on it wherever
:func:`fusable` holds: ``proj`` and ``fc2`` with the residual add,
``fc1`` with GELU.  For tokens ``x`` (..., K), the linear's weight ``w``
(N, K) and bias ``b`` (N,) in x's dtype, it computes

    y   = bf16(x w^T + b)            fp32 sums, the bias joining them, one rounding
    out = bf16(residual + y)         epilogue "residual", in fp32, one rounding
    out = bf16(gelu(y))              epilogue "gelu", the exact erf, in fp32

the rounding points of :func:`token_linear_reference` (``nn/functional.linear``
then ATen's add or GELU), so the kernel differs from it only in the order
of the GEMM's fp32 sums.  ``w`` is the weight as ``swin_layer`` packs it:
its input columns zero-padded to x's width (the attention's and the
LayerNorms' 16-byte rows), which the kernel reads as it is.

The kernel (source note in ``csrc/token_gemm.cu``): one persistent block
per SM holding the whole weight in shared memory, the tokens streamed in
64-row tiles through a TMA ring, the products on wgmma, and an epilogue in
shared memory: the residual, loaded by one bulk copy into the tile it
rewrites before one bulk copy stores it, or GELU, applied to y in 16-byte
pieces of the staged tile before TMA stores it.  Bytes bound it: at K =
184 or 360 a token's products are some 60 operations a byte, and the
epilogue spares the plain path's second pass over y.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as TF

from innfer_tpu_torch.nn import functional as F

# the (epilogue, K, N) that csrc/token_gemm.cu instantiates: SwinIR-M's proj,
# fc1 and fc2 on 184-wide rows (180 channels padded to 16 bytes)
SHAPES = frozenset({("residual", 184, 180), ("gelu", 184, 360), ("residual", 360, 180)})
TILE = 64   # tokens a tile: the kernel takes whole tiles


def takes(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, *, epilogue: str,
          residual: Optional[torch.Tensor] = None) -> bool:
    """Whether the kernel takes the linear on whatever device: bf16 tokens
    ``x`` (..., K), K % 8 == 0, a whole number of 64-token tiles, a bf16
    (N, K) ``w`` that is not tensor-parallel sharded and (N,) ``b``, an
    (epilogue, K, N) the kernel was built for, and for "residual" a bf16
    ``residual`` of shape (..., N) (for "gelu", none)."""
    if x.dim() < 2 or w.dim() != 2 or b.dim() != 1:
        return False
    k, n = x.shape[-1], w.shape[0]
    tokens = x.numel() // k if k else 0
    res_ok = (residual is None if epilogue == "gelu" else
              residual is not None and residual.dtype == torch.bfloat16
              and tuple(residual.shape) == (*x.shape[:-1], n))
    return (x.dtype == w.dtype == b.dtype == torch.bfloat16 and k % 8 == 0
            and tuple(w.shape) == (n, k) and tuple(b.shape) == (n,)
            and (epilogue, k, n) in SHAPES and tokens > 0 and tokens % TILE == 0
            and res_ok and not hasattr(w, "tp_shards"))


def fusable(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, *, epilogue: str,
            residual: Optional[torch.Tensor] = None) -> bool:
    """:func:`takes`, on a CUDA tensor: the gate of ``models/swinir.py``,
    which runs :func:`token_linear_reference` elsewhere."""
    return x.is_cuda and takes(x, w, b, epilogue=epilogue, residual=residual)


def token_linear_reference(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, *,
                           epilogue: str, residual: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """The plain version: ``nn/functional.linear`` (one bf16 GEMM with fp32
    sums, or true fp32), then ``residual + y`` or the exact GELU of y.
    Runs on any device."""
    y = F.linear(x, w, b)
    if epilogue == "residual":
        return residual + y
    if epilogue == "gelu":
        return TF.gelu(y)
    raise ValueError(f"token_linear: epilogue {epilogue!r} is not 'residual' or 'gelu'")


def token_linear(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, *, epilogue: str,
                 residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The linear ``w``, ``b`` on the tokens x with its epilogue, (..., N)
    in x's dtype.  A CUDA tensor launches the kernel (or raises where
    :func:`takes` does not hold); a CPU tensor takes
    :func:`token_linear_reference`.  ``token_linear.launches`` counts
    kernel launches."""
    kw = dict(epilogue=epilogue, residual=residual)
    if x.device.type == "cpu":
        return token_linear_reference(x, w, b, **kw)
    if x.device.type != "cuda":
        raise ValueError(f"token_linear runs on CUDA or CPU tensors, not {x.device}")
    if not takes(x, w, b, **kw):
        raise ValueError(
            f"token_linear's kernel takes bf16 tokens (..., K) in whole tiles of {TILE}, a bf16 "
            f"(N, K) weight and (N,) bias with (epilogue, K, N) one of {sorted(SHAPES)}, and for "
            f"'residual' a bf16 (..., N) residual; got {x.dtype} {tuple(x.shape)}, w {w.dtype} "
            f"{tuple(w.shape)}, b {b.dtype} {tuple(b.shape)}, epilogue {epilogue!r}, residual "
            f"{None if residual is None else (residual.dtype, tuple(residual.shape))}")
    ts = (x, w, b) if residual is None else (x, w, b, residual)
    if any(t.device != x.device for t in ts):
        raise ValueError("token_linear: x, w, b and the residual are not on one device")
    x, w, b = x.contiguous(), w.contiguous(), b.contiguous()
    res = None if residual is None else residual.contiguous()
    if any(t.data_ptr() % 16 for t in (x, w) + (() if res is None else (res,))) \
            or b.data_ptr() % 4:
        raise ValueError("the kernel copies x, w and the residual in 16-byte pieces and reads b "
                         "in pairs: align them")
    k, n = x.shape[-1], w.shape[0]
    out = torch.empty((*x.shape[:-1], n), dtype=x.dtype, device=x.device)
    from innfer_tpu_torch.ops import _build

    lib = _build.token_gemm_library()
    _build.launch(lib, "innfer_token_gemm", "token_linear", x.device, x.data_ptr(),
                  w.data_ptr(), b.data_ptr(), None if res is None else res.data_ptr(),
                  out.data_ptr(), x.numel() // k, k, n, int(epilogue == "gelu"))
    token_linear.launches += 1
    return out


token_linear.launches = 0
