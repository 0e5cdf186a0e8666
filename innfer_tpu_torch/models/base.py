"""Model definition container + torch-state-dict -> port-params conversion.

The port's counterpart of ``innfer_tpu/models/base.py``.  A ModelDef is a
plain ``apply(params, x)`` function over a flat parameter dict of tensors
keyed by the torch names.  Conv weights stay OIHW, as in the checkpoint,
so the JAX package's HWIO transposes have no counterpart here, and a
Conv1d weight keeps its (O, I, 1) layout.  Nor has its ``tile_quantum``
as a tile size: the 64-multiple tile dims were a Mosaic constraint, and
the port's kernel takes any tile.  What ``tile_quantum > 1`` also said,
that the trunk runs a kernel, is ``trunk_kernel`` here.
"""
from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Any, Callable, Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

StateDict = Dict[str, Any]


class ParamDict(dict):
    """Parameter dict whose missing-key error explains the likely cause:
    an explicit arch config that does not match the checkpoint.

    ``cache`` holds derived forms of the parameters (the fused kernel's
    packed weights, the tail rewrites' weights); it belongs to this dict,
    so a cast builds its own."""

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self.cache: Dict[Any, Any] = {}

    def __missing__(self, key):
        raise KeyError(
            f"parameter '{key}' is not in the checkpoint ({len(self)} keys"
            " loaded).  The network config does not match the checkpoint —"
            " an explicit -a/--arch uses library-default hyperparameters"
            " (nb/nf/...); try arch auto-detection (-a infer, the default)"
            " or pass the exact config.")


Params = ParamDict


def cached(params: Mapping[str, Any], key: Any, build: Callable[[], Any]) -> Any:
    """``build()``, kept in ``params.cache`` under ``key``: a derived form of
    the parameters (a kernel's packed weights, a tail rewrite's weights) is
    built once per ParamDict, and ``key`` names what it depends on besides
    the parameters (a dtype, a device).  A plain dict has no cache and
    builds at every call."""
    cache = getattr(params, "cache", None)
    if cache is None:
        return build()
    if key not in cache:
        cache[key] = build()
    return cache[key]


@dataclass
class ModelDef:
    """An architecture: plain apply + conversion metadata."""

    name: str
    cfg: Dict[str, Any]
    apply: Callable[[Params, torch.Tensor], torch.Tensor]
    scale: int = 1
    # state-dict preprocessing (e.g. mesrgan -> flattened esrgan remap)
    remap: Optional[Callable[[StateDict], StateDict]] = None
    # Optional trunk/tail split for hybrid inference (whole-image trunk,
    # tiled tail): apply == apply_tail(apply_trunk).  tail_halo is the
    # tail's receptive radius in input pixels.
    apply_trunk: Optional[Callable[[Params, torch.Tensor], torch.Tensor]] = None
    apply_tail: Optional[Callable[[Params, torch.Tensor], torch.Tensor]] = None
    tail_halo: int = 0
    # the hybrid trunk's canvas for an h x w input, (rows, columns); None is
    # tiling/engine.hybrid_dims, the TPU kernel's border rule.  A trunk whose
    # receptive field spans the image (SwinIR's shifted windows) pads as
    # its published forward does instead.
    hybrid_canvas: Optional[Callable[[int, int], Tuple[int, int]]] = None
    # regex patterns (fullmatch) of >= 2-D parameters kept fp32 like the
    # biases (SwinIR's relative-position bias tables, which fp32 scores add)
    fp32_keys: Tuple[str, ...] = ()
    # regex patterns (fullmatch) of keys dropped under non-strict loading
    # (pre-0.4 InstanceNorm running stats in CycleGAN checkpoints)
    ignore_key_patterns: Tuple[str, ...] = ()
    # regex patterns of ConvTranspose2d weights and of Conv1d-as-dense
    # weights.  The port keeps their checkpoint layouts; only
    # params_from_jax needs to know them.
    transposed_keys: Tuple[str, ...] = ()
    dense_keys: Tuple[str, ...] = ()
    # multi-output models (PPON) select this output at inference
    output_index: Optional[int] = None
    # True when apply_trunk runs a port kernel on a CUDA tensor (the JAX
    # package's tile_quantum > 1): only then does TiledRunner's auto mode
    # upgrade to hybrid on the card
    trunk_kernel: bool = False


def _matches(patterns: Sequence[str], key: str) -> bool:
    return any(re.fullmatch(p, key) for p in patterns)


def _as_tensor(val) -> torch.Tensor:
    if isinstance(val, torch.Tensor):
        return val.detach()
    arr = np.asarray(val)
    if arr.dtype.name == "bfloat16":  # ml_dtypes arrays from the JAX side
        return torch.from_numpy(arr.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(arr))  # a writable copy


def convert_state(model: ModelDef, state: Mapping[str, Any], *,
                  param_dtype: torch.dtype = torch.float32,
                  device: Optional[torch.device] = None,
                  strict: bool = True) -> ParamDict:
    """A torch state dict -> this model's params on ``device``.  >=2-D
    tensors take ``param_dtype``; biases and other <=1-D tensors, and the
    model's ``fp32_keys``, stay fp32 for numerical fidelity.
    ``strict=False`` drops the keys matching the model's
    ``ignore_key_patterns`` (reference run.py:305-309)."""
    if model.remap is not None:
        state = model.remap(state)
    params = ParamDict()
    for key, val in state.items():
        if not strict and _matches(model.ignore_key_patterns, key):
            continue
        t = _as_tensor(val)
        dt = torch.float32 if t.dim() <= 1 or _matches(model.fp32_keys, key) else param_dtype
        params[key] = t.to(device=device, dtype=dt).contiguous()
    return params


def cast_params(params: Mapping[str, torch.Tensor], dtype: torch.dtype) -> ParamDict:
    """Cast all >=2-D params to ``dtype`` (biases stay fp32)."""
    return ParamDict(
        (k, v if v.dim() <= 1 else v.to(dtype)) for k, v in params.items())


def params_from_jax(params_np: Mapping[str, Any], model: Optional[ModelDef] = None,
                    *, device: Optional[torch.device] = None) -> ParamDict:
    """Carry the JAX package's parameters (numpy arrays, conv weights HWIO,
    ``innfer_tpu/models/base.py:117-126``) across into port params (OIHW),
    so both packages compute the same function in the tests; Conv3d weights
    go from DHWIO to OIDHW.

    The JAX package stores a ConvTranspose2d weight spatially flipped as
    (kh, kw, I, O) and a Conv1d weight as a dense (I, O): the keys matching
    ``model.transposed_keys`` go back to the checkpoint's (I, O, kh, kw),
    unflipped, and those matching ``model.dense_keys`` to (O, I, 1)."""
    transposed = model.transposed_keys if model is not None else ()
    dense = model.dense_keys if model is not None else ()
    params = ParamDict()
    for key, val in params_np.items():
        t = _as_tensor(val)
        if t.dim() == 4 and _matches(transposed, key):
            t = t.permute(2, 3, 0, 1).flip(2, 3)  # flipped (kh,kw,I,O) -> IOHW
        elif t.dim() == 4:
            t = t.permute(3, 2, 0, 1)  # HWIO -> OIHW
        elif t.dim() == 5:
            t = t.permute(4, 3, 0, 1, 2)  # DHWIO -> OIDHW (evsrgan's Conv3d)
        elif t.dim() == 2 and _matches(dense, key):
            t = t.t()[:, :, None]  # dense (I, O) -> Conv1d (O, I, 1)
        params[key] = t.to(device=device).contiguous()
    return params
