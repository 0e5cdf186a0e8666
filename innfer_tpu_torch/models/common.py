"""Shared pieces of the flattened-sequential SR skeleton of RRDBNet,
SRResNet and PPON (the port's subset of ``innfer_tpu/models/common.py``):
positional indices, the upsample block, reference-semantics conv blocks
(mode CNA | NAC | CNAC, batch/instance norm, act, pad) and the output cap.

The tail runs in its plain form, nearest-up then conv at HR.  The JAX
package's exact rewrites for the TPU's matrix unit (``collapse_upconv_weight``,
``apply_phase_tail``) wait for an H100 measurement (ROADMAP.md).
"""
from __future__ import annotations

import math
from typing import List, Tuple

import torch

from innfer_tpu_torch.nn import functional as F
from innfer_tpu_torch.nn import resize as R

Params = dict


def n_upscale_blocks(upscale: int) -> Tuple[int, int]:
    """Number of upsample blocks and the per-block factor: 2^k scales use
    k blocks of 2x, scale 3 one 3x block, scale 1 none."""
    if upscale == 3:
        return 1, 3
    if upscale == 1:
        return 0, 2
    return int(math.log2(upscale)), 2


def upsample_indices(upscale: int, mode: str, start: int = 2) -> Tuple[List[int], int]:
    """Positional indices of the conv inside each upsample block, plus the
    index of the first HR conv, in the flattened Sequential layout:
    upconv block = [Upsample, Conv, Act]; pixelshuffle = [Conv, PS, Act]."""
    n_up, _factor = n_upscale_blocks(upscale)
    conv_idxs = []
    i = start
    for _ in range(n_up):
        conv_idxs.append(i + 1 if mode == "upconv" else i)
        i += 3
    return conv_idxs, i


def conv3x3(params: Params, x: torch.Tensor, key: str) -> torch.Tensor:
    return F.conv2d(x, params[f"{key}.weight"], params.get(f"{key}.bias"), padding=1)


def apply_upsample_block(params: Params, x: torch.Tensor, key: str, *,
                         mode: str, factor: int, act_type: str,
                         act_key: str = "") -> torch.Tensor:
    """One upsample block (upconv: nearest-resize + conv + act, reference
    block.py:348-361; pixelshuffle: conv + shuffle + act, block.py:333-346).
    ``act_key`` is the act submodule's prefix, for prelu/swish parameters."""
    if mode == "upconv":
        x = conv3x3(params, R.upsample_nearest(x, factor), key)
    elif mode == "pixelshuffle":
        x = F.pixel_shuffle(conv3x3(params, x, key), factor)
    else:
        raise NotImplementedError(f"upsample mode [{mode}] is not found")
    return F.act(act_type, x, params=params, key=act_key)


def warn_train_dropout(arch: str) -> None:
    """Loud note that deterministic inference diverges from the reference's
    stochastic train-mode dropout (block.py Dropout(0.5))."""
    import warnings

    warnings.warn(
        f"{arch} generator with use_dropout=True in train mode: the "
        "reference samples Dropout(0.5) stochastically; this framework "
        "is deterministic and treats dropout as identity, so outputs "
        "will differ from the reference's random draws")


def conv_block_layout(mode: str = "CNA", norm_type=None, act_type=None,
                      pad_type: str = "zero") -> List[str]:
    """Positional submodule kinds of a reference ``conv_block``
    (block.py:213-254): CNA/CNAC order [pad?, conv, norm?, act?], NAC order
    [norm?, act?, pad?, conv].  Zero padding is folded into the conv and
    'none' norm adds no module; parameterless modules still take an index."""
    mode = (mode or "CNA").upper()
    if mode not in ("CNA", "NAC", "CNAC"):
        raise NotImplementedError(f"Wrong conv mode [{mode}]")
    has_pad = pad_type not in (None, "zero")
    has_norm = norm_type not in (None, "none")
    has_act = act_type is not None
    if mode == "NAC":
        order = (("norm", has_norm), ("act", has_act), ("pad", has_pad), ("conv", True))
    else:
        order = (("pad", has_pad), ("conv", True), ("norm", has_norm), ("act", has_act))
    return [kind for kind, on in order if on]


def apply_conv_block(params: Params, x: torch.Tensor, key_of, *,
                     mode: str = "CNA", norm_type=None, act_type=None,
                     pad_type: str = "zero", padding: int = 1, stride: int = 1,
                     bn_training: bool = False, neg_slope: float = 0.2) -> torch.Tensor:
    """Apply one reference-semantics conv_block; ``key_of(i)`` maps the
    positional submodule index to its state-dict prefix."""
    for i, kind in enumerate(conv_block_layout(mode, norm_type, act_type, pad_type)):
        k = key_of(i)
        if kind == "pad":
            x = F.pad2d(x, padding, mode=pad_type)
        elif kind == "conv":
            pad = padding if pad_type in (None, "zero") else 0
            x = F.conv2d(x, params[f"{k}.weight"], params.get(f"{k}.bias"),
                         stride=stride, padding=pad)
        elif kind == "norm":
            nt = str(norm_type).lower()
            if nt == "batch":
                x = F.batch_norm(x, params[f"{k}.weight"], params[f"{k}.bias"],
                                 params.get(f"{k}.running_mean"),
                                 params.get(f"{k}.running_var"), training=bn_training)
            elif nt == "instance":
                x = F.instance_norm(x)
            else:
                raise NotImplementedError(f"normalization layer [{norm_type}] is not found")
        else:
            # NAC without norm recreates the act out of place (block.py:247-252),
            # the one inplace=False site
            inplace = not ((mode or "CNA").upper() == "NAC" and norm_type in (None, "none"))
            x = F.act(act_type, x, neg_slope=neg_slope, params=params, key=k,
                      inplace=inplace)
    return x


def _outm(x: torch.Tensor, outm) -> torch.Tensor:
    """Optional output cap (reference RRDBNet_arch.py:50-62):
    scaltanh | tanh | sigmoid | clamp | None."""
    if outm == "scaltanh":
        return (torch.tanh(x) + 1.0) / 2.0
    if outm == "tanh":
        return torch.tanh(x)
    if outm == "sigmoid":
        return torch.sigmoid(x)
    if outm == "clamp":
        return torch.clamp(x, 0.0, 1.0)
    return x
