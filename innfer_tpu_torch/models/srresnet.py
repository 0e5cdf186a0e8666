"""SRResNet (the SRGAN generator) in PyTorch, NHWC.

The port's counterpart of ``innfer_tpu/models/srresnet.py`` (reference
SRResNet_arch.py:15-91): the flattened-sequential skeleton of RRDBNet with
ResNetBlocks in the trunk, whose two conv_blocks follow the configured
mode:

  CNA  : conv0 = [conv, norm?, act], conv1 = [conv, norm?]   (act cleared)
  CNAC : conv0 = [conv, norm?, act], conv1 = [conv]          (act+norm cleared)
  NAC  : conv0 = [norm?, act, conv], conv1 = [norm?, act, conv]

``self.res = B.sequential(conv0, conv1)`` flattens both blocks' children
into one positional list (keys ``model.1.sub.<i>.res.<j>``).  The residual
scale multiplies in the activation dtype, as the JAX package's
``jnp.asarray(res_scale, x.dtype)``.  The tail takes ESRGAN's structure
(``innfer_tpu/models/srresnet.py:82-101``): the last pixelshuffle block
and the HR convs in phase space where ``models/common.phase_tail_ok``
says (``common.sr_tail``).  The trunk runs no port kernel, so auto tiling stays on the tile
grid.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from innfer_tpu_torch.models import common as C
from innfer_tpu_torch.models.base import ModelDef
from innfer_tpu_torch.models.common import _outm


def build(cfg: Dict[str, Any]) -> ModelDef:
    nb = cfg["nb"]
    upscale = int(cfg.get("upscale", 4))
    act_type = cfg.get("act_type", "relu")
    up_mode = cfg.get("upsample_mode", "pixelshuffle")
    res_scale = float(cfg.get("res_scale", 1))
    finalact = cfg.get("finalact")
    outm = cfg.get("outm")
    norm_type = cfg.get("norm_type")
    if norm_type == "none":
        norm_type = None
    conv_mode = (cfg.get("mode") or "CNA").upper()
    if norm_type not in (None, "batch", "instance"):
        raise NotImplementedError(f"normalization layer [{norm_type}] is not found")
    if conv_mode not in ("CNA", "NAC", "CNAC"):
        raise NotImplementedError(f"Wrong conv mode [{conv_mode}]")

    # ResNetBlock: conv1's act is cleared under CNA, act+norm under CNAC
    # (SRResNet_arch.py:73-78)
    c1_act = act_type if conv_mode == "NAC" else None
    c1_norm = None if conv_mode == "CNAC" else norm_type
    len0 = len(C.conv_block_layout(conv_mode, norm_type, act_type))

    def res_block(params, x, prefix):
        h = C.apply_conv_block(params, x, lambda j: f"{prefix}.res.{j}", mode=conv_mode,
                               norm_type=norm_type, act_type=act_type)
        h = C.apply_conv_block(params, h, lambda j: f"{prefix}.res.{len0 + j}",
                               mode=conv_mode, norm_type=c1_norm, act_type=c1_act)
        return x + h * torch.tensor(res_scale, dtype=x.dtype)

    def apply_trunk(params, x: torch.Tensor) -> torch.Tensor:
        """fea conv -> nb ResNetBlocks -> LR conv -> shortcut sum (the
        LR-resolution bulk), split out for hybrid inference."""
        fea = C.conv3x3(params, x, "model.0")
        t = fea
        for i in range(nb):
            t = res_block(params, t, f"model.1.sub.{i}")
        t = C.apply_conv_block(params, t, lambda j: f"model.1.sub.{nb + j}",
                               mode=conv_mode, norm_type=norm_type, act_type=None)
        return fea + t

    def apply_tail(params, h: torch.Tensor) -> torch.Tensor:
        return _outm(C.sr_tail(params, h, "model", upscale=upscale, up_mode=up_mode,
                               act_type=act_type, finalact=finalact), outm)

    def apply(params, x: torch.Tensor) -> torch.Tensor:
        return apply_tail(params, apply_trunk(params, x))

    return ModelDef(name="sr_resnet", cfg=dict(cfg), apply=apply, scale=upscale,
                    apply_trunk=apply_trunk, apply_tail=apply_tail, tail_halo=4)
