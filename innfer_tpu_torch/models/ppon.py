"""PPON (Progressive Perception-Oriented Network) in PyTorch, NHWC.

The port's counterpart of ``innfer_tpu/models/ppon.py`` (reference
PPON_arch.py:11-129).  Three progressive branches share a trunk:

  CFEM (fea conv + ShortcutBlock of nb RRBlocks + LR conv)
    -> CRM  = upsample chain + HR convs          -> out_c (content)
  SFEM (2 RRBlocks on CFEM features)
    -> SRM + out_c                               -> out_s (structure)
  PFEM (2 RRBlocks on SFEM features)
    -> alpha * PRM + out_s                       -> out_p (perceptual)

``apply`` returns all three; inference takes index 2 (``output_index``,
reference run.py:191-192).  Each _ResBlock_32 runs 8 parallel dilated 3x3
convs (rates 1..8) over a shared lrelu(c1(x)), sums them cascading,
concatenates, fuses with a 1x1 conv and adds with a 0.2 residual.  The
residual scales, the cascading sums and ``alpha`` work in the activation
dtype, as the JAX package's ``jnp.asarray(.., x.dtype)`` does.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from innfer_tpu_torch.models import common as C
from innfer_tpu_torch.models.base import ModelDef
from innfer_tpu_torch.nn import functional as F
from innfer_tpu_torch.ops.rdb import res_scale


def _res_block_32(params, x: torch.Tensor, prefix: str) -> torch.Tensor:
    def conv(name, t, pad, dil):
        return F.conv2d(t, params[f"{prefix}.{name}.weight"],
                        params.get(f"{prefix}.{name}.bias"), padding=pad, dilation=dil)

    h = F.leaky_relu(conv("c1", x, 1, 1), 0.2)
    acc = conv("d1", h, 1, 1)
    sums = [acc]
    for r in range(2, 9):
        acc = acc + conv(f"d{r}", h, r, r)
        sums.append(acc)
    out2 = conv("c2", F.leaky_relu(torch.cat(sums, dim=-1), 0.2), 0, 1)
    return x + out2 * res_scale(x.dtype)


def _rr_block(params, x: torch.Tensor, prefix: str) -> torch.Tensor:
    out = x
    for name in ("RB1", "RB2", "RB3"):
        out = _res_block_32(params, out, f"{prefix}.{name}")
    return out * res_scale(x.dtype) + x


def build(cfg: Dict[str, Any]) -> ModelDef:
    nb = cfg["nb"]
    upscale = int(cfg.get("upscale", 4))
    act_type = cfg.get("act_type", "lrelu")
    alpha = float(cfg.get("alpha", 1.0))

    n_up, factor = C.n_upscale_blocks(upscale)
    # recon modules: [n_up x (Upsample, conv, act)] + HR0 conv + act + HR1 conv
    up_convs = [3 * i + 1 for i in range(n_up)]
    hr0 = 3 * n_up

    def recon(params, x, mod: str):
        h = x
        for ci in up_convs:
            h = C.apply_upsample_block(params, h, f"{mod}.{ci}", mode="upconv",
                                       factor=factor, act_type=act_type)
        return C.apply_hr_convs(params, h, mod, hr0, act_type)

    def apply(params, x: torch.Tensor):
        fea = C.conv3x3(params, x, "CFEM.0")
        t = fea
        for i in range(nb):
            t = _rr_block(params, t, f"CFEM.1.sub.{i}")
        out_cfem = fea + C.conv3x3(params, t, f"CFEM.1.sub.{nb}")
        out_c = recon(params, out_cfem, "CRM")

        out_sfem = out_cfem
        for i in range(2):
            out_sfem = _rr_block(params, out_sfem, f"SFEM.{i}")
        out_s = recon(params, out_sfem, "SRM") + out_c

        out_pfem = out_sfem
        for i in range(2):
            out_pfem = _rr_block(params, out_pfem, f"PFEM.{i}")
        out_p = torch.tensor(alpha, dtype=x.dtype) * recon(params, out_pfem, "PRM") + out_s
        return out_c, out_s, out_p

    return ModelDef(name="ppon", cfg=dict(cfg), apply=apply, scale=upscale,
                    output_index=2)
