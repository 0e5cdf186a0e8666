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

The hybrid split: ``apply_trunk`` runs CFEM, SFEM and PFEM and returns
their three 64-channel maps as one 192-channel tensor; ``apply_tail`` runs
the three reconstruction branches on a tile of it and sums them, which is
``apply``'s out_p.  Each branch is ESRGAN's x4 tail (``common.sr_tail``):
its upsample blocks LR-collapsed and its last block with the HR convs in
phase space where the predicates of ``models/common.py`` say; the three
branches are summed at full resolution.  A block runs on the hand-written
kernel of ``ops/dilated_block.py`` wherever ``dilated_block.fusable`` holds
(a bf16 CUDA tensor, nf 64, unsharded weights); elsewhere the plain
composition below runs (the CPU, fp32, tp-sharded weights).  The tracer's counters
``dilated_blocks`` (every block) and ``dilated_blocks_fused`` (those on
the kernel) say which.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from innfer_tpu_torch.models import common as C
from innfer_tpu_torch.models.base import ModelDef, cached
from innfer_tpu_torch.nn import functional as F
from innfer_tpu_torch.observability import count
from innfer_tpu_torch.ops import dilated_block as DB
from innfer_tpu_torch.ops.rdb import res_scale

_CONVS = ("c1", *(f"d{r}" for r in range(1, 9)), "c2")


def _block_params(params, prefix: str):
    return ([params.get(f"{prefix}.{n}.weight") for n in _CONVS],
            [params.get(f"{prefix}.{n}.bias") for n in _CONVS])


def _res_block_32(params, x: torch.Tensor, prefix: str,
                  res: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One block; with ``res`` (the RRBlock's input, for its last block)
    also the RRBlock's residual ``out * 0.2 + res``."""
    count("dilated_blocks", 1)
    weights, biases = _block_params(params, prefix)
    if DB.fusable(x, weights, biases):
        count("dilated_blocks_fused", 1)
        packed = cached(params, ("dilated_block", prefix, x.device),
                        lambda: DB.pack_block(weights, biases))
        return DB.fused_dilated_block(x, weights, biases, res=res, packed=packed)

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
    out = x + out2 * res_scale(x.dtype)
    return out if res is None else out * res_scale(x.dtype) + res


def _rr_block(params, x: torch.Tensor, prefix: str) -> torch.Tensor:
    out = x
    for name in ("RB1", "RB2"):
        out = _res_block_32(params, out, f"{prefix}.{name}")
    return _res_block_32(params, out, f"{prefix}.RB3", res=x)


def build(cfg: Dict[str, Any]) -> ModelDef:
    nb = cfg["nb"]
    upscale = int(cfg.get("upscale", 4))
    act_type = cfg.get("act_type", "lrelu")
    alpha = float(cfg.get("alpha", 1.0))

    def trunk(params, x: torch.Tensor):
        fea = C.conv3x3(params, x, "CFEM.0")
        t = fea
        for i in range(nb):
            t = _rr_block(params, t, f"CFEM.1.sub.{i}")
        out_cfem = fea + C.conv3x3(params, t, f"CFEM.1.sub.{nb}")
        out_sfem = out_cfem
        for i in range(2):
            out_sfem = _rr_block(params, out_sfem, f"SFEM.{i}")
        out_pfem = out_sfem
        for i in range(2):
            out_pfem = _rr_block(params, out_pfem, f"PFEM.{i}")
        return out_cfem, out_sfem, out_pfem

    def branches(params, feats):
        """(out_c, out_s, out_p) at full resolution."""

        def recon(h, mod: str):
            # [n_up x (Upsample, conv, act)] + HR0 conv + act + HR1 conv
            return C.sr_tail(params, h, mod, upscale=upscale, up_mode="upconv",
                             act_type=act_type, finalact=None, start=0)

        out_c = recon(feats[0], "CRM")
        out_s = recon(feats[1], "SRM") + out_c
        out_p = torch.tensor(alpha, dtype=feats[2].dtype) * recon(feats[2], "PRM") + out_s
        return out_c, out_s, out_p

    def apply_trunk(params, x: torch.Tensor) -> torch.Tensor:
        """CFEM, SFEM and PFEM: the whole LR-resolution part of the model
        (81% of its operations), run untiled by the hybrid engine; their
        three maps as one (B, H, W, 3 nf) tensor."""
        return torch.cat(trunk(params, x), dim=-1)

    def apply_tail(params, h: torch.Tensor) -> torch.Tensor:
        """The three branches on a tile of the trunk's maps, summed: out_p."""
        return branches(params, torch.chunk(h, 3, dim=-1))[2]

    def apply(params, x: torch.Tensor):
        return branches(params, trunk(params, x))

    return ModelDef(name="ppon", cfg=dict(cfg), apply=apply, scale=upscale,
                    apply_trunk=apply_trunk, apply_tail=apply_tail,
                    # each branch is ESRGAN's upsampling tail: 4 LR px cover it
                    tail_halo=4,
                    # at nf 64 (the block kernel's channel counts) auto goes
                    # hybrid on the card: bf16 runs the kernel, fp32 the plain
                    # composition on the whole image, exactly
                    trunk_kernel=int(cfg.get("nf", 64)) == DB.NF,
                    output_index=2)
