"""PAN (Pixel Attention Network) in PyTorch, NHWC.

The port's counterpart of ``innfer_tpu/models/pan.py`` (reference
PAN_arch.py:11-222 and the FSA block, block.py:398-473):

  conv_first -> nb x SCPA trunk (+ optional second trunk) -> trunk conv
  -> (+fea) through FSA self-attention (maxpool 4 -> SAGAN attention ->
     bicubic restore -> gamma * out + input, in fp32)
  -> pixel-attention upsample chain -> conv_last
  -> + bilinear(align_corners=True)-upscaled input residual

The attention's three 1x1 Conv1d projections are channel matmuls
(``dense``; their weights keep the checkpoint's (O, I, 1) layout, the JAX
package stores them as dense (I, O): ``dense_keys``).  The scores stay
fp32 into the softmax and both products accumulate in fp32, as the JAX
package's ``preferred_element_type=float32`` einsums (pan.py:63-67).
The N x N score matrix of an H x W input holds (H/4 * W/4)^2 fp32 values:
PAN runs on tiles, never on a whole large image.
"""
from __future__ import annotations

import math
from typing import Any, Dict

import torch

from innfer_tpu_torch.models.base import ModelDef
from innfer_tpu_torch.nn import functional as F
from innfer_tpu_torch.nn import resize as R


def _conv(params, x, key, *, k=3):
    return F.conv2d(x, params[f"{key}.weight"], params.get(f"{key}.bias"),
                    padding=(k - 1) // 2)


def _pacnv(params, x, prefix: str):
    """Pixel-attention conv: k4(k3(x) * sigmoid(k2(x)))  (PAN_arch.py:37-57)."""
    y = F.sigmoid(_conv(params, x, f"{prefix}.k2", k=1))
    return _conv(params, _conv(params, x, f"{prefix}.k3") * y, f"{prefix}.k4")


def _scpa(params, x, prefix: str):
    """Self-calibrated block with pixel attention (PAN_arch.py:59-101)."""
    a = F.leaky_relu(_conv(params, x, f"{prefix}.conv1_a", k=1), 0.2)
    b = F.leaky_relu(_conv(params, x, f"{prefix}.conv1_b", k=1), 0.2)
    a = F.leaky_relu(_conv(params, a, f"{prefix}.k1.0"), 0.2)
    b = F.leaky_relu(_pacnv(params, b, f"{prefix}.PACnv"), 0.2)
    return _conv(params, torch.cat([a, b], dim=-1), f"{prefix}.conv3", k=1) + x


def _fsa(params, x, prefix: str, *, poolsize: int = 4):
    """Flexible Self Attention: maxpool -> SAGAN attention -> bicubic
    restore -> gamma * out + input  (block.py:434-473)."""
    bsz, hh, ww, cc = x.shape
    p = F.max_pool2d(x, poolsize)
    ph, pw = p.shape[1], p.shape[2]
    flat = p.reshape(bsz, ph * pw, cc)
    f, g, h = (F.dense(flat, params[f"{prefix}.conv_{n}.weight"],
                       params[f"{prefix}.conv_{n}.bias"]) for n in "fgh")
    s = F.matmul(f, g.transpose(1, 2), out_dtype=torch.float32)
    att = F.softmax(s, dim=-1).to(x.dtype)
    out = F.matmul(att, h).reshape(bsz, ph, pw, cc)
    out = R.interpolate(out, size=(hh, ww), mode="bicubic", align_corners=False)
    gamma = params[f"{prefix}.gamma"].float()
    return (gamma * out.float() + x.float()).to(x.dtype)


def build(cfg: Dict[str, Any]) -> ModelDef:
    nb = cfg["nb"]
    scale = int(cfg.get("scale", 4))
    self_attention = bool(cfg.get("self_attention", True))
    double_scpa = bool(cfg.get("double_scpa", False))
    ups_mode = cfg.get("ups_inter_mode", "nearest")
    if ups_mode not in ("nearest", "bilinear"):
        raise NotImplementedError(f"PAN ups_inter_mode [{ups_mode}] not supported")
    if scale == 3:
        n_up, factor = 1, 3
    elif scale == 1:
        n_up, factor = 0, 2
    else:
        n_up, factor = int(math.log2(scale)), 2

    # pa_upconv quirk (PAN_arch.py:19 'upconv, att, a, HRconv, a' reuses ONE
    # act module): with one block (scale 2/3) both act positions survive;
    # with >= 2 blocks the flattening through nn.Module.children()
    # (block.py:206) dedupes it, so each block's act after HRconv vanishes
    # and blocks are 5 modules wide.  Real checkpoints embody this.
    multi = n_up >= 2
    stride_mods = 5 if multi else 6

    def pa_up(params, x, base: int):
        if ups_mode == "nearest":
            x = R.upsample_nearest(x, factor)
        else:
            # B.Upsample(mode='bilinear') leaves align_corners None: False
            x = R.interpolate(x, size=(x.shape[1] * factor, x.shape[2] * factor),
                              mode="bilinear", align_corners=False)
        x = _conv(params, x, f"upsample.{base + 1}")
        att = F.sigmoid(_conv(params, x, f"upsample.{base + 2}.conv", k=1))
        x = _conv(params, F.leaky_relu(x * att, 0.2), f"upsample.{base + 4}")
        return x if multi else F.leaky_relu(x, 0.2)

    def apply(params, x: torch.Tensor) -> torch.Tensor:
        fea = _conv(params, x, "conv_first")
        t = fea
        for i in range(nb):
            t = _scpa(params, t, f"SCPA_trunk.{i}")
        t = _conv(params, t, "trunk_conv")
        if double_scpa:
            for i in range(nb):
                t = _scpa(params, t, f"SCPA_trunk2.{i}")
            t = _conv(params, t, "trunk_conv2")
        h = fea + t
        if self_attention:
            h = _fsa(params, h, "FSA")
        for u in range(n_up):
            h = pa_up(params, h, stride_mods * u)
        out = _conv(params, h, "conv_last")
        if scale > 1:
            return out + R.interpolate(x, scale_factor=float(scale), mode="bilinear",
                                       align_corners=True)
        return out + x

    return ModelDef(name="pan_net", cfg=dict(cfg), apply=apply, scale=scale,
                    dense_keys=(r"FSA\.conv_[fgh]\.weight",))
