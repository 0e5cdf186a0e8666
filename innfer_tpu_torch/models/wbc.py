"""White-Box Cartoonization UNet generator in PyTorch, NHWC.

The port's counterpart of ``innfer_tpu/models/wbc.py`` (reference
WBCNet_arch.py:24-143).  A 1x image-to-image net: k7 nf conv -> two
stride-2 conv blocks -> four plain residual blocks -> convs with two
2x-upsample ADDITIVE skips (x3 + x1, x4 + x0) -> k7 3-channel output, no
final activation.

``mode`` picks the conv and upsample flavour of the checkpoint:
  'pt': stride-2 convs pad 1; 2x bilinear upsample, align_corners=False;
  'tf': stride-2 convs pad 0 after TF's asymmetric SAME padding
        (``nn/functional.tf_same_padding``), and TF's 2x bilinear
        (``nn/resize.tf_2x_bilinear``).
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from innfer_tpu_torch.models.base import ModelDef
from innfer_tpu_torch.nn import functional as F
from innfer_tpu_torch.nn import resize as R


def build(cfg: Dict[str, Any]) -> ModelDef:
    mode = cfg.get("mode", "pt")
    slope = float(cfg.get("slope", 0.2))

    def conv(params, x, key, *, k=3, stride=1, pad=None):
        pad = (k - 1) // 2 if pad is None else pad
        return F.conv2d(x, params[f"{key}.weight"], params.get(f"{key}.bias"),
                        stride=stride, padding=pad)

    def strided(params, x, key):
        if mode == "tf":
            return conv(params, F.tf_same_padding(x, 3), key, stride=2, pad=0)
        return conv(params, x, key, stride=2, pad=1)

    def upsample(x):
        if mode == "tf":
            return R.tf_2x_bilinear(x)
        return R.interpolate(x, scale_factor=2.0, mode="bilinear", align_corners=False)

    def res_block(params, x, prefix):
        h = F.leaky_relu(conv(params, x, f"{prefix}.conv1"), 0.2)
        return conv(params, h, f"{prefix}.conv2") + x

    def lr(t):
        return F.leaky_relu(t, slope)

    def apply(params, x: torch.Tensor) -> torch.Tensor:
        x0 = lr(conv(params, x, "conv", k=7))
        x1 = lr(strided(params, x0, "conv_1"))
        x1 = lr(conv(params, x1, "conv_2"))
        x2 = lr(strided(params, x1, "conv_3"))
        x2 = lr(conv(params, x2, "conv_4"))
        for i in range(4):
            x2 = res_block(params, x2, f"block_{i}")
        x2 = lr(conv(params, x2, "conv_5"))
        x3 = lr(conv(params, upsample(x2) + x1, "conv_6"))
        x3 = lr(conv(params, x3, "conv_7"))
        x4 = lr(conv(params, upsample(x3) + x0, "conv_8"))
        return conv(params, x4, "conv_9", k=7)

    return ModelDef(name="wbcunet_net", cfg=dict(cfg), apply=apply, scale=1)
