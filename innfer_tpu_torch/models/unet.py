"""pix2pix UNet generator in PyTorch, NHWC.

The port's counterpart of ``innfer_tpu/models/unet.py`` (reference
UNet_arch.py:11-161).  The reference builds the UNet recursively, innermost
out; here an explicit level list (0 = outermost .. L-1 = innermost)
reproduces its state-dict keys:

  prefix(0)   = 'model.model'
  prefix(l+1) = prefix(l) + ('.1.model' if l == 0 else '.3.model')

  Sequential indices of a level:
    outermost: [downconv(0), sub(1), uprelu(2), upconv(3), Tanh(4)]
    middle:    [downrelu(0), downconv(1), downnorm(2), sub(3),
                uprelu(4), upconv(5), upnorm(6), (dropout)]
    innermost: [downrelu(0), downconv(1), uprelu(2), upconv(3), upnorm(4)]

Each level but the outermost concatenates its input with its output on
the channels.  The down convs are k4 s2 p1; the up path is a k4 s2 p1
ConvTranspose2d ('deconv') or nearest-2x + 3x3 conv ('upconv').  pix2pix
runs with ``meval=False``: train-mode BatchNorm with per-image statistics
(``nn/functional.batch_norm``), as the reference keeps the net in train().
Dropout is identity (warned about in train mode).
"""
from __future__ import annotations

import re
from typing import Any, Dict, List

import torch

from innfer_tpu_torch.models import common as C
from innfer_tpu_torch.models.base import ModelDef
from innfer_tpu_torch.nn import functional as F
from innfer_tpu_torch.nn import resize as R


def build(cfg: Dict[str, Any]) -> ModelDef:
    num_downs = int(cfg.get("num_downs", 8))
    norm_type = cfg.get("norm_type", "batch")
    upsample_mode = cfg.get("upsample_mode", "deconv")
    meval = bool(cfg.get("meval", False))  # the pix2pix preset: train-mode BN
    if bool(cfg.get("use_dropout", False)) and not meval:
        C.warn_train_dropout("unet")
    if norm_type in ("BN", "batch"):
        is_instance = False
    elif norm_type in ("IN", "instance"):
        is_instance = True
    else:
        raise NotImplementedError(f"Unknown norm layer [{norm_type}]")

    prefixes: List[str] = []
    pre = "model.model"
    for level in range(num_downs):
        prefixes.append(pre)
        pre += ".1.model" if level == 0 else ".3.model"

    def norm(params, x, key):
        if is_instance:
            return F.instance_norm(x)
        return F.batch_norm(
            x, params[f"{key}.weight"], params[f"{key}.bias"],
            params.get(f"{key}.running_mean"), params.get(f"{key}.running_var"),
            training=not meval)

    def down_conv(params, x, key):
        return F.conv2d(x, params[f"{key}.weight"], params.get(f"{key}.bias"),
                        stride=2, padding=1)

    def up_conv(params, x, key):
        if upsample_mode == "deconv":
            return F.conv_transpose2d(x, params[f"{key}.weight"], params.get(f"{key}.bias"),
                                      stride=2, padding=1)
        # 'upconv': Sequential(Upsample nearest 2x, conv3x3) at one index
        return F.conv2d(R.upsample_nearest(x, 2), params[f"{key}.1.weight"],
                        params.get(f"{key}.1.bias"), padding=1)

    def block(params, x: torch.Tensor, level: int) -> torch.Tensor:
        p = prefixes[level]
        if level == 0:
            h = block(params, down_conv(params, x, f"{p}.0"), 1)
            return F.tanh(up_conv(params, F.relu(h), f"{p}.3"))
        h = down_conv(params, F.leaky_relu(x, 0.2), f"{p}.1")
        if level == num_downs - 1:  # innermost
            h = norm(params, up_conv(params, F.relu(h), f"{p}.3"), f"{p}.4")
        else:
            h = block(params, norm(params, h, f"{p}.2"), level + 1)
            h = norm(params, up_conv(params, F.relu(h), f"{p}.5"), f"{p}.6")
        return torch.cat([x, h], dim=-1)

    def apply(params, x: torch.Tensor) -> torch.Tensor:
        return block(params, x, 0)

    transposed = ()
    if upsample_mode == "deconv":
        transposed = tuple(rf"{re.escape(p)}\.{3 if lv in (0, num_downs - 1) else 5}\.weight"
                           for lv, p in enumerate(prefixes))
    return ModelDef(
        name="unet_net",
        cfg=dict(cfg),
        apply=apply,
        scale=1,
        transposed_keys=transposed,
        ignore_key_patterns=(r".*num_batches_tracked",),
    )
