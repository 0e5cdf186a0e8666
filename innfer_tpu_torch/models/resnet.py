"""CycleGAN ResNet generator in PyTorch, NHWC.

The port's counterpart of ``innfer_tpu/models/resnet.py`` (reference
ResNet_arch.py:11-151, library defaults instance norm, reflect padding,
deconv upsampling): ReflectionPad(3) + 7x7 conv -> 2 stride-2 downs ->
n_blocks residual blocks -> 2 upsamplings -> ReflectionPad(3) + 7x7 conv
-> Tanh.

A residual block runs on the fused CUDA ResnetBlock (ops/resnet_block.py)
wherever ``resnet_block.fusable`` holds (a CUDA tensor, instance norm,
reflect padding, the shapes the kernel covers; dropout is identity at
inference), else on the plain composition: pad, cuDNN conv, instance norm,
ReLU, pad, conv, norm, add.  With instance norm, the five plain convs
around the blocks (the 7x7 head, the two downs, the two ups) hand their
fp32 accumulator to the norm + ReLU, which runs on the hand-written kernel
of ops/instance_norm.py wherever ``instance_norm.fusable`` holds (a CUDA
accumulator of a bf16 model) and else rounds it to the activation dtype,
as the conv would have, before the plain norm.  The tracer's counters
``norms`` (each of those norms) and ``norms_fused`` (those on the kernel)
say which.

Pre-0.4 InstanceNorm checkpoints carry running_mean/running_var keys that
inference ignores; non-strict loading drops them (``ignore_key_patterns``,
reference run.py:305-309, ResNet_arch.py:33-36).
"""
from __future__ import annotations

from functools import partial
from typing import Any, Dict

import torch

from innfer_tpu_torch.models import common as C
from innfer_tpu_torch.models.base import ModelDef, cached
from innfer_tpu_torch.nn import functional as F
from innfer_tpu_torch.nn import resize as R
from innfer_tpu_torch.observability import count
from innfer_tpu_torch.ops import instance_norm as IN
from innfer_tpu_torch.ops import resnet_block as RB
from innfer_tpu_torch.ops.resnet_block import fused_resnet_block, pack_resnet_block

_PAD_MODES = ("reflect", "replicate", "zero")


def build(cfg: Dict[str, Any]) -> ModelDef:
    n_blocks = int(cfg.get("n_blocks", 9))
    norm_type = cfg.get("norm_type", "instance")
    pad_type = cfg.get("padding_type", "reflect")
    upsample_mode = cfg.get("upsample_mode", "deconv")
    if norm_type in ("IN", "instance"):
        is_instance = True
    elif norm_type in ("BN", "batch"):
        is_instance = False
    else:
        raise NotImplementedError(f"norm [{norm_type}] for resnet generator")
    if pad_type not in _PAD_MODES:
        raise NotImplementedError(f"padding [{pad_type}] is not implemented")

    # train-mode BN for presets that keep the net in train() (reference
    # run.py:299-309); dropout is identity here either way
    meval = bool(cfg.get("meval", True))
    use_dropout = bool(cfg.get("use_dropout", False))
    if use_dropout and not meval:
        C.warn_train_dropout("resnet")

    def norm(params, x, key):
        if is_instance:
            return F.instance_norm(x)
        return F.batch_norm(
            x, params[f"{key}.weight"], params[f"{key}.bias"],
            params.get(f"{key}.running_mean"), params.get(f"{key}.running_var"),
            training=not meval)

    def conv(params, x, key, *, stride=1, pad=0, out_dtype=None):
        return F.conv2d(x, params[f"{key}.weight"], params.get(f"{key}.bias"),
                        stride=stride, padding=pad, out_dtype=out_dtype)

    def norm_relu(params, layer, dtype, key):
        """ReLU(norm(layer())) for a plain conv ``layer`` (which takes
        ``out_dtype``) of activation dtype ``dtype``."""
        if not is_instance:
            return F.relu(norm(params, layer(), key))
        count("norms", 1)
        acc = layer(out_dtype=torch.promote_types(dtype, torch.float32))
        if IN.fusable(acc, dtype=dtype):
            count("norms_fused", 1)
            return IN.fused_instance_norm(acc, out_dtype=dtype)
        return F.relu(F.instance_norm(acc.to(dtype)))

    # conv_block indices depend on padding_type ('zero' has no pad modules)
    # and use_dropout (Dropout after the first ReLU shifts the second half)
    has_pad = pad_type != "zero"
    i_conv1 = 1 if has_pad else 0
    i_conv2 = i_conv1 + 3 + int(use_dropout) + int(has_pad)

    def res_block(params, x, prefix):
        k1 = f"{prefix}.conv_block.{i_conv1}"
        k2 = f"{prefix}.conv_block.{i_conv2}"
        w1, b1 = params[f"{k1}.weight"], params.get(f"{k1}.bias")
        w2, b2 = params[f"{k2}.weight"], params.get(f"{k2}.bias")
        if RB.fusable(x, w1, w2, norm_type=norm_type, pad_type=pad_type):
            packed = cached(params, ("resnet_block", k1, x.dtype, x.device),
                            lambda: pack_resnet_block(w1, b1, w2, b2, x.dtype))
            return fused_resnet_block(x.contiguous(), w1, b1, w2, b2, packed=packed)
        p = 0 if has_pad else 1
        h = F.pad2d(x, 1, mode=pad_type) if has_pad else x
        h = F.relu(norm(params, conv(params, h, k1, pad=p), f"{prefix}.conv_block.{i_conv1 + 1}"))
        if has_pad:
            h = F.pad2d(h, 1, mode=pad_type)
        h = norm(params, conv(params, h, k2, pad=p), f"{prefix}.conv_block.{i_conv2 + 1}")
        return x + h

    # flattened Sequential indices
    i_up0 = 10 + n_blocks
    i_up1 = i_up0 + 3
    i_out = i_up1 + 4  # pad at i_up1+3, conv at +4

    def upsample(params, x, idx, *, out_dtype=None):
        if upsample_mode == "deconv":
            return F.conv_transpose2d(
                x, params[f"model.{idx}.weight"], params.get(f"model.{idx}.bias"),
                stride=2, padding=1, output_padding=1, out_dtype=out_dtype)
        # 'upconv': Sequential(Upsample, conv) -> conv key at .1
        return F.conv2d(R.upsample_nearest(x, 2), params[f"model.{idx}.1.weight"],
                        params.get(f"model.{idx}.1.bias"), padding=1, out_dtype=out_dtype)

    def apply(params, x: torch.Tensor) -> torch.Tensor:
        # the outer ReflectionPad2d(3) is reflect whatever padding_type says
        # (ResNet_arch.py:53,85)
        h = norm_relu(params, partial(conv, params, F.pad2d(x, 3, mode="reflect"), "model.1"),
                      x.dtype, "model.2")
        for idx in (4, 7):
            h = norm_relu(params, partial(conv, params, h, f"model.{idx}", stride=2, pad=1),
                          h.dtype, f"model.{idx + 1}")
        for i in range(n_blocks):
            h = res_block(params, h, f"model.{10 + i}")
        for idx in (i_up0, i_up1):
            h = norm_relu(params, partial(upsample, params, h, idx), h.dtype, f"model.{idx + 1}")
        h = conv(params, F.pad2d(h, 3, mode="reflect"), f"model.{i_out}")
        return F.tanh(h)

    transposed = ()
    if upsample_mode == "deconv":
        transposed = (rf"model\.{i_up0}\.weight", rf"model\.{i_up1}\.weight")
    return ModelDef(
        name="resnet_net",
        cfg=dict(cfg),
        apply=apply,
        scale=1,
        transposed_keys=transposed,
        # running stats are vestigial only for instance norm; batch-norm
        # generators need them in eval
        ignore_key_patterns=(
            (r".*running_(mean|var)", r".*num_batches_tracked")
            if is_instance else (r".*num_batches_tracked",)),
    )
