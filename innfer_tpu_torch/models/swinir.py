"""SwinIR in PyTorch, NHWC: the real-world x4 model (``nearest+conv``
upsampler, ``1conv`` residual connection).

Liang et al., arXiv:2108.10257; github.com/JingyunLiang/SwinIR
``models/network_swinir.py``.  The JAX package has no SwinIR.  A forward:

  (x - mean) * img_range  -> conv_first -> patch_embed.norm
    -> groups (RSTB): [Swin transformer layer] x depth, conv 3x3, + input
    -> norm -> conv_after_body, + conv_first's output
    -> conv_before_upsample + LeakyReLU(0.01)             (64 channels)
    -> ESRGAN's x4 tail (``common.sr_tail``: nearest x2 + conv twice, HR
       conv, conv_last, LeakyReLU 0.2) -> / img_range + mean

Each Swin transformer layer keeps the published order, ``x = x +
proj(attn(LN1(x)))`` then ``x = x + fc2(GELU(fc1(LN2(x))))``, its
attention over windows of ``window_size``, cyclically shifted by half a
window in every second layer.  The tokens stay in image layout (B, H, W,
C): LayerNorm and the linears act per token, and the attention of
``ops/window_attn.py`` reads the qkv projection where it lies, so no roll,
partition or reverse is copied.  It runs on the hand-written kernel
wherever ``window_attn.fusable`` holds (bf16 on the card, window 8, heads
of at most 32 channels), elsewhere the plain version; the tracer's
counters ``window_attns`` (every layer's attention) and
``window_attns_fused`` (those on the kernel) say which.  ``proj``,
``fc1`` and ``fc2`` run with the residual add or GELU in their epilogue on
``ops/token_gemm.py``'s kernel wherever ``token_gemm.fusable`` holds (bf16
on the card, at the widths it was built for), elsewhere as the plain
linear and the add or GELU; counters ``swin_linears`` (three a layer) and
``swin_linears_fused``.  ``qkv`` stays a plain GEMM.  The relative
position bias of a layer is gathered once per parameter dict into a
(heads, 64, 64) fp32 tensor, and the shift mask is made for the canvas at
hand, as ``calculate_mask(x_size)`` does: the checkpoint's
``relative_position_index`` and ``attn_mask`` buffers are dropped at load
(``checkpoint/remaps.swinir_to_seq``, which also renames the tail's convs
to ``tail.<i>``).

Rounding (bf16): the linears are bf16 GEMMs with fp32 sums, each rounded
once with its bias, which joins the sum as bf16 (``nn/functional.linear``:
the one departure from the conv route, whose fp32 bias joins the fp32
sum); LayerNorm takes fp32 statistics and its fp32 affine
(``ops/layer_norm.py``, on its kernel where ``layer_norm.fusable`` holds),
GELU the exact erf in fp32, each rounded once; residual sums round once in
bf16; the convs take the bias route.

The hybrid split: ``apply_trunk`` runs everything up to the 64-channel map,
on the whole image padded (reflected) to the next multiple of the window,
which is the published ``check_image_size`` and the engine's canvas for
this model (``hybrid_canvas``): a shifted-window trunk's receptive field
spans the image, so another canvas would change the output far from its
border.  ``apply_tail`` is the SR tail on a tile of that map.  Refused by
name: the ``pixelshuffle``, ``pixelshuffledirect`` (the 60-wide
lightweight model) and ``""`` (denoising, JPEG) upsamplers, and the
``3conv`` residual connection.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as TF

from innfer_tpu_torch.checkpoint.remaps import swinir_to_seq
from innfer_tpu_torch.models import common as C
from innfer_tpu_torch.models.base import ModelDef, cached
from innfer_tpu_torch.nn import functional as F
from innfer_tpu_torch.observability import count
from innfer_tpu_torch.ops import layer_norm as LN
from innfer_tpu_torch.ops import token_gemm as TG
from innfer_tpu_torch.ops import window_attn as WA

RGB_MEAN = (0.4488, 0.4371, 0.4040)
TRUNK_SLOPE = 0.01   # conv_before_upsample's nn.LeakyReLU(): PyTorch's default slope


def canvas(h: int, w: int, window: int) -> Tuple[int, int]:
    """The trunk's canvas: h and w up to the next multiple of the window."""
    return -(-h // window) * window, -(-w // window) * window


def _refuse(cfg: Dict[str, Any]) -> None:
    up, resi = cfg.get("upsampler", "nearest+conv"), cfg.get("resi_connection", "1conv")
    if up != "nearest+conv":
        what = {"pixelshuffle": "the pixelshuffle upsampler (classical SR)",
                "pixelshuffledirect": "the pixelshuffledirect upsampler (the lightweight model)",
                "": "SwinIR without an upsampler (denoising, JPEG artifact removal)"}
        raise NotImplementedError(
            f"SwinIR: {what.get(up, f'the upsampler {up!r}')} is not implemented; the port "
            "runs the real-world SR models (upsampler 'nearest+conv')")
    if resi != "1conv":
        raise NotImplementedError(
            f"SwinIR: the residual connection {resi!r} (SwinIR-L's '3conv') is not implemented; "
            "the port runs '1conv'")
    if int(cfg.get("upscale", 4)) != 4:
        raise NotImplementedError("SwinIR: the nearest+conv upsampler is published for x4 only")


def ln(params, x: torch.Tensor, key: str, width: int) -> torch.Tensor:
    """LayerNorm ``key`` of the tokens x, into rows of ``width`` channels."""
    w, b = params[f"{key}.weight"], params[f"{key}.bias"]
    if LN.fusable(x, w, b):
        return LN.fused_layer_norm(x, w, b, out_width=width)
    return LN.layer_norm_reference(x, w, b, out_width=width)


def packed(params, x: torch.Tensor, key: str, pack=None):
    """The linear ``key``'s weight and bias in the layout ``pack(w, b)``
    gives (kept per ParamDict), the bias in x's dtype for the bf16 route."""
    w, b = params[f"{key}.weight"], params[f"{key}.bias"]
    if pack is not None:
        w, b = cached(params, ("swin_pack", key, w.dtype, w.device), lambda: pack(w, b))
    if x.dtype not in (torch.float32, torch.float64):
        b = cached(params, ("swin_bias_lowp", key, x.dtype, b.device), lambda: b.to(x.dtype))
    return w, b


def linear(params, x: torch.Tensor, key: str, pack=None) -> torch.Tensor:
    """The linear ``key`` on x (:func:`packed`'s weight and bias)."""
    return F.linear(x, *packed(params, x, key, pack))


def token_linear(params, x: torch.Tensor, key: str, pack=None, *, epilogue: str,
                 residual=None) -> torch.Tensor:
    """The linear ``key`` on x with its epilogue, ``residual + linear`` or
    ``gelu(linear)``: on the token GEMM kernel where ``token_gemm.fusable``
    holds (counted as ``swin_linears_fused``), else its plain version."""
    w, b = packed(params, x, key, pack)
    if TG.fusable(x, w, b, epilogue=epilogue, residual=residual):
        count("swin_linears_fused", 1)
        return TG.token_linear(x, w, b, epilogue=epilogue, residual=residual)
    return TG.token_linear_reference(x, w, b, epilogue=epilogue, residual=residual)


def pad_in(width: int):
    """A packing that zero-pads a weight's input columns to ``width``: the
    linear then reads the padded rows the LayerNorm or attention wrote."""
    return lambda w, b: (TF.pad(w, (0, width - w.shape[1])).contiguous(), b)


def conv(params, x: torch.Tensor, key: str) -> torch.Tensor:
    return F.conv2d(x, params[f"{key}.weight"], params.get(f"{key}.bias"), padding=1)


def qkv_rows(params, y: torch.Tensor, key: str, heads: int) -> torch.Tensor:
    """The linear ``key`` (a qkv projection) on LayerNorm rows ``y`` of
    16-byte width, into the attention kernels' layout: each head's q, k and
    v padded to 32 channels (``window_attn.pack_qkv``)."""
    cp = y.shape[-1]
    return linear(params, y, key, lambda w, b: WA.pack_qkv(w, b, heads, cp))


def mlp_residual(params, x: torch.Tensor, prefix: str) -> torch.Tensor:
    """``x + fc2(GELU(fc1(norm2(x))))``: the LayerNorm into 16-byte rows,
    fc1 with GELU and fc2 with the residual add on the token GEMM."""
    cp = WA.padded(x.shape[-1])
    h = ln(params, x, f"{prefix}.norm2", cp)
    h = token_linear(params, h, f"{prefix}.mlp.fc1", pad_in(cp), epilogue="gelu")
    return token_linear(params, h, f"{prefix}.mlp.fc2", epilogue="residual", residual=x)


def swin_layer(params, x: torch.Tensor, prefix: str, *, heads: int, window: int,
               shift: int) -> torch.Tensor:
    """One Swin transformer layer on (B, H, W, C) tokens in image layout,
    H and W multiples of the window.  The tokens that a GEMM reads (the
    LayerNorms' and the attention's outputs) are padded to 16-byte rows
    (``window_attn.padded``), and the qkv rows to 32 channels a head
    (``window_attn.pack_qkv``), with zeros that the packed weights meet
    with zero columns."""
    c = x.shape[-1]
    cp = WA.padded(c)
    count("window_attns", 1)
    count("swin_linears", 3)
    qkv = qkv_rows(params, ln(params, x, f"{prefix}.norm1", cp), f"{prefix}.attn.qkv", heads)
    table = params[f"{prefix}.attn.relative_position_bias_table"]
    bias = cached(params, ("swin_bias", prefix, table.device),
                  lambda: WA.gather_bias(table, window))
    kw = dict(heads=heads, head_dim=c // heads, window=window, shift=shift)
    if WA.fusable(qkv, bias, weight=params[f"{prefix}.attn.qkv.weight"], **kw):
        count("window_attns_fused", 1)
        a = WA.window_attn(qkv, bias, **kw)
    else:
        a = WA.window_attn_reference(qkv, bias, **kw)
    del qkv
    x = token_linear(params, a, f"{prefix}.attn.proj", pad_in(cp), epilogue="residual",
                     residual=x)
    return mlp_residual(params, x, prefix)


def build(cfg: Dict[str, Any]) -> ModelDef:
    _refuse(cfg)
    depths = [int(d) for d in cfg["depths"]]
    heads = [int(h) for h in cfg["num_heads"]]
    window = int(cfg["window_size"])
    embed = int(cfg["embed_dim"])
    img_range = float(cfg.get("img_range", 1.0))
    in_nc = int(cfg.get("in_chans", 3))
    mean = RGB_MEAN if in_nc == 3 else (0.0,) * in_nc

    def mean_on(params, device) -> torch.Tensor:
        # kept on the device: a tensor made from a list is a pageable copy,
        # which waits for the stream's work before it starts
        return cached(params, ("swinir_mean", device),
                      lambda: torch.tensor(mean, dtype=torch.float32, device=device))

    def shift_in(params, x: torch.Tensor) -> torch.Tensor:
        return ((x.float() - mean_on(params, x.device)) * img_range).to(x.dtype)

    def apply_trunk(params, x: torch.Tensor) -> torch.Tensor:
        """The mean shift, conv_first, the groups, the final norm, the long
        skip and conv_before_upsample with its LeakyReLU, on a (B, H, W,
        in_chans) canvas whose sides are multiples of the window: the
        (B, H, W, 64) map the tail upsamples."""
        if x.shape[1] % window or x.shape[2] % window:
            raise ValueError(f"SwinIR's trunk runs on a canvas of multiples of its window "
                             f"{window}; got {tuple(x.shape[1:3])}")
        fea = conv(params, shift_in(params, x), "conv_first")
        t = ln(params, fea, "patch_embed.norm", embed)
        for i, (depth, nh) in enumerate(zip(depths, heads)):
            res = t
            for j in range(depth):
                t = swin_layer(params, t, f"layers.{i}.residual_group.blocks.{j}", heads=nh,
                               window=window, shift=0 if j % 2 == 0 else window // 2)
            t = conv(params, t, f"layers.{i}.conv") + res
        t = conv(params, ln(params, t, "norm", embed), "conv_after_body") + fea
        return F.leaky_relu(conv(params, t, "conv_before_upsample.0"), TRUNK_SLOPE)

    def apply_tail(params, h: torch.Tensor) -> torch.Tensor:
        """ESRGAN's x4 tail on the 64-channel map, then the mean back."""
        y = C.sr_tail(params, h, "tail", upscale=4, up_mode="upconv", act_type="leakyrelu",
                      finalact=None, start=0)
        return (y.float() / img_range + mean_on(params, y.device)).to(y.dtype)

    def apply(params, x: torch.Tensor) -> torch.Tensor:
        """The whole image: reflected up to the window's multiple, as the
        published ``check_image_size``, and the output cropped."""
        h, w = x.shape[1], x.shape[2]
        ph, pw = canvas(h, w, window)
        xp = F.pad2d(x, (0, pw - w, 0, ph - h), mode="reflect") if (ph, pw) != (h, w) else x
        return apply_tail(params, apply_trunk(params, xp))[:, :4 * h, :4 * w]

    hd_ok = all(embed % nh == 0 and embed // nh <= WA.HEAD_STRIDE for nh in heads)
    return ModelDef(name="swinir", cfg=dict(cfg), apply=apply, scale=4,
                    remap=swinir_to_seq, apply_trunk=apply_trunk, apply_tail=apply_tail,
                    # ESRGAN's x4 tail: 4 LR px cover it
                    tail_halo=4,
                    hybrid_canvas=lambda h, w: canvas(h, w, window),
                    fp32_keys=(r".*\.relative_position_bias_table",),
                    # auto goes hybrid on the card where the attention kernel
                    # takes the layers (bf16; fp32 runs the plain version on
                    # the whole image, exactly)
                    trunk_kernel=window == WA.WINDOW and hd_ok)
