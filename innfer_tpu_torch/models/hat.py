"""HAT in PyTorch, NHWC: the real-world x4 model (Real-HAT-GAN,
``pixelshuffle`` upsampler, ``1conv`` residual connection).

Chen et al., "Activating More Pixels in Image Super-Resolution
Transformer", arXiv:2205.04437; github.com/XPixelGroup/HAT
``hat/archs/hat_arch.py``.  The JAX package has no HAT.  A forward:

  (x - mean) * img_range  -> conv_first -> patch_embed.norm
    -> groups (RHAG): [HAB] x depth, OCAB, conv 3x3, + input
    -> norm -> conv_after_body, + conv_first's output
    -> conv_before_upsample + LeakyReLU(0.01)             (64 channels)
    -> the pixelshuffle tail (``common.sr_tail`` without an HR conv:
       upsample.0 conv + shuffle, upsample.2 conv + shuffle, conv_last)
    -> / img_range + mean

Each hybrid attention block (HAB) keeps the published order: ``y =
LN1(x)``; ``conv_x = CAB(y)``; ``attn_x = proj(WindowAttention(roll(y,
-s)))`` rolled back; ``x = x + attn_x + conv_scale conv_x``; then ``x = x +
fc2(GELU(fc1(LN2(x))))``.  Its window attention is Swin's at the window of
16, shifted by half a window in every second block.  The channel-attention
block (CAB) is ``conv3x3(C -> C / compress_ratio)``, GELU, ``conv3x3(-> C)``
and the gate ``sigmoid(conv1x1(ReLU(conv1x1(mean_hw(z)))))`` over the whole
canvas.  Each group ends with an overlapping cross-attention block (OCAB):
``x = x + proj(OCA(LN1(x)))``, then the MLP; its 16 x 16 query windows
attend to the 24 x 24 key windows around them.

The port's pieces are SwinIR's (``models/swinir.py``): LN1 runs once, into
16-byte rows that feed both the qkv GEMM and the CAB's first conv (its
weight's input columns zero-padded); proj, fc1 and fc2 run on the token
GEMM with the residual add or GELU in its epilogue (counters
``swin_linears`` and ``swin_linears_fused``, three a block); HAB proj's
residual is ``x + conv_scale z g``, z the CAB's second conv and g its gate,
formed in one bf16 pass.  The attentions run on ``ops/hat_attn.py``'s
kernel wherever its ``fusable`` holds (bf16 on the card, window 16, overlap
0.5, heads of at most 32 channels), elsewhere the plain versions; counters
``window_attns`` and ``window_attns_fused`` (the HABs), ``overlap_attns``
and ``overlap_attns_fused`` (the OCABs).  The CAB runs on the conv route
(``nn/functional.conv2d``), GELU and the channel attention in plain
PyTorch, inside the span ``innfer.cab`` from its first conv to the gated
residual.  The shift mask and both relative-position indices are computed
for the canvas at hand (the checkpoint's index buffers are checked and
dropped at load, ``checkpoint/remaps.hat_to_seq``).

Rounding (bf16): SwinIR's for the LayerNorms, linears, convs and residual
sums; the attentions as ``ops/hat_attn.py`` says; the CAB's first conv and
GELU in fp32 (bf16 operands, fp32 sums and bias), rounded once; its second
conv's fp32 sums kept unrounded through the channel attention (mean, 1x1
convs on the rounded 1x1 weights, ReLU, sigmoid, all fp32) and HAB's
residual ``x + conv_scale z g``, rounded once, to which proj's output is
then added and rounded (the published sum ``x + attn_x + conv_scale
conv_x`` in another order: the one departure from it).

The hybrid split: ``apply_trunk`` runs everything up to the 64-channel map
on the whole image reflected to the next multiple of the window (the
published ``pre_process``), the engine's canvas for this model
(``hybrid_canvas``): the shifted windows and the CAB's mean span the image,
so another canvas would change the output far from its border.
``apply_tail`` is the pixelshuffle tail on a tile of that map.  Refused by
name: upsamplers other than ``pixelshuffle``, residual connections other
than ``1conv``, a window not a multiple of 2, channels that the heads,
compress_ratio or squeeze_factor do not divide.
"""
from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn.functional as TF

from innfer_tpu_torch.checkpoint.remaps import hat_to_seq
from innfer_tpu_torch.models import common as C
from innfer_tpu_torch.models import swinir as SW
from innfer_tpu_torch.models.base import ModelDef, cached
from innfer_tpu_torch.nn import functional as F
from innfer_tpu_torch.observability import count, span
from innfer_tpu_torch.ops import hat_attn as HA
from innfer_tpu_torch.ops import window_attn as WA

RGB_MEAN = SW.RGB_MEAN
TRUNK_SLOPE = SW.TRUNK_SLOPE   # conv_before_upsample's nn.LeakyReLU()


def _refuse(cfg: Dict[str, Any]) -> None:
    up, resi = cfg.get("upsampler", "pixelshuffle"), cfg.get("resi_connection", "1conv")
    if up != "pixelshuffle":
        raise NotImplementedError(
            f"HAT: the upsampler {up!r} is not implemented; the port runs 'pixelshuffle' (the "
            "released SR models, Real-HAT-GAN among them)")
    if resi != "1conv":
        raise NotImplementedError(
            f"HAT: the residual connection {resi!r} is not implemented; the port runs '1conv'")
    embed, window = int(cfg["embed_dim"]), int(cfg["window_size"])
    for what, d in (("compress_ratio", cfg["compress_ratio"]),
                    ("squeeze_factor", cfg["squeeze_factor"]),
                    *(("num_heads", nh) for nh in cfg["num_heads"])):
        if int(d) < 1 or embed % int(d):
            raise NotImplementedError(f"HAT: embed_dim {embed} is not a multiple of {what} {d}")
    if window % 2:
        raise NotImplementedError(f"HAT: an odd window {window} has no half-window shift")


def channel_gate(params, z: torch.Tensor, key: str) -> torch.Tensor:
    """The channel attention ``key`` of (B, H, W, C) z: (B, C) fp32 gates
    ``sigmoid(conv1x1(ReLU(conv1x1(mean_hw(z)))))``, the mean over the whole
    canvas, all in fp32."""
    a = z.mean(dim=(1, 2), dtype=torch.float32)
    a = torch.relu(a @ params[f"{key}.1.weight"].flatten(1).float().t()
                   + params[f"{key}.1.bias"].float())
    return torch.sigmoid(a @ params[f"{key}.3.weight"].flatten(1).float().t()
                         + params[f"{key}.3.bias"].float())


def cab(params, y: torch.Tensor, key: str, x: torch.Tensor, scale: float) -> torch.Tensor:
    """``x + scale CAB(y)``, rounded once to x's dtype: the CAB ``key`` of
    the LayerNorm rows ``y`` (16-byte rows, zeros after x's channels), its
    first conv's weight zero-padded to y's width (kept per ParamDict).
    GELU takes the first conv's fp32 accumulator and rounds once; the
    second conv's accumulator stays fp32 through the gate's mean and the
    gated sum, which one pass writes in x's dtype."""
    cp = y.shape[-1]
    w1 = params[f"{key}.cab.0.weight"]
    w1 = cached(params, ("hat_cab_w", key, w1.dtype, y.device),
                lambda: TF.pad(w1, (0, 0, 0, 0, 0, cp - w1.shape[1])))
    h = F.conv2d(y, w1, params[f"{key}.cab.0.bias"], padding=1, out_dtype=torch.float32)
    h = TF.gelu(h).to(x.dtype)
    z = F.conv2d(h, params[f"{key}.cab.2.weight"], params[f"{key}.cab.2.bias"], padding=1,
                 out_dtype=torch.float32)
    del h
    g = channel_gate(params, z, f"{key}.cab.3.attention")
    return torch.addcmul(x, z, (scale * g)[:, None, None, :], out=torch.empty_like(x))


def hab(params, x: torch.Tensor, prefix: str, *, heads: int, window: int, shift: int,
        conv_scale: float) -> torch.Tensor:
    """One hybrid attention block on (B, H, W, C) tokens in image layout, H
    and W multiples of the window."""
    cp = WA.padded(x.shape[-1])
    count("window_attns", 1)
    count("swin_linears", 3)
    y = SW.ln(params, x, f"{prefix}.norm1", cp)
    with span("innfer.cab", x.device):
        r = cab(params, y, f"{prefix}.conv_block", x, conv_scale)
    qkv = SW.qkv_rows(params, y, f"{prefix}.attn.qkv", heads)
    del y
    table = params[f"{prefix}.attn.relative_position_bias_table"]
    kw = dict(heads=heads, head_dim=x.shape[-1] // heads, window=window, shift=shift)
    if HA.fusable(qkv, table, weight=params[f"{prefix}.attn.qkv.weight"], **kw):
        count("window_attns_fused", 1)
        a = HA.hat_window_attn(qkv, table, **kw)
    else:
        a = HA.hat_window_attn_reference(qkv, table, **kw)
    del qkv
    x = SW.token_linear(params, a, f"{prefix}.attn.proj", SW.pad_in(cp), epilogue="residual",
                        residual=r)
    return SW.mlp_residual(params, x, prefix)


def ocab(params, x: torch.Tensor, prefix: str, *, heads: int, window: int,
         kwin: int) -> torch.Tensor:
    """One overlapping cross-attention block on (B, H, W, C) tokens."""
    cp = WA.padded(x.shape[-1])
    count("overlap_attns", 1)
    count("swin_linears", 3)
    qkv = SW.qkv_rows(params, SW.ln(params, x, f"{prefix}.norm1", cp), f"{prefix}.qkv", heads)
    table = params[f"{prefix}.relative_position_bias_table"]
    kw = dict(heads=heads, head_dim=x.shape[-1] // heads, window=window, kwin=kwin)
    if HA.fusable(qkv, table, weight=params[f"{prefix}.qkv.weight"], **kw):
        count("overlap_attns_fused", 1)
        a = HA.overlap_attn(qkv, table, **kw)
    else:
        a = HA.overlap_attn_reference(qkv, table, **kw)
    del qkv
    x = SW.token_linear(params, a, f"{prefix}.proj", SW.pad_in(cp), epilogue="residual",
                        residual=x)
    return SW.mlp_residual(params, x, prefix)


def build(cfg: Dict[str, Any]) -> ModelDef:
    _refuse(cfg)
    depths = [int(d) for d in cfg["depths"]]
    heads = [int(h) for h in cfg["num_heads"]]
    window = int(cfg["window_size"])
    kwin = HA.key_window(window, float(cfg["overlap_ratio"]))
    embed = int(cfg["embed_dim"])
    conv_scale = float(cfg.get("conv_scale", 0.01))
    img_range = float(cfg.get("img_range", 1.0))
    upscale = int(cfg.get("upscale", 4))
    in_nc = int(cfg.get("in_chans", 3))
    mean = RGB_MEAN if in_nc == 3 else (0.0,) * in_nc

    def mean_on(params, device) -> torch.Tensor:
        # kept on the device, as SwinIR's
        return cached(params, ("hat_mean", device),
                      lambda: torch.tensor(mean, dtype=torch.float32, device=device))

    def apply_trunk(params, x: torch.Tensor) -> torch.Tensor:
        """The mean shift, conv_first, the groups, the final norm, the long
        skip and conv_before_upsample with its LeakyReLU, on a (B, H, W,
        in_chans) canvas whose sides are multiples of the window: the
        (B, H, W, 64) map the tail upsamples."""
        if x.shape[1] % window or x.shape[2] % window:
            raise ValueError(f"HAT's trunk runs on a canvas of multiples of its window "
                             f"{window}; got {tuple(x.shape[1:3])}")
        x = ((x.float() - mean_on(params, x.device)) * img_range).to(x.dtype)
        fea = SW.conv(params, x, "conv_first")
        t = SW.ln(params, fea, "patch_embed.norm", embed)
        for i, (depth, nh) in enumerate(zip(depths, heads)):
            res = t
            pre = f"layers.{i}.residual_group"
            for j in range(depth):
                t = hab(params, t, f"{pre}.blocks.{j}", heads=nh, window=window,
                        shift=0 if j % 2 == 0 else window // 2, conv_scale=conv_scale)
            t = ocab(params, t, f"{pre}.overlap_attn", heads=nh, window=window, kwin=kwin)
            t = SW.conv(params, t, f"layers.{i}.conv") + res
        t = SW.conv(params, SW.ln(params, t, "norm", embed), "conv_after_body") + fea
        return F.leaky_relu(SW.conv(params, t, "conv_before_upsample.0"), TRUNK_SLOPE)

    def apply_tail(params, h: torch.Tensor) -> torch.Tensor:
        """The pixelshuffle tail on the 64-channel map (no activation, no HR
        conv), then the mean back."""
        y = C.sr_tail(params, h, "tail", upscale=upscale, up_mode="pixelshuffle",
                      act_type=None, finalact=None, start=0, hr_conv=False)
        return (y.float() / img_range + mean_on(params, y.device)).to(y.dtype)

    def apply(params, x: torch.Tensor) -> torch.Tensor:
        """The whole image: reflected up to the window's multiple, as the
        published ``pre_process``, and the output cropped."""
        h, w = x.shape[1], x.shape[2]
        ph, pw = SW.canvas(h, w, window)
        xp = F.pad2d(x, (0, pw - w, 0, ph - h), mode="reflect") if (ph, pw) != (h, w) else x
        return apply_tail(params, apply_trunk(params, xp))[:, :upscale * h, :upscale * w]

    hd_ok = all(embed // nh <= WA.HEAD_STRIDE and (embed // nh) % 2 == 0 for nh in heads)
    return ModelDef(name="hat", cfg=dict(cfg), apply=apply, scale=upscale,
                    remap=hat_to_seq, apply_trunk=apply_trunk, apply_tail=apply_tail,
                    # one LR conv, one at 2x, conv_last at 4x: under 2 LR px
                    tail_halo=2,
                    hybrid_canvas=lambda h, w: SW.canvas(h, w, window),
                    fp32_keys=(r".*relative_position_bias_table",),
                    # auto goes hybrid on the card where the attention kernel
                    # takes the blocks (bf16; fp32 runs the plain versions on
                    # the whole image, exactly)
                    trunk_kernel=window == HA.WINDOW and kwin == HA.KEY_WINDOW and hd_ok)
