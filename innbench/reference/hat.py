"""Plain reference of HAT, real-world x4 (Real-HAT-GAN), as published: Chen et
al., arXiv:2205.04437; github.com/XPixelGroup/HAT ``hat/archs/hat_arch.py``,
``HAT(upscale=4, in_chans=3, img_size=64, window_size=16, compress_ratio=3,
squeeze_factor=30, conv_scale=0.01, overlap_ratio=0.5, img_range=1.,
depths=[6]*6, embed_dim=180, num_heads=[6]*6, mlp_ratio=2,
upsampler='pixelshuffle', resi_connection='1conv')``
(``options/test/HAT_GAN_Real_SRx4.yml``) in the key layout of the released
``Real_HAT_GAN_SRx4.pth``.

The forward: the mean shift, ``conv_first``, ``patch_embed.norm``, the
residual hybrid attention groups (each hybrid attention block ``y =
LN1(x)``, ``x + attn(y) + conv_scale CAB(y)`` with Swin's window attention
at window 16, shifted by half a window in every second block, and the CAB
``conv, GELU, conv, x sigmoid(conv1x1(ReLU(conv1x1(mean_hw))))``, then ``x +
fc2(GELU(fc1(LN2 x)))``; the group's overlapping cross-attention block,
each 16 x 16 query window against the 24 x 24 key window that
``nn.Unfold(24, stride 16, padding 4)`` cuts from k and v after the linear,
zeros outside the canvas, the 1521-row table read through
``calculate_rpi_oca``'s index with PyTorch's wrap of negative rows; a 3x3
conv and the group's residual), the final norm, ``conv_after_body`` with
the long skip, ``conv_before_upsample`` (LeakyReLU 0.01), ``upsample.0``
and ``upsample.2`` (conv + PixelShuffle(2)), ``conv_last``, the mean back.
The image is reflected up to a multiple of the window first (the test
script's ``pre_process``).  fp32, NCHW for the convs and tokens in image
layout for the blocks; ``precision`` rounds the operands of every conv
(the CAB's among them), linear and of q k^T and P v of both attentions as
``common.quantize`` says.  The attentions run a block of windows at a time,
so that a 544 x 960 canvas fits the card.  The program's cut of the image
is worked out here and by ``reference/plan.py``.  Imports nothing of the
program."""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as TF

from innbench.reference import common, plan
from innbench.reference import swinir as SR

RGB_MEAN = SR.RGB_MEAN
TRUNK_SLOPE = SR.TRUNK_SLOPE   # conv_before_upsample's nn.LeakyReLU()
PROBE = 64          # the calibration probe's side, a multiple of the window
# the pixelshuffle tail: one LR conv, one at 2x, conv_last at 4x, under 2 LR px
TAIL_HALO = 2
WINDOWS = 256       # windows an attention step takes
# where the program's attention kernel runs the blocks (and auto mode goes
# hybrid on the card): 16 x 16 windows, 24 x 24 key windows, heads of an even
# width of at most 32 channels
KERNEL_WINDOW, KERNEL_KEY_WINDOW, KERNEL_HEAD_DIM = 16, 24, 32


def key_window(model: dict) -> int:
    return int(model["window_size"] * model["overlap_ratio"]) + model["window_size"]


def _blocks(model: dict):
    return [(i, d, nh) for i, (d, nh) in enumerate(zip(model["depths"], model["num_heads"]))]


def state_shapes(model: dict) -> List[Tuple[str, Tuple[int, ...], str, float]]:
    """(key, shape, kind, gain) of every tensor of the released state dict,
    in its order, buffers included.  Kinds: ``w`` a weight of std gain /
    sqrt(fan_in), ``b`` a bias of spread 0.02 (``cb`` 0.01 for a conv,
    ``gate`` ``gate_std`` for the channel attention's last conv), ``ln_w`` /
    ``ln_b`` a LayerNorm affine about (1, 0) with spread 0.1, ``table`` a
    relative-position table of std ``bias_std``, ``index_sa`` and
    ``index_oca`` the published buffers.  Gains: He's for a conv before a
    leaky ReLU, for fc1 and the CAB's first conv before GELU and for the
    squeeze conv before ReLU; ``qkv_gain`` for qkv; ``branch_gain`` for proj
    and fc2 and ``group_gain`` for each group's conv (SwinIR-M's recipe,
    which keeps the residual stream near unit size); ``cab_gain`` for the
    CAB's second conv, so that ``conv_scale`` times its gated output is a
    visible share of the block's update; ``gate_gain`` for the channel
    attention's last conv, which with its bias's ``gate_std`` spreads the
    gates over (0, 1) without saturating them."""
    c, ws, ows = model["embed_dim"], model["window_size"], key_window(model)
    hidden, nf = int(c * model["mlp_ratio"]), model["num_feat"]
    cc, cs = c // model["compress_ratio"], c // model["squeeze_factor"]
    he = lambda slope: math.sqrt(2.0 / (1.0 + slope ** 2))  # noqa: E731

    def conv(key, o, i, gain, k=3, bias="cb"):
        return [(f"{key}.weight", (o, i, k, k), "w", gain), (f"{key}.bias", (o,), bias, 0.0)]

    def lin(key, o, i, gain):
        return [(f"{key}.weight", (o, i), "w", gain), (f"{key}.bias", (o,), "b", 0.0)]

    def ln(key):
        return [(f"{key}.weight", (c,), "ln_w", 0.0), (f"{key}.bias", (c,), "ln_b", 0.0)]

    def mlp(p):
        return ln(f"{p}.norm2") + lin(f"{p}.mlp.fc1", hidden, c, math.sqrt(2.0)) + lin(
            f"{p}.mlp.fc2", c, hidden, model["branch_gain"])

    out = [("relative_position_index_SA", (ws * ws, ws * ws), "index_sa", 0.0),
           ("relative_position_index_OCA", (ws * ws, ows * ows), "index_oca", 0.0)]
    out += conv("conv_first", c, model["in_chans"], 1.0) + ln("patch_embed.norm")
    for i, depth, nh in _blocks(model):
        g = f"layers.{i}.residual_group"
        for j in range(depth):
            p = f"{g}.blocks.{j}"
            cab = f"{p}.conv_block.cab"
            out += ln(f"{p}.norm1")
            out += [(f"{p}.attn.relative_position_bias_table", ((2 * ws - 1) ** 2, nh), "table",
                     0.0)]
            out += lin(f"{p}.attn.qkv", 3 * c, c, model["qkv_gain"])
            out += lin(f"{p}.attn.proj", c, c, model["branch_gain"])
            out += conv(f"{cab}.0", cc, c, math.sqrt(2.0))
            out += conv(f"{cab}.2", c, cc, model["cab_gain"])
            out += conv(f"{cab}.3.attention.1", cs, c, math.sqrt(2.0), k=1)
            out += conv(f"{cab}.3.attention.3", c, cs, model["gate_gain"], k=1, bias="gate")
            out += mlp(p)
        p = f"{g}.overlap_attn"
        out += [(f"{p}.relative_position_bias_table", ((ws + ows - 1) ** 2, nh), "table", 0.0)]
        out += ln(f"{p}.norm1") + lin(f"{p}.qkv", 3 * c, c, model["qkv_gain"])
        out += lin(f"{p}.proj", c, c, model["branch_gain"]) + mlp(p)
        out += conv(f"layers.{i}.conv", c, c, model["group_gain"])
    out += ln("norm") + conv("conv_after_body", c, c, 1.0)
    out += conv("conv_before_upsample.0", nf, c, he(TRUNK_SLOPE))
    n_up = int(math.log2(model["scale"]))
    for k in range(n_up):
        out += conv(f"upsample.{2 * k}", 4 * nf, nf, 1.0)
    out += conv("conv_last", model["in_chans"], nf, 1.0)
    return out


def rpi_sa(ws: int, device=None) -> torch.Tensor:
    """``calculate_rpi_sa``: Swin's relative-position index."""
    return SR.relative_position_index(ws, device)


def rpi_oca(ws: int, ows: int, device=None) -> torch.Tensor:
    """``calculate_rpi_oca``: (ws^2, ows^2), negative for some pairs."""
    def flat(n):
        ar = torch.arange(n, device=device)
        return torch.stack(torch.meshgrid(ar, ar, indexing="ij")).flatten(1)

    rel = (flat(ows)[:, None, :] - flat(ws)[:, :, None]).permute(1, 2, 0).contiguous()
    rel[:, :, 0] += ws - ows + 1
    rel[:, :, 1] += ws - ows + 1
    rel[:, :, 0] *= ws + ows - 1
    return rel.sum(-1)


def make_state(model: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The seeded weights (:func:`state_shapes`), ``conv_last`` set on a
    seeded probe image so that the output has mean 0.5 and ``out_std`` in
    each channel."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    shapes = state_shapes(model)
    flat = torch.randn(sum(int(np.prod(s)) for _, s, k, _ in shapes
                           if not k.startswith("index")), generator=g, device=device)
    state, at = {}, 0
    ws, ows = model["window_size"], key_window(model)
    for key, shape, kind, gain in shapes:
        if kind == "index_sa":
            state[key] = rpi_sa(ws, device)
            continue
        if kind == "index_oca":
            state[key] = rpi_oca(ws, ows, device)
            continue
        n = int(np.prod(shape))
        r = flat[at:at + n].view(shape)
        at += n
        state[key] = {"w": lambda: r * (gain / math.sqrt(int(np.prod(shape[1:])))),
                      "b": lambda: r * 0.02, "cb": lambda: r * 0.01,
                      "gate": lambda: r * model["gate_std"],
                      "ln_w": lambda: 1.0 + 0.1 * r, "ln_b": lambda: 0.1 * r,
                      "table": lambda: r * model["bias_std"]}[kind]()
    x = common.probe(seed, device, size=PROBE)
    with torch.no_grad(), common.true_fp32():
        h = trunk(Ops(state), x, model)
    mean = (0.5 - torch.tensor(RGB_MEAN, device=device)) * model["img_range"]
    common.calibrate_last(state, "conv_last", lambda t: tail_convs(Ops(state), t, model), h,
                          mean, model["out_std"] * model["img_range"])
    return state


class Ops(SR.Ops):
    """SwinIR's: convs, linears and products in ``precision``."""


def cab(ops: Ops, y: torch.Tensor, p: str) -> torch.Tensor:
    """The CAB of (B, H, W, C) tokens: conv, GELU, conv, the channel gate
    over the whole canvas (``nn.AdaptiveAvgPool2d(1)``)."""
    t = TF.gelu(ops.conv(y.permute(0, 3, 1, 2), f"{p}.cab.0", padding=1))
    z = ops.conv(t, f"{p}.cab.2", padding=1)
    a = TF.relu(ops.conv(z.mean(dim=(2, 3), keepdim=True), f"{p}.cab.3.attention.1"))
    return (z * torch.sigmoid(ops.conv(a, f"{p}.cab.3.attention.3"))).permute(0, 2, 3, 1)


def _softmax_attend(ops: Ops, q, k, v, bias, mask=None):
    """softmax(q' k^T + bias (+ mask)) v over (windows, heads, N, d) q and
    (windows, heads, M, d) k, v, the operands rounded as ``precision`` says."""
    s = ops.q(q) @ ops.q(k).transpose(-2, -1) + bias.unsqueeze(0)
    if mask is not None:
        s = s + mask.unsqueeze(1)
    return ops.q(s.softmax(dim=-1)) @ ops.q(v)


def window_attention(ops: Ops, y: torch.Tensor, p: str, heads: int, ws: int,
                     shift: int) -> torch.Tensor:
    """The HAB's WindowAttention with the roll, partition, reverse and roll
    back around it, on (B, H, W, C) tokens, a block of windows at a time."""
    b, h, w, c = y.shape
    if shift:
        y = torch.roll(y, (-shift, -shift), (1, 2))
    yw = SR.window_partition(y, ws)
    n = ws * ws
    table = ops.state[f"{p}.attn.relative_position_bias_table"]
    bias = table[rpi_sa(ws, y.device).reshape(-1)].view(n, n, -1).permute(2, 0, 1)
    mask = SR.calculate_mask(h, w, ws, shift, y.device) if shift else None
    nw = (h // ws) * (w // ws)
    outs = []
    for s0 in range(0, yw.shape[0], WINDOWS):
        qkv = ops.linear(yw[s0:s0 + WINDOWS], f"{p}.attn.qkv")
        bw = qkv.shape[0]
        q, k, v = qkv.reshape(bw, n, 3, heads, c // heads).permute(2, 0, 3, 1, 4)
        m = None
        if mask is not None:
            m = mask[torch.arange(s0, s0 + bw, device=y.device) % nw]
        o = _softmax_attend(ops, q * (c // heads) ** -0.5, k, v, bias, m)
        outs.append(ops.linear(o.transpose(1, 2).reshape(bw, n, c), f"{p}.attn.proj"))
    o = SR.window_reverse(torch.cat(outs), ws, h, w)
    return torch.roll(o, (shift, shift), (1, 2)) if shift else o


def overlap_attention(ops: Ops, y: torch.Tensor, p: str, heads: int, ws: int,
                      ows: int) -> torch.Tensor:
    """The OCAB's attention and proj on LN1's (B, H, W, C) tokens: q in
    windows, k and v unfolded after the linear, a block of windows at a
    time."""
    b, h, w, c = y.shape
    d = c // heads
    qkv = ops.linear(y, f"{p}.qkv").reshape(b, h, w, 3, c).permute(3, 0, 4, 1, 2)
    qw = SR.window_partition(qkv[0].permute(0, 2, 3, 1), ws)
    kv = torch.cat((qkv[1], qkv[2]), dim=1)
    del qkv
    table = ops.state[f"{p}.relative_position_bias_table"]
    bias = table[rpi_oca(ws, ows, y.device).reshape(-1)].view(ws * ws, ows * ows, -1)
    bias = bias.permute(2, 0, 1)
    cols = TF.unfold(kv, ows, padding=(ows - ws) // 2, stride=ws)   # b, 2 c ows^2, nw
    nw = cols.shape[-1]
    outs = []
    for s0 in range(0, b * nw, WINDOWS):
        idx = torch.arange(s0, min(s0 + WINDOWS, b * nw), device=y.device)
        kvw = cols[idx // nw, :, idx % nw].view(-1, 2, c, ows * ows).permute(1, 0, 3, 2)
        q = qw[idx].reshape(-1, ws * ws, heads, d).permute(0, 2, 1, 3)
        k, v = (t.reshape(-1, ows * ows, heads, d).permute(0, 2, 1, 3) for t in kvw)
        o = _softmax_attend(ops, q * d ** -0.5, k, v, bias)
        outs.append(o.transpose(1, 2).reshape(-1, ws * ws, c))
    o = SR.window_reverse(torch.cat(outs), ws, h, w)
    return ops.linear(o, f"{p}.proj")


def mlp(ops: Ops, x: torch.Tensor, p: str) -> torch.Tensor:
    return x + ops.linear(TF.gelu(ops.linear(ops.ln(x, f"{p}.norm2"), f"{p}.mlp.fc1")),
                          f"{p}.mlp.fc2")


def hab(ops: Ops, x: torch.Tensor, p: str, heads: int, ws: int, shift: int,
        conv_scale: float) -> torch.Tensor:
    y = ops.ln(x, f"{p}.norm1")
    attn_x = window_attention(ops, y, p, heads, ws, shift)
    x = x + attn_x + cab(ops, y, f"{p}.conv_block") * conv_scale
    return mlp(ops, x, p)


def ocab(ops: Ops, x: torch.Tensor, p: str, heads: int, ws: int, ows: int) -> torch.Tensor:
    x = overlap_attention(ops, ops.ln(x, f"{p}.norm1"), p, heads, ws, ows) + x
    return mlp(ops, x, p)


def trunk(ops: Ops, x: torch.Tensor, model: dict) -> torch.Tensor:
    """Everything up to the 64-channel map, on a (1, 3, H, W) canvas of
    multiples of the window."""
    ws, ows = model["window_size"], key_window(model)
    mean = torch.tensor(RGB_MEAN, device=x.device).view(1, 3, 1, 1)
    fea = ops.conv((x - mean) * model["img_range"], "conv_first", padding=1)
    t = ops.ln(fea.permute(0, 2, 3, 1), "patch_embed.norm")
    for i, depth, nh in _blocks(model):
        res = t
        g = f"layers.{i}.residual_group"
        for j in range(depth):
            t = hab(ops, t, f"{g}.blocks.{j}", nh, ws, 0 if j % 2 == 0 else ws // 2,
                    model["conv_scale"])
        t = ocab(ops, t, f"{g}.overlap_attn", nh, ws, ows)
        t = ops.conv_tokens(t, f"layers.{i}.conv") + res
    t = ops.ln(t, "norm").permute(0, 3, 1, 2)
    t = ops.conv(t, "conv_after_body", padding=1) + fea
    return TF.leaky_relu(ops.conv(t, "conv_before_upsample.0", padding=1), TRUNK_SLOPE)


def tail_convs(ops: Ops, h: torch.Tensor, model: dict) -> torch.Tensor:
    """upsample.0 and upsample.2 (conv + PixelShuffle(2), no activation),
    conv_last."""
    for k in range(int(math.log2(model["scale"]))):
        h = TF.pixel_shuffle(ops.conv(h, f"upsample.{2 * k}", padding=1), 2)
    return ops.conv(h, "conv_last", padding=1)


def tail(ops: Ops, h: torch.Tensor, model: dict) -> torch.Tensor:
    mean = torch.tensor(RGB_MEAN, device=h.device).view(1, 3, 1, 1)
    return tail_convs(ops, h, model) / model["img_range"] + mean


def forward(ops: Ops, x: torch.Tensor, model: dict) -> torch.Tensor:
    """The published forward of a (1, 3, H, W) image: padded to the window,
    cropped after."""
    h, w = x.shape[-2:]
    s = model["scale"]
    return tail(ops, trunk(ops, SR.pad_window(x, model["window_size"]), model), model)[
        ..., :h * s, :w * s]


def modes(model: dict, session: dict, shapes, *, on_cuda: bool,
          budget: Optional[int]) -> List[str]:
    """How the program runs each image: one at a time, in ``auto`` mode
    hybrid on the card where its attention kernel takes the blocks."""
    kernel = (model["window_size"] == KERNEL_WINDOW and key_window(model) == KERNEL_KEY_WINDOW
              and all(model["embed_dim"] // nh <= KERNEL_HEAD_DIM
                      and (model["embed_dim"] // nh) % 2 == 0 for nh in model["num_heads"]))
    return [plan.tile_mode(session["tile_mode"], h, w, kernel_trunk=kernel, on_cuda=on_cuda)
            for h, w in shapes]


def infer(state: Dict[str, torch.Tensor], rgb: np.ndarray, *, model: dict, session: dict,
          mode: str, precision: str = "fp32") -> np.ndarray:
    """One u8 RGB image through the network as the program cuts it."""
    dev = state["conv_first.weight"].device
    ops = Ops(state, precision)
    x = common.to_input(rgb, dev)
    h, w = rgb.shape[:2]
    s, ws = model["scale"], model["window_size"]
    with torch.no_grad(), common.true_fp32():
        if mode == "hybrid":
            feats = trunk(ops, SR.pad_window(x, ws), model)
            tp = SR.tail_plan(h, w, tile=session["tile"], tail_halo=TAIL_HALO, ws=ws)
            y = plan.run_tiles(lambda t: tail(ops, t, model), feats, tp, s)
        elif mode == "auto":
            ap = plan.auto_plan(h, w, overlap=session["overlap"],
                                tile_batch=session["tile_batch"])
            y = plan.run_tiles(lambda t: forward(ops, t, model),
                               plan.pad_to(x, ap.pad_h, ap.pad_w), ap, s)
        else:
            raise ValueError(f"mode {mode!r}")
        return common.to_u8(y[..., :h * s, :w * s])
