"""Plain reference of SwinIR, real-world x4 model M, as published: Liang et
al., arXiv:2108.10257; github.com/JingyunLiang/SwinIR
``models/network_swinir.py``, ``SwinIR(upscale=4, in_chans=3, img_size=64,
window_size=8, img_range=1., depths=[6]*6, embed_dim=180, num_heads=[6]*6,
mlp_ratio=2, upsampler='nearest+conv', resi_connection='1conv')`` in the key
layout of the released ``003_realSR_BSRGAN_DFO_s64w8_SwinIR-M_x4_GAN.pth``.

The forward: the mean shift, ``conv_first``, ``patch_embed.norm``, the
residual Swin groups (each Swin transformer layer ``x + proj(attn(LN1 x))``
then ``x + fc2(GELU(fc1(LN2 x)))``, attention over 8 x 8 windows with the
relative-position bias, every second layer cyclically shifted by half a
window with the -100 mask between the regions the wrap-around joins; a 3x3
conv and the group's residual), the final norm, ``conv_after_body`` with
the long skip, ``conv_before_upsample`` (LeakyReLU 0.01), nearest x2 and
``conv_up1``, nearest x2 and ``conv_up2``, ``conv_hr``, ``conv_last``
(LeakyReLU 0.2), the mean back.  The image is reflected up to a multiple
of the window first (``check_image_size``; the repository's test script
pads by flipping instead, which the configuration notes).  fp32, NCHW for
the convs and tokens in image layout for the layers; ``precision`` rounds
the operands of every conv, linear and of q k^T and P v as
``common.quantize`` says.  The program's cut of the image (the hybrid
trunk on the window-multiple canvas and the tail tiles, or the tile grid)
is worked out here and by ``reference/plan.py``.  Imports nothing of the
program."""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as TF

from innbench.reference import common, plan

RGB_MEAN = (0.4488, 0.4371, 0.4040)
TRUNK_SLOPE = 0.01   # conv_before_upsample's nn.LeakyReLU()
SLOPE = 0.2          # the tail's LeakyReLU
MASK = -100.0
EPS = 1e-5
PROBE = 64   # the calibration probe's side, a multiple of the window
# ESRGAN's x4 tail: 4 LR pixels of reach, the tail tiles' overlap is 2x this
TAIL_HALO = 4
# where the program's attention kernel runs the layers (and auto mode goes
# hybrid on the card): 8 x 8 windows, heads of at most 32 channels
KERNEL_WINDOW, KERNEL_HEAD_DIM = 8, 32


def _blocks(model: dict):
    """(group, layer, heads) of every Swin transformer layer."""
    return [(i, j, nh) for i, (d, nh) in enumerate(zip(model["depths"], model["num_heads"]))
            for j in range(d)]


def _prefix(i: int, j: int) -> str:
    return f"layers.{i}.residual_group.blocks.{j}"


def state_shapes(model: dict) -> List[Tuple[str, Tuple[int, ...], str, float]]:
    """(key, shape, kind, gain) of every tensor of the released state dict,
    in its order, buffers included.  Kinds: ``w`` a weight of std gain /
    sqrt(fan_in), ``b`` a bias of spread 0.02 (0.01 for a conv), ``ln_w``
    / ``ln_b`` a LayerNorm affine about (1, 0) with spread 0.1, ``table``
    a relative-position bias table of std ``bias_std``, ``index`` and
    ``mask`` the published buffers.  Gains: He's for a conv before a leaky
    ReLU and for fc1 before GELU; ``qkv_gain`` for qkv (the scores' spread
    per head is about its square); ``branch_gain`` for proj and fc2, so that
    each layer adds a small update and the residual stream stays near unit
    size over the 36 layers; ``group_gain`` for each group's conv, for the
    same reason over the 6 groups."""
    c, ws = model["embed_dim"], model["window_size"]
    hidden, nf = int(c * model["mlp_ratio"]), model["num_feat"]
    he = lambda slope: math.sqrt(2.0 / (1.0 + slope ** 2))  # noqa: E731

    def conv(key, o, i, gain):
        return [(f"{key}.weight", (o, i, 3, 3), "w", gain), (f"{key}.bias", (o,), "cb", 0.0)]

    def lin(key, o, i, gain):
        return [(f"{key}.weight", (o, i), "w", gain), (f"{key}.bias", (o,), "b", 0.0)]

    def ln(key):
        return [(f"{key}.weight", (c,), "ln_w", 0.0), (f"{key}.bias", (c,), "ln_b", 0.0)]

    out = conv("conv_first", c, model["in_chans"], 1.0) + ln("patch_embed.norm")
    for i, j, nh in _blocks(model):
        p = _prefix(i, j)
        out += ln(f"{p}.norm1")
        out += [(f"{p}.attn.relative_position_bias_table", ((2 * ws - 1) ** 2, nh), "table", 0.0),
                (f"{p}.attn.relative_position_index", (ws * ws, ws * ws), "index", 0.0)]
        out += lin(f"{p}.attn.qkv", 3 * c, c, model["qkv_gain"])
        out += lin(f"{p}.attn.proj", c, c, model["branch_gain"])
        out += ln(f"{p}.norm2")
        out += lin(f"{p}.mlp.fc1", hidden, c, math.sqrt(2.0))
        out += lin(f"{p}.mlp.fc2", c, hidden, model["branch_gain"])
        if j % 2:
            n = model["img_size"] // ws
            out.append((f"{p}.attn_mask", (n * n, ws * ws, ws * ws), "mask", 0.0))
        if j == model["depths"][i] - 1:
            out += conv(f"layers.{i}.conv", c, c, model["group_gain"])
    out += ln("norm") + conv("conv_after_body", c, c, 1.0)
    out += conv("conv_before_upsample.0", nf, c, he(TRUNK_SLOPE))
    for key in ("conv_up1", "conv_up2", "conv_hr"):
        out += conv(key, nf, nf, he(SLOPE))
    out += conv("conv_last", model["in_chans"], nf, 1.0)
    return out


def relative_position_index(ws: int, device=None) -> torch.Tensor:
    ar = torch.arange(ws, device=device)
    coords = torch.stack(torch.meshgrid(ar, ar, indexing="ij")).flatten(1)
    rel = (coords[:, :, None] - coords[:, None, :]).permute(1, 2, 0) + (ws - 1)
    return rel[..., 0] * (2 * ws - 1) + rel[..., 1]


def window_partition(x: torch.Tensor, ws: int) -> torch.Tensor:
    """(B, H, W, C) -> (B * windows, ws * ws, C)."""
    b, h, w, c = x.shape
    x = x.view(b, h // ws, ws, w // ws, ws, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, ws * ws, c)


def window_reverse(x: torch.Tensor, ws: int, h: int, w: int) -> torch.Tensor:
    b = x.shape[0] // ((h // ws) * (w // ws))
    x = x.view(b, h // ws, w // ws, ws, ws, -1).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h, w, -1)


def calculate_mask(h: int, w: int, ws: int, shift: int, device=None) -> torch.Tensor:
    """The published shift mask for an h x w canvas: (windows, N, N)."""
    img = torch.zeros((1, h, w, 1), device=device)
    cnt = 0
    for hs in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
        for wsl in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
            img[:, hs, wsl, :] = cnt
            cnt += 1
    mw = window_partition(img, ws).squeeze(-1)
    m = mw.unsqueeze(1) - mw.unsqueeze(2)
    return m.masked_fill(m != 0, MASK).masked_fill(m == 0, 0.0)


def make_state(model: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The seeded weights (:func:`state_shapes`), ``conv_last`` set on a
    seeded probe image so that the output has mean 0.5 and ``out_std`` in
    each channel."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    shapes = state_shapes(model)
    flat = torch.randn(sum(int(np.prod(s)) for _, s, k, _ in shapes
                           if k not in ("index", "mask")), generator=g, device=device)
    state, at = {}, 0
    ws = model["window_size"]
    for key, shape, kind, gain in shapes:
        if kind == "index":
            state[key] = relative_position_index(ws, device)
            continue
        if kind == "mask":
            n = model["img_size"]
            state[key] = calculate_mask(n, n, ws, ws // 2, device)
            continue
        n = int(np.prod(shape))
        r = flat[at:at + n].view(shape)
        at += n
        state[key] = {"w": lambda: r * (gain / math.sqrt(int(np.prod(shape[1:])))),
                      "b": lambda: r * 0.02, "cb": lambda: r * 0.01,
                      "ln_w": lambda: 1.0 + 0.1 * r, "ln_b": lambda: 0.1 * r,
                      "table": lambda: r * model["bias_std"]}[kind]()
    x = common.probe(seed, device, size=PROBE)
    with torch.no_grad(), common.true_fp32():
        h = trunk(Ops(state), x, model)
    mean = (0.5 - torch.tensor(RGB_MEAN, device=device)) * model["img_range"]
    common.calibrate_last(state, "conv_last", lambda t: tail_convs(Ops(state), t), h, mean,
                          model["out_std"] * model["img_range"])
    return state


class Ops(common.Convs):
    """The convs of :class:`common.Convs` and the transformer's linears and
    products, their operands rounded as ``precision`` says, sums in fp32;
    each weight rounded once."""

    def __init__(self, state: Dict[str, torch.Tensor], precision: str = "fp32"):
        super().__init__(state, precision)
        self._w: Dict[str, torch.Tensor] = {}

    def q(self, t: torch.Tensor) -> torch.Tensor:
        return common.quantize(t, self.precision)

    def _wb(self, key: str):
        if key not in self._w:
            self._w[key] = self.q(self.state[f"{key}.weight"])
        return self._w[key], self.state.get(f"{key}.bias")

    def linear(self, x: torch.Tensor, key: str) -> torch.Tensor:
        return TF.linear(self.q(x), *self._wb(key))

    def ln(self, x: torch.Tensor, key: str) -> torch.Tensor:
        return TF.layer_norm(x, (x.shape[-1],), self.state[f"{key}.weight"],
                             self.state[f"{key}.bias"], EPS)

    def conv_tokens(self, t: torch.Tensor, key: str) -> torch.Tensor:
        """A 3x3 conv of (B, H, W, C) tokens: patch_unembed, conv, patch_embed."""
        return self.conv(t.permute(0, 3, 1, 2), key, padding=1).permute(0, 2, 3, 1)


def attention(ops: Ops, x: torch.Tensor, p: str, heads: int, ws: int, shift: int) -> torch.Tensor:
    """WindowAttention of one layer, with the roll, partition, reverse and
    roll back around it, on (B, H, W, C) tokens."""
    b, h, w, c = x.shape
    if shift:
        x = torch.roll(x, (-shift, -shift), (1, 2))
    xw = window_partition(x, ws)
    bw, n, _ = xw.shape
    qkv = ops.linear(xw, f"{p}.attn.qkv").reshape(bw, n, 3, heads, c // heads)
    qkv = qkv.permute(2, 0, 3, 1, 4)
    q, k, v = qkv[0] * (c // heads) ** -0.5, qkv[1], qkv[2]
    s = ops.q(q) @ ops.q(k).transpose(-2, -1)
    table = ops.state[f"{p}.attn.relative_position_bias_table"]
    idx = relative_position_index(ws, x.device)
    s = s + table[idx.reshape(-1)].view(n, n, -1).permute(2, 0, 1).unsqueeze(0)
    if shift:
        mask = calculate_mask(h, w, ws, shift, x.device)
        nw = mask.shape[0]
        s = s.view(bw // nw, nw, heads, n, n) + mask.unsqueeze(1).unsqueeze(0)
        s = s.view(-1, heads, n, n)
    o = (ops.q(s.softmax(dim=-1)) @ ops.q(v)).transpose(1, 2).reshape(bw, n, c)
    o = window_reverse(ops.linear(o, f"{p}.attn.proj"), ws, h, w)
    return torch.roll(o, (shift, shift), (1, 2)) if shift else o


def swin_layer(ops: Ops, x: torch.Tensor, p: str, heads: int, ws: int, shift: int):
    x = x + attention(ops, ops.ln(x, f"{p}.norm1"), p, heads, ws, shift)
    h = TF.gelu(ops.linear(ops.ln(x, f"{p}.norm2"), f"{p}.mlp.fc1"))
    return x + ops.linear(h, f"{p}.mlp.fc2")


def trunk(ops: Ops, x: torch.Tensor, model: dict) -> torch.Tensor:
    """Everything up to the 64-channel map, on a (1, 3, H, W) canvas of
    multiples of the window."""
    ws = model["window_size"]
    mean = torch.tensor(RGB_MEAN, device=x.device).view(1, 3, 1, 1)
    fea = ops.conv((x - mean) * model["img_range"], "conv_first", padding=1)
    t = ops.ln(fea.permute(0, 2, 3, 1), "patch_embed.norm")
    for i, (depth, nh) in enumerate(zip(model["depths"], model["num_heads"])):
        res = t
        for j in range(depth):
            t = swin_layer(ops, t, _prefix(i, j), nh, ws, 0 if j % 2 == 0 else ws // 2)
        t = ops.conv_tokens(t, f"layers.{i}.conv") + res
    t = ops.ln(t, "norm").permute(0, 3, 1, 2)
    t = ops.conv(t, "conv_after_body", padding=1) + fea
    return TF.leaky_relu(ops.conv(t, "conv_before_upsample.0", padding=1), TRUNK_SLOPE)


def tail_convs(ops: Ops, h: torch.Tensor) -> torch.Tensor:
    """nearest x2 + conv_up1, nearest x2 + conv_up2, conv_hr, conv_last."""
    for key in ("conv_up1", "conv_up2"):
        h = TF.leaky_relu(ops.conv(TF.interpolate(h, scale_factor=2, mode="nearest"), key,
                                   padding=1), SLOPE)
    return ops.conv(TF.leaky_relu(ops.conv(h, "conv_hr", padding=1), SLOPE), "conv_last",
                    padding=1)


def tail(ops: Ops, h: torch.Tensor, model: dict) -> torch.Tensor:
    mean = torch.tensor(RGB_MEAN, device=h.device).view(1, 3, 1, 1)
    return tail_convs(ops, h) / model["img_range"] + mean


def window_canvas(h: int, w: int, ws: int) -> Tuple[int, int]:
    """``check_image_size``'s canvas: h and w up to the window's multiple."""
    return -(-h // ws) * ws, -(-w // ws) * ws


def pad_window(x: torch.Tensor, ws: int) -> torch.Tensor:
    """``check_image_size``: reflect at the bottom and right."""
    h, w = x.shape[-2:]
    ph, pw = window_canvas(h, w, ws)
    return TF.pad(x, (0, pw - w, 0, ph - h), mode="reflect") if (ph, pw) != (h, w) else x


def tail_plan(h: int, w: int, *, tile: int, tail_halo: int, ws: int) -> plan.Plan:
    """The program's tail grid over SwinIR's hybrid canvas (the window's
    multiple): ``plan.hybrid_tail_plan``'s rule over that canvas."""
    ph, pw = window_canvas(h, w, ws)
    ov = 2 * tail_halo
    n_rows = max(1, -(-(ph - ov) // (576 - ov)))
    th = -(-(ph + (n_rows - 1) * ov) // n_rows)
    return plan.cover_plan(ph, pw, min(ph, th), min(pw, min(tile, 256)), ov)


def forward(ops: Ops, x: torch.Tensor, model: dict) -> torch.Tensor:
    """The published forward of a (1, 3, H, W) image: padded to the window,
    cropped after."""
    h, w = x.shape[-2:]
    s = model["scale"]
    return tail(ops, trunk(ops, pad_window(x, model["window_size"]), model), model)[
        ..., :h * s, :w * s]


def modes(model: dict, session: dict, shapes, *, on_cuda: bool,
          budget: Optional[int]) -> List[str]:
    """How the program runs each image: one at a time, in ``auto`` mode
    hybrid on the card where its attention kernel takes the layers."""
    kernel = (model["window_size"] == KERNEL_WINDOW
              and all(model["embed_dim"] // nh <= KERNEL_HEAD_DIM for nh in model["num_heads"]))
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
            feats = trunk(ops, pad_window(x, ws), model)
            tp = tail_plan(h, w, tile=session["tile"], tail_halo=TAIL_HALO, ws=ws)
            y = plan.run_tiles(lambda t: tail(ops, t, model), feats, tp, s)
        elif mode == "auto":
            ap = plan.auto_plan(h, w, overlap=session["overlap"],
                                tile_batch=session["tile_batch"])
            y = plan.run_tiles(lambda t: forward(ops, t, model),
                               plan.pad_to(x, ap.pad_h, ap.pad_w), ap, s)
        else:
            raise ValueError(f"mode {mode!r}")
        return common.to_u8(y[..., :h * s, :w * s])
