"""Operations and bytes of HAT as published, counted from its shapes: a
multiply-add is two operations; LayerNorms, GELU, the softmax, the
relative-position bias and mask, the channel attention's pooling, 1x1 convs
and gate (per image, not per pixel), residual sums and the pixel shuffles
are left out (under 0.5% of the work)."""
from __future__ import annotations

import math


def key_window(model: dict) -> int:
    return int(model["window_size"] * model["overlap_ratio"]) + model["window_size"]


def _mlp(model: dict) -> int:
    c = model["embed_dim"]
    return 2 * c * int(c * model["mlp_ratio"])


def hab_macs_per_px(model: dict) -> int:
    """One hybrid attention block per LR pixel (token): qkv C x 3C, q k^T and
    P v over a window of ws^2 tokens, proj C x C, fc1 and fc2 C x hidden, and
    the CAB's two 3x3 convs C -> C / compress_ratio -> C: 545,760 at C = 180,
    window 16, mlp_ratio 2, compress_ratio 3."""
    c, n = model["embed_dim"], model["window_size"] ** 2
    cab = 2 * 9 * c * (c // model["compress_ratio"])
    return 3 * c * c + 2 * n * c + c * c + _mlp(model) + cab


def ocab_macs_per_px(model: dict) -> int:
    """One overlapping cross-attention block per LR pixel: qkv, q k^T and P v
    over the ows^2 keys of the overlapping window, proj, fc1 and fc2: 466,560
    at C = 180, key window 24."""
    c, m = model["embed_dim"], key_window(model) ** 2
    return 3 * c * c + 2 * m * c + c * c + _mlp(model)


def macs_per_lr_px(model: dict) -> int:
    """The whole network per input pixel: 25,361,388 for Real-HAT-GAN x4 --
    conv_first, the blocks, each group's conv and conv_after_body,
    conv_before_upsample and the pixelshuffle tail (upsample.0 at LR,
    upsample.2 at 2x, conv_last at 4x)."""
    c, nf, cin, s = model["embed_dim"], model["num_feat"], model["in_chans"], model["scale"]
    blocks = (sum(model["depths"]) * hab_macs_per_px(model)
              + len(model["depths"]) * ocab_macs_per_px(model))
    convs = (len(model["depths"]) + 1) * 9 * c * c
    tail = sum(9 * nf * 4 * nf * 4 ** k for k in range(int(math.log2(s)))) + s * s * 9 * nf * cin
    return 9 * cin * c + blocks + convs + 9 * c * nf + tail


def image_flops(model: dict, h: int, w: int) -> float:
    return 2.0 * macs_per_lr_px(model) * h * w


def kernel_work(model: dict, kernel: str, h: int, w: int, act_bytes: int):
    """(operations, bytes) of one image's ``hat_window_attn`` (one call a
    hybrid attention block) or ``overlap_attn`` (one a group) calls at its
    own, unpadded shape (the canvas's padding to the window's multiple and
    the kernel's padding of heads to 32 channels are not counted, so their
    waste shows): each 4 n C operations a token, n the keys a query sees
    (q k^T and P v), reading q, k and v once (3 C values a token) and the
    block's bias table once, and writing C values a token."""
    c, ws, ows = model["embed_dim"], model["window_size"], key_window(model)
    if kernel == "hat_window_attn":
        calls, n, rows = sum(model["depths"]), ws * ws, (2 * ws - 1) ** 2
    elif kernel == "overlap_attn":
        calls, n, rows = len(model["depths"]), ows * ows, (ws + ows - 1) ** 2
    else:
        return None
    px = h * w
    per_call = 4 * c * act_bytes * px + max(model["num_heads"]) * rows * 4
    return calls * 4.0 * n * c * px, float(calls * per_call)
