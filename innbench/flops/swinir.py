"""Operations and bytes of SwinIR as published, counted from its shapes: a
multiply-add is two operations; LayerNorms, GELU, the softmax, the
relative-position bias and mask, residual sums and the nearest upsampling
are left out (under 0.5% of the work)."""
from __future__ import annotations


def layer_macs_per_px(model: dict) -> int:
    """One Swin transformer layer per LR pixel (token): qkv C x 3C, q k^T and
    P v over a window of ws^2 tokens, proj C x C, fc1 and fc2 C x hidden:
    282,240 at C = 180, window 8, mlp_ratio 2."""
    c, n = model["embed_dim"], model["window_size"] ** 2
    hidden = int(c * model["mlp_ratio"])
    return 3 * c * c + 2 * n * c + c * c + 2 * c * hidden


def macs_per_lr_px(model: dict) -> int:
    """The whole network per input pixel: 13,665,132 for SwinIR-M x4 --
    conv_first, the layers, each group's conv and conv_after_body,
    conv_before_upsample, and ESRGAN's x4 tail (conv_up1 at 2x, conv_up2,
    conv_hr and conv_last at 4x)."""
    c, nf, cin, s = model["embed_dim"], model["num_feat"], model["in_chans"], model["scale"]
    layers = sum(model["depths"]) * layer_macs_per_px(model)
    convs = (len(model["depths"]) + 1) * 9 * c * c
    tail = 9 * nf * nf * (4 + 16 + 16) + 16 * 9 * nf * cin
    return 9 * cin * c + layers + convs + 9 * c * nf + tail


def image_flops(model: dict, h: int, w: int) -> float:
    return 2.0 * macs_per_lr_px(model) * h * w


def kernel_work(model: dict, kernel: str, h: int, w: int, act_bytes: int):
    """(operations, bytes) of one image's ``window_attn`` calls at its own,
    unpadded shape (the canvas's padding to the window's multiple, and the
    kernel's padding of heads to 32 channels, are not counted, so their
    waste shows): one call a layer, each 4 ws^2 C operations a token (q k^T
    and P v), reading q, k and v once (3 C values a token) and the layer's
    bias table once, and writing C values a token."""
    if kernel != "window_attn":
        return None
    c, n = model["embed_dim"], model["window_size"] ** 2
    layers = sum(model["depths"])
    px = h * w
    per_call = 4 * c * act_bytes * px + max(model["num_heads"]) * n * n * 4
    return layers * 4.0 * n * c * px, float(layers * per_call)
