"""Operations and bytes of CycleGAN's ResnetGenerator as published, counted
from its shapes: a multiply-add is two operations; instance norms, ReLUs,
padding, the residual sums and tanh are left out (under 0.5% of the work)."""
from __future__ import annotations


def block_macs_per_px(model: dict) -> float:
    """One residual block's two 3x3 convs of 4*ngf channels at a quarter of
    the resolution, per input pixel."""
    c = 4 * model["ngf"]
    return 2 * 9 * c * c / 16


def macs_per_px(model: dict) -> float:
    """The whole network per input pixel: 756,096 at ngf=64, 9 blocks."""
    ngf, cin, cout = model["ngf"], model["input_nc"], model["output_nc"]
    convs = 49 * cin * ngf + 9 * ngf * 2 * ngf / 4 + 9 * 2 * ngf * 4 * ngf / 16
    ups = 9 * 4 * ngf * 2 * ngf / 16 + 9 * 2 * ngf * ngf / 4
    return convs + model["n_blocks"] * block_macs_per_px(model) + ups + 49 * ngf * cout


def image_flops(model: dict, h: int, w: int) -> float:
    return 2.0 * macs_per_px(model) * h * w


def kernel_work(model: dict, kernel: str, h: int, w: int, act_bytes: int):
    """(operations, bytes) of one image's ``fused_resnet_block`` calls,
    counted once at the whole image's shape (H/4 x W/4), whatever tiles the
    program cut: each block reads its input and weights once and writes its
    output once."""
    if kernel != "fused_resnet_block":
        return None
    c, n = 4 * model["ngf"], model["n_blocks"]
    px = (h // 4) * (w // 4)
    per_call = 2 * px * c * act_bytes + 2 * 9 * c * c * act_bytes + 2 * c * 4
    return n * 2.0 * 2 * 9 * c * c * px, float(n * per_call)
