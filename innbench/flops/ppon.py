"""Operations and bytes of PPON as published, counted from its shapes: a
multiply-add is two operations; activations, the cascade's and residual
sums, the branch sums and the nearest upsampling are left out (under 0.1%
of the work)."""
from __future__ import annotations

import math


def block_macs_per_px(model: dict) -> int:
    """One _ResBlock_32 per LR pixel: c1 (3x3, nf -> nf), eight dilated 3x3
    convs nf -> nf/2, c2 (1x1, 4 nf -> nf): 200,704 at nf=64."""
    nf = model["nf"]
    return 9 * nf * nf + 8 * 9 * nf * (nf // 2) + 4 * nf * nf


def n_blocks(model: dict) -> int:
    """Three blocks in each RRBlock: nb in CFEM, two in SFEM, two in PFEM."""
    return 3 * (model["nb"] + 4)


def macs_per_lr_px(model: dict) -> int:
    """The whole network per input pixel: 20,961,984 at nf=64, nb=24, x4 --
    the first conv, the 84 blocks, CFEM's trunk conv, and three branches of
    ESRGAN's x4 tail (upsampling convs, HR conv, last conv)."""
    nf, s = model["nf"], model["scale"]
    n_up = int(math.log2(s))
    lr = 9 * model["in_nc"] * nf + n_blocks(model) * block_macs_per_px(model) + 9 * nf * nf
    ups = sum(9 * nf * nf * 4 ** (i + 1) for i in range(n_up))
    hr = s * s * 9 * nf * (nf + model["out_nc"])
    return lr + 3 * (ups + hr)


def image_flops(model: dict, h: int, w: int) -> float:
    return 2.0 * macs_per_lr_px(model) * h * w


def kernel_work(model: dict, kernel: str, h: int, w: int, act_bytes: int):
    """(operations, bytes) of one image's ``fused_dilated_block`` calls at
    its own, unpadded shape (the hybrid trunk's padding to 64 rows is not
    counted): 84 calls an image, each reading its input and weights once
    and writing its output once, whatever it stages in between."""
    if kernel != "fused_dilated_block":
        return None
    nf, n = model["nf"], n_blocks(model)
    per_call = (2 * h * w * nf * act_bytes + block_macs_per_px(model) * act_bytes
                + (nf + 8 * (nf // 2) + nf) * 4)
    return n * 2.0 * block_macs_per_px(model) * h * w, float(n * per_call)
