"""Operations and bytes of RRDBNet (ESRGAN) as published, counted from its
shapes: a multiply-add is two operations; activations, residual sums and the
nearest upsampling are left out (under 0.1% of the work)."""
from __future__ import annotations

import math


def rdb_macs_per_px(model: dict) -> int:
    """One dense block's five 3x3 convs per LR pixel: 239,616 at nf=64, gc=32."""
    nf, gc = model["nf"], model["gc"]
    return 9 * sum((nf + k * gc) * (gc if k < 4 else nf) for k in range(5))


def macs_per_lr_px(model: dict) -> int:
    """The whole network per input pixel: about 17.9 M at nf=64, nb=23, x4."""
    nf, s = model["nf"], model["scale"]
    n_up = int(math.log2(s))
    lr = 9 * model["in_nc"] * nf + 3 * model["nb"] * rdb_macs_per_px(model) + 9 * nf * nf
    ups = sum(9 * nf * nf * 4 ** (i + 1) for i in range(n_up))
    hr = s * s * 9 * nf * (nf + model["out_nc"])
    return lr + ups + hr


def image_flops(model: dict, h: int, w: int) -> float:
    return 2.0 * macs_per_lr_px(model) * h * w


def kernel_work(model: dict, kernel: str, h: int, w: int, act_bytes: int):
    """(operations, bytes) of one image's calls of ``kernel`` at its own,
    unpadded shape: ``fused_rdb`` is one dense block, 3 * nb calls an
    image; each reads its input and weights once and writes its output
    once."""
    if kernel != "fused_rdb":
        return None
    nf, gc, n = model["nf"], model["gc"], 3 * model["nb"]
    weights = 9 * sum((nf + k * gc) * (gc if k < 4 else nf) for k in range(5))
    per_call = 2 * h * w * nf * act_bytes + weights * act_bytes + (4 * gc + nf) * 4
    return n * 2.0 * rdb_macs_per_px(model) * h * w, float(n * per_call)
