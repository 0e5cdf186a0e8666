"""Plain reference of CycleGAN's ResnetGenerator, as published:
junyanz/pytorch-CycleGAN-and-pix2pix ``models/networks.py`` with ``--netG
resnet_9blocks --ngf 64 --norm instance`` (InstanceNorm2d without affine or
running statistics, so every conv has a bias), reflect padding, transposed
convs up, tanh out; the released generators' key layout (``model.1`` the
7x7 conv, ``model.4`` and ``model.7`` the strided convs, ``model.<10+i>.
conv_block.{1,5}`` the blocks, then the transposed convs and the last 7x7
conv).  fp32 NCHW, no kernels; instance norm makes the output depend on the
program's cut of the image, which ``reference/plan.py`` works out.  Imports
nothing of the program."""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as TF

from innbench.reference import common, plan

EPS = 1e-5
# the program's whole-image estimate for this family: ngf channels, four
# fp32 maps live, per input pixel
def whole_bytes_per_px(model: dict) -> int:
    return model["ngf"] * 4 * 4


def _idx(model: dict) -> Tuple[int, int, int]:
    """Indices of the two transposed convs and of the last conv."""
    up0 = 10 + model["n_blocks"]
    return up0, up0 + 3, up0 + 7


def state_shapes(model: dict) -> List[Tuple[str, Tuple[int, ...], float, float, int]]:
    """(key, weight shape, weight std, bias mean, bias length): every conv at gain 1 (an
    instance norm follows all but the last), the transposed convs stored
    (in, out, k, k) as the checkpoint holds them."""
    ngf, nb = model["ngf"], model["n_blocks"]

    def c(key, o, i, k):
        return (key, (o, i, k, k), 1.0 / math.sqrt(i * k * k), 0.0, o)

    out = [c("model.1", ngf, model["input_nc"], 7), c("model.4", 2 * ngf, ngf, 3),
           c("model.7", 4 * ngf, 2 * ngf, 3)]
    for i in range(nb):
        out += [c(f"model.{10 + i}.conv_block.1", 4 * ngf, 4 * ngf, 3),
                c(f"model.{10 + i}.conv_block.5", 4 * ngf, 4 * ngf, 3)]
    up0, up1, last = _idx(model)
    out += [(f"model.{up0}", (4 * ngf, 2 * ngf, 3, 3), 1.0 / math.sqrt(4 * ngf * 9), 0.0, 2 * ngf),
            (f"model.{up1}", (2 * ngf, ngf, 3, 3), 1.0 / math.sqrt(2 * ngf * 9), 0.0, ngf),
            c(f"model.{last}", model["output_nc"], ngf, 7)]
    return out


def make_state(model: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The seeded weights, the last conv set so that a probe image's
    output before the tanh has mean 0 and ``out_std`` in each channel."""
    state = common.seeded_state(state_shapes(model), seed, device)
    cv = common.Convs(state)
    last = _idx(model)[2]

    common.calibrate_last(state, f"model.{last}", lambda x: forward(cv, x * 2 - 1, model, False),
                          common.probe(seed, device), 0.0, model["out_std"])
    return state


def forward(cv: common.Convs, x: torch.Tensor, model: dict, tanh: bool = True) -> torch.Tensor:
    """x in [-1, 1] -> tanh output in [-1, 1] (``tanh=False``: before it)."""
    def inorm(t):
        return TF.instance_norm(t, eps=EPS)

    h = torch.relu(inorm(cv.conv(TF.pad(x, (3,) * 4, mode="reflect"), "model.1")))
    h = torch.relu(inorm(cv.conv(h, "model.4", stride=2, padding=1)))
    h = torch.relu(inorm(cv.conv(h, "model.7", stride=2, padding=1)))
    for i in range(model["n_blocks"]):
        p = f"model.{10 + i}.conv_block"
        r = torch.relu(inorm(cv.conv(TF.pad(h, (1,) * 4, mode="reflect"), f"{p}.1")))
        h = h + inorm(cv.conv(TF.pad(r, (1,) * 4, mode="reflect"), f"{p}.5"))
        del r
    up0, up1, last = _idx(model)
    h = torch.relu(inorm(cv.conv_t(h, f"model.{up0}")))
    h = torch.relu(inorm(cv.conv_t(h, f"model.{up1}")))
    h = cv.conv(TF.pad(h, (3,) * 4, mode="reflect"), f"model.{last}")
    return torch.tanh(h) if tanh else h


def modes(model: dict, session: dict, shapes, *, on_cuda: bool,
          budget: Optional[int]) -> List[str]:
    """How the program runs each image: the CLI's batch for this family is
    0 (auto), so same-shape images gather into groups of ``auto_batch``
    (the largest power of two up to 32 whose stack runs whole-image or
    shares tile groups); a group of more than one that fits half the card
    runs whole-image, and any other image runs on the auto tile grid."""
    batch = session.get("batch", 0)

    def fits(n, h, w):
        return (plan.whole_fits(n, h * w, whole_bytes_per_px=whole_bytes_per_px(model),
                                budget=budget)
                or plan.tiled_fits(n, h * w, budget=budget))

    target = (lambda s: batch) if batch else (lambda s: plan.auto_batch(lambda n: fits(n, *s)))
    out = ["auto"] * len(shapes)
    for g in plan.groups(list(shapes), target):
        h, w = shapes[g[0]]
        if plan.whole_fits(len(g), h * w, whole_bytes_per_px=whole_bytes_per_px(model),
                           budget=budget):
            for i in g:
                out[i] = "whole"
    return out


def infer(state: Dict[str, torch.Tensor], rgb: np.ndarray, *, model: dict, session: dict,
          mode: str, precision: str = "fp32") -> np.ndarray:
    """One u8 RGB image through the network as the program cuts it; the
    input normalized to [-1, 1] and the output back to [0, 1], as the
    CycleGAN preset does."""
    dev = state["model.1.weight"].device
    cv = common.Convs(state, precision)
    x = torch.clamp((common.to_input(rgb, dev) - 0.5) * 2.0, -1.0, 1.0)
    h, w = rgb.shape[:2]
    with torch.no_grad(), common.true_fp32():
        if mode == "whole":
            y = forward(cv, x, model)
        elif mode == "auto":
            ap = plan.auto_plan(h, w, overlap=session["overlap"],
                                tile_batch=session["tile_batch"])
            y = plan.run_tiles(lambda t: forward(cv, t, model),
                               plan.pad_to(x, ap.pad_h, ap.pad_w), ap, 1)
        else:
            raise ValueError(f"mode {mode!r}")
        return common.to_u8(torch.clamp((y[..., :h, :w] + 1.0) / 2.0, 0.0, 1.0))
