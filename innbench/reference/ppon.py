"""Plain reference of PPON x4, as published: Hui et al., arXiv:1907.10399,
github.com/Zheng222/PPON ``PPON(in_nc=3, nf=64, nb=24, out_nc=3,
upscale=4)`` in the key layout iNNfer's ``PPON_arch.py`` loads (``CFEM.0``
the first conv, ``CFEM.1.sub.<i>.RB<j>.{c1,d1..d8,c2}`` the blocks,
``CFEM.1.sub.<nb>`` the trunk conv, ``SFEM.<i>`` and ``PFEM.<i>`` two
RRBlocks each, then the three reconstruction branches ``CRM``, ``SRM`` and
``PRM``: nearest x2 and a conv per factor of two, the HR conv, the last
conv).  The output is the perceptual one, ``alpha * PRM(pfem) + SRM(sfem) +
CRM(cfem)``.  fp32 NCHW, no kernels; the program's cut of the image (the
hybrid trunk canvas and tail tiles, or the tile grid) is worked out by
``reference/plan.py``.  Imports nothing of the program."""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as TF

from innbench.reference import common, plan

RES_SCALE = 0.2
RATES = 8
BRANCHES = ("CRM", "SRM", "PRM")
# each branch is ESRGAN's upsampling tail: its reach in LR pixels sets the
# tail tiles' overlap (2x this) in the program's hybrid mode
TAIL_HALO = 4
# the width at which the program's block kernel runs the trunk (and auto
# mode goes hybrid on the card)
KERNEL_NF = 64


def _lrelu(x: torch.Tensor, slope: float) -> torch.Tensor:
    return TF.leaky_relu(x, slope)


def _branch_keys(model: dict) -> Tuple[List[int], int]:
    """The upsampling convs' indices in a branch, and the HR conv's."""
    n_up = int(math.log2(model["scale"]))
    return [3 * i + 1 for i in range(n_up)], 3 * n_up


def _rrblocks(model: dict) -> List[str]:
    nb = model["nb"]
    return ([f"CFEM.1.sub.{i}" for i in range(nb)] + [f"SFEM.{i}" for i in range(2)]
            + [f"PFEM.{i}" for i in range(2)])


def state_shapes(model: dict) -> List[Tuple[str, Tuple[int, ...], float, float, int]]:
    """(key, weight shape, weight std, bias mean, bias length) of every conv.
    A conv followed by the leaky ReLU gets He's gain for it; the eight
    dilated convs share that gain (1/sqrt(8) each), since their running sum
    meets the ReLU; c2 and the first conv gain 1.  Each RRBlock returns
    about 1.2 times its input (the 0.2-scaled skip over blocks that each
    add a 0.2-scaled update), so CFEM's trunk conv's gain is 1.2 ** -nb.
    The three last convs' scales are set by :func:`make_state`."""
    nf, slope = model["nf"], model["neg_slope"]
    act = math.sqrt(2.0 / (1.0 + slope ** 2))

    def c(key, o, i, gain, k=3):
        return (key, (o, i, k, k), gain / math.sqrt(i * k * k), 0.0, o)

    out = [c("CFEM.0", nf, model["in_nc"], 1.0)]
    for rr in _rrblocks(model)[:model["nb"]]:
        out += _rrblock_shapes(c, rr, nf, act)
    out.append(c(f"CFEM.1.sub.{model['nb']}", nf, nf, (1.0 + RES_SCALE) ** -model["nb"]))
    for rr in _rrblocks(model)[model["nb"]:]:
        out += _rrblock_shapes(c, rr, nf, act)
    ups, hr = _branch_keys(model)
    for br in BRANCHES:
        out += [c(f"{br}.{i}", nf, nf, act) for i in ups]
        out.append(c(f"{br}.{hr}", nf, nf, act))
        out.append(c(f"{br}.{hr + 2}", model["out_nc"], nf, 1.0))
    return out


def _rrblock_shapes(c, prefix: str, nf: int, act: float):
    out = []
    for j in (1, 2, 3):
        p = f"{prefix}.RB{j}"
        out.append(c(f"{p}.c1", nf, nf, act))
        out += [c(f"{p}.d{r}", nf // 2, nf, act / math.sqrt(RATES)) for r in range(1, RATES + 1)]
        out.append(c(f"{p}.c2", nf, 4 * nf, 1.0, k=1))
    return out


def make_state(model: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The seeded weights, each branch's last conv set on a probe image:
    CRM's output to mean 0.5, SRM's and PRM's to mean 0, each to
    ``out_std`` / sqrt(3) in each channel, so that their sum is an image."""
    state = common.seeded_state(state_shapes(model), seed, device)
    cv = common.Convs(state)
    x = common.probe(seed, device)
    with torch.no_grad(), common.true_fp32():
        feats = trunk(cv, x, model)
    _ups, hr = _branch_keys(model)
    std = model["out_std"] / math.sqrt(len(BRANCHES))
    for br, f, mean in zip(BRANCHES, feats, (0.5, 0.0, 0.0)):
        common.calibrate_last(state, f"{br}.{hr + 2}", lambda t, br=br: branch(cv, t, model, br),
                              f, mean, std)
    return state


def _dconv(cv: common.Convs, x: torch.Tensor, key: str, r: int) -> torch.Tensor:
    """A 3x3 conv of dilation r with zero padding r, its operands rounded as
    ``cv``'s precision says."""
    w = common.quantize(cv.state[f"{key}.weight"], cv.precision)
    return TF.conv2d(common.quantize(x, cv.precision), w, cv.state.get(f"{key}.bias"),
                     padding=r, dilation=r)


def res_block(cv: common.Convs, x: torch.Tensor, prefix: str, slope: float) -> torch.Tensor:
    """_ResBlock_32: h = lrelu(c1(x)); the eight dilated convs of h summed
    as a running cascade; lrelu over the concat of the eight sums; the 1x1
    c2; x + 0.2 * that."""
    h = _lrelu(cv.conv(x, f"{prefix}.c1", padding=1), slope)
    acc, sums = None, []
    for r in range(1, RATES + 1):
        d = _dconv(cv, h, f"{prefix}.d{r}", r)
        acc = d if acc is None else acc + d
        sums.append(acc)
    del h
    out = cv.conv(_lrelu(torch.cat(sums, 1), slope), f"{prefix}.c2")
    return x + out * RES_SCALE


def rrblock(cv: common.Convs, x: torch.Tensor, prefix: str, slope: float) -> torch.Tensor:
    out = x
    for j in (1, 2, 3):
        out = res_block(cv, out, f"{prefix}.RB{j}", slope)
    return out * RES_SCALE + x


def trunk(cv: common.Convs, x: torch.Tensor, model: dict):
    """CFEM (first conv, nb RRBlocks, trunk conv, the long skip), then SFEM
    and PFEM (two RRBlocks each): the three feature maps."""
    slope, nb = model["neg_slope"], model["nb"]
    fea = cv.conv(x, "CFEM.0", padding=1)
    t = fea
    for i in range(nb):
        t = rrblock(cv, t, f"CFEM.1.sub.{i}", slope)
    cfem = fea + cv.conv(t, f"CFEM.1.sub.{nb}", padding=1)
    sfem = cfem
    for i in range(2):
        sfem = rrblock(cv, sfem, f"SFEM.{i}", slope)
    pfem = sfem
    for i in range(2):
        pfem = rrblock(cv, pfem, f"PFEM.{i}", slope)
    return cfem, sfem, pfem


def branch(cv: common.Convs, h: torch.Tensor, model: dict, br: str) -> torch.Tensor:
    """One reconstruction branch: nearest x2 and a conv with the leaky ReLU
    per factor of two; then HR conv, leaky ReLU, last conv."""
    slope = model["neg_slope"]
    ups, hr = _branch_keys(model)
    for i in ups:
        h = _lrelu(cv.conv(TF.interpolate(h, scale_factor=2, mode="nearest"), f"{br}.{i}",
                           padding=1), slope)
    return cv.conv(_lrelu(cv.conv(h, f"{br}.{hr}", padding=1), slope), f"{br}.{hr + 2}",
                   padding=1)


def tail(cv: common.Convs, feats, model: dict) -> torch.Tensor:
    """The perceptual output: alpha * PRM(pfem) + (SRM(sfem) + CRM(cfem))."""
    cfem, sfem, pfem = feats
    out_c = branch(cv, cfem, model, "CRM")
    out_s = branch(cv, sfem, model, "SRM") + out_c
    return model["alpha"] * branch(cv, pfem, model, "PRM") + out_s


def modes(model: dict, session: dict, shapes, *, on_cuda: bool,
          budget: Optional[int]) -> List[str]:
    """How the program runs each image of a directory (or one frame): one
    image at a time, in ``auto`` mode hybrid on the card, where the port's
    block kernel runs the trunk (at nf 64)."""
    return [plan.tile_mode(session["tile_mode"], h, w, kernel_trunk=model["nf"] == KERNEL_NF,
                           on_cuda=on_cuda) for h, w in shapes]


def infer(state: Dict[str, torch.Tensor], rgb: np.ndarray, *, model: dict, session: dict,
          mode: str, precision: str = "fp32") -> np.ndarray:
    """One u8 RGB image through the network as the program cuts it."""
    dev = state["CFEM.0.weight"].device
    cv = common.Convs(state, precision)
    x = common.to_input(rgb, dev)
    h, w = rgb.shape[:2]
    s = model["scale"]
    with torch.no_grad(), common.true_fp32():
        if mode == "hybrid":
            ph, pw = plan.hybrid_dims(h, w)
            feats = torch.cat(trunk(cv, plan.pad_to(x, ph, pw), model), 1)
            tp = plan.hybrid_tail_plan(h, w, tile=session["tile"], tail_halo=TAIL_HALO)
            y = plan.run_tiles(lambda t: tail(cv, torch.chunk(t, 3, 1), model), feats, tp, s)
        elif mode == "auto":
            ap = plan.auto_plan(h, w, overlap=session["overlap"],
                                tile_batch=session["tile_batch"])
            y = plan.run_tiles(lambda t: tail(cv, trunk(cv, t, model), model),
                               plan.pad_to(x, ap.pad_h, ap.pad_w), ap, s)
        else:
            raise ValueError(f"mode {mode!r}")
        return common.to_u8(y[..., :h * s, :w * s])
