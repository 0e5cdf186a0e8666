"""Plain reference of RRDBNet (ESRGAN), as published: xinntao/ESRGAN
``RRDBNet_arch.py`` in the old-architecture key layout of the released
``RRDB_ESRGAN_x4.pth`` (``model.0`` the first conv, ``model.1.sub.<i>.RDB<j>
.conv<k>.0`` the dense blocks, ``model.1.sub.<nb>`` the trunk conv, then the
upsampling convs and the two HR convs).  fp32 NCHW, no kernels; the program's
cut of the image (the hybrid trunk canvas and tail tiles, or the tile grid)
is worked out by ``reference/plan.py``.  Imports nothing of the program."""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as TF

from innbench.reference import common, plan

RES_SCALE = 0.2
# ESRGAN's upsampling-tail reach in LR pixels, which sets the tail tiles'
# overlap (2x this) in the program's hybrid mode
TAIL_HALO = 4


def _lrelu(x: torch.Tensor, slope: float) -> torch.Tensor:
    return TF.leaky_relu(x, slope)


def _up_keys(model: dict) -> Tuple[List[int], int]:
    """The upsampling convs' indices and the first HR conv's."""
    n_up = int(math.log2(model["scale"]))
    ups = [3 + 3 * i for i in range(n_up)]
    return ups, 2 + 3 * n_up


def state_shapes(model: dict) -> List[Tuple[str, Tuple[int, ...], float, float, int]]:
    """(key, weight shape, weight std, bias mean, bias length) of every conv.
    A conv followed by the leaky ReLU gets He's gain for it, the others gain
    1, so activations keep their size through the depth; each RRDB returns
    about 1.2 times its input (its dense blocks' sum plus the 0.2-scaled
    skip), so the trunk conv's gain is 1.2 ** -nb.  The last conv's scale
    is set by :func:`make_state`."""
    nf, gc, nb, slope = model["nf"], model["gc"], model["nb"], model["neg_slope"]
    act = math.sqrt(2.0 / (1.0 + slope ** 2))

    def c(key, o, i, gain, mean=0.0, k=3):
        return (key, (o, i, k, k), gain / math.sqrt(i * k * k), mean, o)

    out = [c("model.0", nf, model["in_nc"], 1.0)]
    for b in range(nb):
        for j in (1, 2, 3):
            p = f"model.1.sub.{b}.RDB{j}"
            for k in range(1, 6):
                out.append(c(f"{p}.conv{k}.0", gc if k < 5 else nf, nf + (k - 1) * gc,
                             act if k < 5 else 1.0))
    out.append(c(f"model.1.sub.{nb}", nf, nf, (1.0 + RES_SCALE) ** -nb))
    ups, hr = _up_keys(model)
    out += [c(f"model.{i}", nf, nf, act) for i in ups]
    out.append(c(f"model.{hr}", nf, nf, act))
    out.append(c(f"model.{hr + 2}", model["out_nc"], nf, 1.0))
    return out


def make_state(model: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The seeded weights, the last conv set so that a probe image's output
    has mean 0.5 and ``out_std`` in each channel."""
    state = common.seeded_state(state_shapes(model), seed, device)
    cv = common.Convs(state)
    common.calibrate_last(state, f"model.{_up_keys(model)[1] + 2}",
                          lambda x: tail(cv, trunk(cv, x, model), model),
                          common.probe(seed, device), 0.5, model["out_std"])
    return state


def trunk(cv: common.Convs, x: torch.Tensor, model: dict) -> torch.Tensor:
    """First conv, nb RRDBs (three dense blocks each, both residuals scaled
    by 0.2), trunk conv, and the long skip."""
    slope = model["neg_slope"]
    fea = cv.conv(x, "model.0", padding=1)
    t = fea
    for b in range(model["nb"]):
        r = t
        for j in (1, 2, 3):
            p = f"model.1.sub.{b}.RDB{j}"
            feats = [t]
            for k in range(1, 5):
                feats.append(_lrelu(cv.conv(torch.cat(feats, 1), f"{p}.conv{k}.0", padding=1),
                                    slope))
            t = cv.conv(torch.cat(feats, 1), f"{p}.conv5.0", padding=1) * RES_SCALE + t
            del feats
        t = t * RES_SCALE + r
    return fea + cv.conv(t, f"model.1.sub.{model['nb']}", padding=1)


def tail(cv: common.Convs, h: torch.Tensor, model: dict) -> torch.Tensor:
    """Nearest x2 and a conv with the leaky ReLU, per factor of two; then
    HR conv, leaky ReLU, last conv."""
    slope = model["neg_slope"]
    ups, hr = _up_keys(model)
    for i in ups:
        h = _lrelu(cv.conv(TF.interpolate(h, scale_factor=2, mode="nearest"), f"model.{i}",
                           padding=1), slope)
    return cv.conv(_lrelu(cv.conv(h, f"model.{hr}", padding=1), slope),
                   f"model.{hr + 2}", padding=1)


def modes(model: dict, session: dict, shapes, *, on_cuda: bool,
          budget: Optional[int]) -> List[str]:
    """How the program runs each image of a directory (or one frame): one
    image at a time (the CLI's batch for this family), in ``auto`` mode
    hybrid on the card, where the port's RDB kernel runs the trunk."""
    return [plan.tile_mode(session["tile_mode"], h, w, kernel_trunk=True, on_cuda=on_cuda)
            for h, w in shapes]


def infer(state: Dict[str, torch.Tensor], rgb: np.ndarray, *, model: dict, session: dict,
          mode: str, precision: str = "fp32") -> np.ndarray:
    """One u8 RGB image through the network as the program cuts it."""
    dev = state["model.0.weight"].device
    cv = common.Convs(state, precision)
    x = common.to_input(rgb, dev)
    h, w = rgb.shape[:2]
    s = model["scale"]
    with torch.no_grad(), common.true_fp32():
        if mode == "hybrid":
            ph, pw = plan.hybrid_dims(h, w)
            feats = trunk(cv, plan.pad_to(x, ph, pw), model)
            tp = plan.hybrid_tail_plan(h, w, tile=session["tile"], tail_halo=TAIL_HALO)
            y = plan.run_tiles(lambda t: tail(cv, t, model), feats, tp, s)
        elif mode == "auto":
            ap = plan.auto_plan(h, w, overlap=session["overlap"],
                                tile_batch=session["tile_batch"])
            y = plan.run_tiles(lambda t: tail(cv, trunk(cv, t, model), model),
                               plan.pad_to(x, ap.pad_h, ap.pad_w), ap, s)
        else:
            raise ValueError(f"mode {mode!r}")
        return common.to_u8(y[..., :h * s, :w * s])
