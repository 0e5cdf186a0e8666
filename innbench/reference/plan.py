"""The benchmark's frozen copy of the program's plan arithmetic.

Where an output depends on how the image was cut (instance norm takes its
statistics per tile; zero padding at a tile's edge; the reflect padding of
the hybrid trunk's canvas; which images of a directory run stacked), the
reference has to cut the image as the program does.  This file works that
out again from the cell's own parameters (tile, overlap, tile batch, mode,
batch, the card's memory), as the program's rules stood when the benchmark
was written: the planner of ``tiling/plan.py``, ``hybrid_dims`` and the
hybrid tail grid of ``tiling/engine.py``, and the group sizes of
``pipeline.InferenceSession.auto_batch``.  It imports nothing of the
program; a later change of those rules shows as a failed comparison.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as TF

MAX_GROUP_PX = 1_400_000
HYBRID_PX_CAP = 9_000_000
MAX_BW, MAX_WIDE_BW = 320, 256


@dataclass(frozen=True)
class Plan:
    """Tiles of ``tile_h`` x ``tile_w`` input pixels at ``starts_h`` x
    ``starts_w`` over an image padded to ``pad_h`` x ``pad_w``, blended back
    with linear ramps of ``ov_h`` / ``ov_w`` input pixels."""

    pad_h: int
    pad_w: int
    tile_h: int
    tile_w: int
    starts_h: Tuple[int, ...]
    starts_w: Tuple[int, ...]
    ov_h: int
    ov_w: int


def _ramp(n: int, overlap: int) -> np.ndarray:
    if overlap <= 0:
        return np.ones(n)
    ramp = np.linspace(0.1, 1.0, overlap)
    return np.concatenate([ramp, np.ones(max(n - 2 * overlap, 0)), ramp[::-1]])[:n]


def blend(plan: Plan, scale: int) -> np.ndarray:
    """The separable blend patch of one output tile, (tile_h*s, tile_w*s)."""
    return np.outer(_ramp(plan.tile_h * scale, plan.ov_h * scale),
                    _ramp(plan.tile_w * scale, plan.ov_w * scale))


def auto_plan(h: int, w: int, *, overlap: int, tile_batch: int,
              max_group_px: int = MAX_GROUP_PX, min_tile: int = 64, align: int = 8) -> Plan:
    """The grid-fit planner: the tile size whose grid covers h x w with the
    fewest processed pixels, each dispatch slot costed with a batch
    penalty, ties to fewer groups, then smaller tiles."""

    def penalty(chunk: int) -> float:
        return 1.0 if chunk >= 8 else (2.0 if chunk <= 4 else 1.3)

    def options(dim: int):
        a = align if dim >= align else 8
        out = []
        for n in range(1, max(1, -(-dim // min_tile)) + 1):
            t = -(-(dim + (n - 1) * overlap) // n)
            t = -(-t // a) * a
            if t <= overlap:
                continue
            if n > 1 and (n - 1) * (t - overlap) + overlap >= dim + (t - overlap):
                continue
            out.append((n, t))
        return out

    best = None
    for nh, th in options(h):
        for nw, tw in options(w):
            n = nh * nw
            chunk = min(tile_batch, n, max_group_px // max(1, th * tw))
            if chunk < 1:
                continue
            groups = -(-n // chunk)
            cost = (groups * chunk * th * tw * penalty(chunk), groups, th * tw)
            if best is None or cost < best[0]:
                best = (cost, nh, th, nw, tw)
    if best is None:
        raise ValueError(f"no auto grid for {h}x{w} at overlap {overlap}")
    _, nh, th, nw, tw = best
    return Plan((nh - 1) * (th - overlap) + th, (nw - 1) * (tw - overlap) + tw, th, tw,
                tuple(i * (th - overlap) for i in range(nh)),
                tuple(i * (tw - overlap) for i in range(nw)),
                overlap if nh > 1 else 0, overlap if nw > 1 else 0)


def _clamped_starts(total: int, t: int, step: int) -> Tuple[int, ...]:
    s = list(range(0, total - t + 1, step))
    if (total - t) % step:
        s.append(total - t)
    return tuple(s)


def cover_plan(h: int, w: int, tile_h: int, tile_w: int, overlap: int) -> Plan:
    """Clamped grid over exactly h x w, the last tile flush with the edge."""
    th, tw = min(tile_h, h), min(tile_w, w)
    sh = _clamped_starts(h, th, th - overlap) if th < h else (0,)
    sw = _clamped_starts(w, tw, tw - overlap) if tw < w else (0,)
    return Plan(h, w, th, tw, sh, sw, overlap if len(sh) > 1 else 0,
                overlap if len(sw) > 1 else 0)


def hybrid_dims(h: int, w: int) -> Tuple[int, int]:
    """The hybrid trunk's canvas: rows up to a multiple of 64; the width in
    [w, w + 63], a multiple of 16, of least cost padded pixels times a
    block's halo share."""
    def wide_bw(tw: int) -> int:
        for bw in range(min(MAX_WIDE_BW, tw) // 16 * 16, 48, -16):
            if tw % bw == 0:
                return bw
        return 0

    ph = -(-h // 64) * 64
    best = None
    for pw in range(-(-w // 16) * 16, w + 64, 16):
        bw = pw if pw <= MAX_BW else wide_bw(pw)
        if bw < 64:
            continue
        cost = ph * pw * (bw + 16) / bw
        if best is None or cost < best[0]:
            best = (cost, pw)
    return ph, (best[1] if best else -(-w // 16) * 16)


def hybrid_tail_plan(h: int, w: int, *, tile: int, tail_halo: int) -> Plan:
    """The tail's grid over the hybrid canvas: overlap 2 * tail_halo, tile
    rows that cover the canvas in as many rows as 576-row tiles would, and
    tile columns of at most 256."""
    ph, pw = hybrid_dims(h, w)
    ov = 2 * tail_halo
    n_rows = max(1, -(-(ph - ov) // (576 - ov)))
    th = -(-(ph + (n_rows - 1) * ov) // n_rows)
    return cover_plan(ph, pw, min(ph, th), min(pw, min(tile, 256)), ov)


def tile_mode(mode: str, h: int, w: int, *, kernel_trunk: bool, on_cuda: bool) -> str:
    """``auto`` runs hybrid (whole-image trunk, tiled tail) where the trunk
    is a port kernel on the card and the image is within the cap."""
    if mode == "auto" and kernel_trunk and on_cuda and h * w <= HYBRID_PX_CAP:
        return "hybrid"
    return mode


def pad_to(x: torch.Tensor, ph: int, pw: int) -> torch.Tensor:
    """Reflect-pad NCHW at the bottom and right (replicate where the pad is
    as large as the image)."""
    h, w = x.shape[-2:]
    if (ph, pw) == (h, w):
        return x
    mode = "reflect" if (ph - h < h and pw - w < w) else "replicate"
    return TF.pad(x, (0, pw - w, 0, ph - h), mode=mode)


def run_tiles(fn, x: torch.Tensor, plan: Plan, scale: int) -> torch.Tensor:
    """``fn`` on each tile of an NCHW ``x`` already padded to the plan, one
    tile at a time, blended back in fp32 and divided by the summed weights;
    (1, C, pad_h * s, pad_w * s)."""
    wt = torch.from_numpy(blend(plan, scale)).to(x.device, torch.float32)
    acc, norm = None, torch.zeros(plan.pad_h * scale, plan.pad_w * scale,
                                  device=x.device, dtype=torch.float32)
    th, tw = plan.tile_h * scale, plan.tile_w * scale
    for sh in plan.starts_h:
        for sw in plan.starts_w:
            y = fn(x[..., sh:sh + plan.tile_h, sw:sw + plan.tile_w]).float()
            if acc is None:
                acc = torch.zeros(y.shape[0], y.shape[1], plan.pad_h * scale,
                                  plan.pad_w * scale, device=x.device, dtype=torch.float32)
            acc[..., sh * scale:sh * scale + th, sw * scale:sw * scale + tw] += y * wt
            norm[sh * scale:sh * scale + th, sw * scale:sw * scale + tw] += wt
            del y
    return acc / norm


def whole_fits(n: int, px: int, *, whole_bytes_per_px: int, budget: Optional[int]) -> bool:
    """Whether ``n`` stacked images of ``px`` pixels run as one whole-image
    forward: more than one, within half the card (``budget``; None, no
    limit)."""
    return n > 1 and (budget is None or n * px * whole_bytes_per_px <= budget)


def tiled_fits(n: int, out_px: int, *, budget: Optional[int]) -> bool:
    """Whether ``n`` stacked images share tile groups: 24 bytes per output
    pixel of the stack, with 2 GiB kept for a group's activations."""
    return n > 1 and (budget is None or n * out_px * 24 < budget - 2 * 1024 ** 3)


def auto_batch(fits, cap: int = 32) -> int:
    """Images per group of a ``batch=0`` directory: the largest power of
    two up to ``cap`` for which ``fits(n)``."""
    n = 1
    while n * 2 <= cap and fits(n * 2):
        n *= 2
    return n


def groups(shapes: List[Tuple[int, int]], target) -> List[List[int]]:
    """Indices of a directory's images (in processing order) by stacked
    group: same-shape images gather until their group holds
    ``target(shape)``; the groups left open run at the end, in the order
    their shapes first appeared."""
    done, pending = [], {}
    for i, s in enumerate(shapes):
        g = pending.setdefault(s, [])
        g.append(i)
        if len(g) == target(s):
            done.append(g)
            pending[s] = []
    return done + [g for g in pending.values() if g]
