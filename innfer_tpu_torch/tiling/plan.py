"""Static tile plans: where tiles come from and how they blend back.

The port's own copy of ``innfer_tpu/tiling/plan.py`` (numpy only).  The
reference's chop_forward (run.py:167-202) extracts overlapping patches and
recomposes with a linear seam ramp (utils/utils.py:318-445); a ``TilePlan``
precomputes the tile starts, the separable blend profile and the
reciprocal of the accumulated weight canvas.

The JAX package's ``align >= 64`` gate (a cost check for the Pallas
kernel's 64-multiple tile quantum) has no counterpart: the port's kernel
takes any tile, its quantum is 1, and it plans the grids the JAX package
plans on the CPU.
"""
from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np


def _starts(total: int, patch: int, step: int) -> List[int]:
    """Window starts of torch.unfold plus the clamped edge tile
    (utils/utils.py:354-362)."""
    s = list(range(0, total - patch + 1, step))
    if (total - patch) % step != 0:
        s.append(total - patch)
    return s


def _reference_blend(patch_sr: int, overlap: int) -> np.ndarray:
    """Separable blend profile: linspace(0.1, 1, overlap) ramps on both
    ends (utils/utils.py:413-416)."""
    if overlap > 0:
        ramp_in = np.linspace(0.1, 1.0, overlap, dtype=np.float64)
        mid = np.ones(max(patch_sr - 2 * overlap, 0), dtype=np.float64)
        prof = np.concatenate([ramp_in, mid, ramp_in[::-1]])
    else:
        prof = np.ones(patch_sr, dtype=np.float64)
    return prof[: patch_sr]


@dataclasses.dataclass(frozen=True, eq=False)
class TilePlan:
    """Everything static about one tiling configuration."""

    in_h: int
    in_w: int
    pad_h: int          # padded input height
    pad_w: int
    tile_h: int         # input-space tile size (rows)
    tile_w: int         # input-space tile size (cols)
    scale: int
    starts_h: Tuple[int, ...]  # input-space tile starts (within padded image)
    starts_w: Tuple[int, ...]
    blend: np.ndarray          # (tile_h*scale, tile_w*scale) float32 blend patch
    inv_weight: np.ndarray     # (pad_h*scale, pad_w*scale, 1) reciprocal canvas
    # planner-chosen dispatch-group tile count (0 = engine default)
    chunk: int = 0

    @property
    def n_tiles(self) -> int:
        return len(self.starts_h) * len(self.starts_w)

    @property
    def out_h(self) -> int:
        return self.in_h * self.scale

    @property
    def out_w(self) -> int:
        return self.in_w * self.scale


def _weight_canvas(plan_h: int, plan_w: int, starts_h, starts_w, blend: np.ndarray) -> np.ndarray:
    canvas = np.zeros((plan_h, plan_w), dtype=np.float64)
    th, tw = blend.shape
    for sh in starts_h:
        for sw in starts_w:
            canvas[sh: sh + th, sw: sw + tw] += blend
    return canvas


def make_uniform_plan(
    h: int, w: int, scale: int, *, tile: int = 256, overlap: int = 16,
    bucket: int = 0, tile_h: int = 0, tile_w: int = 0,
) -> TilePlan:
    """Uniform-grid plan over a reflect-padded image.  ``bucket`` > 0
    rounds the padded size up to a multiple; ``tile_h``/``tile_w``
    override ``tile`` per axis."""
    th = tile_h or tile
    tw = tile_w or tile
    if overlap >= min(th, tw):
        raise ValueError("overlap must be smaller than tile")

    def padded(dim: int, t: int, stride: int) -> int:
        if dim <= t:
            n = 1
        else:
            n = int(np.ceil((dim - overlap) / stride))
        p = n * stride + overlap
        if bucket:
            while p < int(np.ceil(dim / bucket)) * bucket:
                n += 1
                p = n * stride + overlap
        return max(p, t)

    stride_h, stride_w = th - overlap, tw - overlap
    ph, pw = padded(h, th, stride_h), padded(w, tw, stride_w)
    starts_h = tuple(range(0, ph - th + 1, stride_h))
    starts_w = tuple(range(0, pw - tw + 1, stride_w))

    blend = np.outer(_reference_blend(th * scale, overlap * scale),
                     _reference_blend(tw * scale, overlap * scale))
    canvas = _weight_canvas(ph * scale, pw * scale, [s * scale for s in starts_h],
                            [s * scale for s in starts_w], blend)
    inv = (1.0 / canvas).astype(np.float32)[..., None]
    return TilePlan(
        in_h=h, in_w=w, pad_h=ph, pad_w=pw, tile_h=th, tile_w=tw,
        scale=scale, starts_h=starts_h, starts_w=starts_w,
        blend=blend.astype(np.float32), inv_weight=inv,
    )


# the per-dispatch pixel cap of a tile group: the JAX package's
# TPU-measured constant, kept so that both packages plan and stack alike
MAX_GROUP_PX = 1_400_000


def make_auto_plan(
    h: int, w: int, scale: int, *, overlap: int = 16, tile_batch: int = 8,
    max_group_px: int = MAX_GROUP_PX, min_tile: int = 64, align: int = 8,
    fixed_chunk: bool = False,
) -> TilePlan:
    """Grid-fit planner: the (possibly rectangular) tile size whose grid
    covers H x W with the least processed pixels, where a config costs

        slots * tile_h * tile_w * batch_penalty(chunk),
        slots = ceil(n_tiles / chunk) * chunk

    subject to chunk * tile_px <= max_group_px; ties prefer fewer groups.
    The batch penalty and group cap are the JAX package's TPU-measured
    constants, kept so both packages plan the same grids; an H100
    re-measurement is a later slice's work.
    """

    def batch_penalty(chunk: int) -> float:
        if chunk >= 8:
            return 1.0
        return 2.0 if chunk <= 4 else 1.3

    def axis_options(dim: int, a: int):
        opts = []
        ax_align = a if dim >= a else 8
        max_n = max(1, -(-dim // min_tile))
        for n in range(1, max_n + 1):
            t = -(-(dim + (n - 1) * overlap) // n)
            t = -(-t // ax_align) * ax_align
            if t <= overlap:
                continue
            if n > 1 and (n - 1) * (t - overlap) + overlap >= dim + (t - overlap):
                continue  # n-1 tiles already cover: redundant grid
            covered = n * (t - overlap) + overlap if n > 1 else t
            opts.append((n, t, max(covered, t)))
        return opts

    best = None
    for nh, th, _ in axis_options(h, align):
        for nw, tw, _ in axis_options(w, align):
            n_tiles = nh * nw
            if fixed_chunk:
                chunk = tile_batch
                if chunk * th * tw > max_group_px:
                    continue
            else:
                chunk = min(tile_batch, n_tiles, max_group_px // max(1, th * tw))
                if chunk < 1:
                    continue
            groups = -(-n_tiles // chunk)
            slots = groups * chunk
            cost = (slots * th * tw * batch_penalty(chunk), groups, th * tw)
            if best is None or cost < best[0]:
                best = (cost, nh, th, nw, tw, chunk)
    if best is None:
        # degenerate (huge overlap / tiny cap): fall back to uniform
        return make_uniform_plan(h, w, scale, tile=min_tile * 2, overlap=overlap)
    _, nh, th, nw, tw, chunk = best

    stride_h, stride_w = th - overlap, tw - overlap
    ph = (nh - 1) * stride_h + th
    pw = (nw - 1) * stride_w + tw
    starts_h = tuple(i * stride_h for i in range(nh))
    starts_w = tuple(i * stride_w for i in range(nw))

    blend = np.outer(_reference_blend(th * scale, overlap * scale if nh > 1 else 0),
                     _reference_blend(tw * scale, overlap * scale if nw > 1 else 0))
    canvas = _weight_canvas(ph * scale, pw * scale, [s * scale for s in starts_h],
                            [s * scale for s in starts_w], blend)
    inv = (1.0 / canvas).astype(np.float32)[..., None]
    return TilePlan(
        in_h=h, in_w=w, pad_h=ph, pad_w=pw, tile_h=th, tile_w=tw,
        scale=scale, starts_h=starts_h, starts_w=starts_w,
        blend=blend.astype(np.float32), inv_weight=inv,
        chunk=0 if fixed_chunk else chunk,
    )


def make_cover_plan(h: int, w: int, scale: int, *, tile_h: int, tile_w: int,
                    overlap: int = 16, chunk: int = 0) -> TilePlan:
    """Clamped-grid plan over EXACT (h, w): uniform strides with the last
    tile clamped to the boundary, no padding.  Used by hybrid inference,
    whose tail tiles index the already-padded trunk feature map."""
    th, tw = min(tile_h, h), min(tile_w, w)
    if th < h and overlap >= th or tw < w and overlap >= tw:
        raise ValueError(
            f"overlap {overlap} must be smaller than the tile "
            f"({th}x{tw}) — a non-positive stride cannot cover the image")
    starts_h = tuple(_starts(h, th, th - overlap)) if th < h else (0,)
    starts_w = tuple(_starts(w, tw, tw - overlap)) if tw < w else (0,)

    blend = np.outer(
        _reference_blend(th * scale, overlap * scale if len(starts_h) > 1 else 0),
        _reference_blend(tw * scale, overlap * scale if len(starts_w) > 1 else 0))
    canvas = _weight_canvas(h * scale, w * scale, [s * scale for s in starts_h],
                            [s * scale for s in starts_w], blend)
    inv = (1.0 / canvas).astype(np.float32)[..., None]
    return TilePlan(
        in_h=h, in_w=w, pad_h=h, pad_w=w, tile_h=th, tile_w=tw,
        scale=scale, starts_h=starts_h, starts_w=starts_w,
        blend=blend.astype(np.float32), inv_weight=inv, chunk=chunk,
    )


def make_reference_plan(h: int, w: int, scale: int, *, patch: int = 200,
                        step: float = 0.5) -> TilePlan:
    """The reference chop grid exactly (run.py:167-202); rejects the
    odd-patch case where the reference's extraction and recompose grids
    disagree."""
    if not (0.5 <= step <= 1.0):
        raise ValueError("step must be in [0.5, 1.0] (utils/utils.py:391)")
    p = min(h, w, patch)
    step_in = int(p * step)
    starts_h = _starts(h, p, step_in)
    starts_w = _starts(w, p, step_in)

    # recompose-side grid (SR space with clamping, utils.py:425-426,439-440)
    p_sr = p * scale
    full_h, full_w = h * scale, w * scale
    eff = int(step * p_sr)
    step_sr = int(p_sr * step)
    nrow = 1 + (max(full_h, p_sr) - p_sr) // step_sr
    ncol = 1 + (max(full_w, p_sr) - p_sr) // step_sr
    n_h = nrow + 1 if (max(full_h, p_sr) - p_sr) % step_sr != 0 else nrow
    n_w = ncol + 1 if (max(full_w, p_sr) - p_sr) % step_sr != 0 else ncol
    if (n_h, n_w) != (len(starts_h), len(starts_w)):
        raise ValueError(
            f"reference tiling grids disagree for H={h} W={w} patch={p} "
            f"step={step} (odd patch sizes corrupt the reference recompose); "
            "use the uniform planner instead")
    rec_h = tuple(min(i * eff, full_h - p_sr) for i in range(n_h))
    rec_w = tuple(min(i * eff, full_w - p_sr) for i in range(n_w))
    if rec_h != tuple(s * scale for s in starts_h) or rec_w != tuple(
            s * scale for s in starts_w):
        raise ValueError("reference extraction/recompose grids disagree; use uniform mode")

    overlap = scale * int(round((1.0 - step) * (p_sr / scale)))
    blend = np.outer(_reference_blend(p_sr, overlap), _reference_blend(p_sr, overlap))
    canvas = _weight_canvas(full_h, full_w, rec_h, rec_w, blend)
    inv = (1.0 / canvas).astype(np.float32)[..., None]
    return TilePlan(
        in_h=h, in_w=w, pad_h=h, pad_w=w, tile_h=p, tile_w=p, scale=scale,
        starts_h=tuple(starts_h), starts_w=tuple(starts_w),
        blend=blend.astype(np.float32), inv_weight=inv,
    )
