"""Tiled and hybrid inference engine, in PyTorch.

The port's counterpart of ``innfer_tpu/tiling/engine.py``.  PyTorch runs
eagerly, so there is no compile cache: a runner keeps a plan per image
size and the plan's blend constants on the device.

  * ``tiled_apply``: reflect-pad, cut the plan's tiles, run them in groups
    of ``chunk``, and recompose with the linear seam blend (the JAX
    package's scatter-free concat form; one form is enough here).  A stack
    of B same-shape images shares its dispatch groups (cross-image tile
    stacking), which grow toward ``max_group_px``; each image recomposes
    from its own tiles.  On a device mesh (``parallel/mesh.py``) a group
    is ``tile_batch`` tiles, cut into even slices over the data devices.
  * ``hybrid_apply``: the whole-image LR trunk on an input padded to
    ``hybrid_dims`` (or the model's own ``hybrid_canvas``), then a tiled
    upsample tail recomposed the same way.

Spans (``observability.span``, recorded under a profiler): a runner's call
is ``innfer.tiling``, the hybrid trunk ``innfer.trunk``, each dispatch
group ``innfer.tile_group``; what ``innfer.tiling`` holds outside them is
the engine's own work (pad, cut, cast, recompose, crop).  Counters:
``tile_px``, the pixels of the tiles handed to the groups at the model's
input resolution, and ``tiled_px``, the unpadded image pixels they cover.
"""
from __future__ import annotations

import logging
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as TF

from innfer_tpu_torch.observability import count, span
from innfer_tpu_torch.parallel.mesh import Mesh, data_parallel
from innfer_tpu_torch.tiling.plan import (MAX_GROUP_PX, TilePlan, make_auto_plan,
                                          make_cover_plan, make_reference_plan,
                                          make_uniform_plan)

log = logging.getLogger("innfer_tpu_torch")

PlanConsts = Tuple[torch.Tensor, torch.Tensor]


def _pad_to(x: torch.Tensor, pad_h: int, pad_w: int) -> torch.Tensor:
    """Reflect-pad (B, H, W, C) at the bottom/right up to (pad_h, pad_w);
    edge padding when the pad is too large for reflection."""
    h, w = x.shape[1], x.shape[2]
    ph, pw = pad_h - h, pad_w - w
    if ph == 0 and pw == 0:
        return x
    mode = "reflect" if (ph < h and pw < w) else "replicate"
    out = TF.pad(x.permute(0, 3, 1, 2), (0, pw, 0, ph), mode=mode)
    return out.permute(0, 2, 3, 1).contiguous()


def pad_image(x: torch.Tensor, plan: TilePlan) -> torch.Tensor:
    """Reflect-pad (B, H, W, C) to the plan's padded size."""
    return _pad_to(x, plan.pad_h, plan.pad_w)


def extract_tiles(x: torch.Tensor, plan: TilePlan) -> torch.Tensor:
    """(B, pad_h, pad_w, C) -> (B * n_tiles, Th, Tw, C): image-major, each
    image's tiles in row-major order."""
    th, tw = plan.tile_h, plan.tile_w
    return torch.stack([x[b, sh: sh + th, sw: sw + tw] for b in range(x.shape[0])
                        for sh in plan.starts_h for sw in plan.starts_w])


def plan_consts(plan: TilePlan, device) -> PlanConsts:
    """The plan's blend patch (Th*s, Tw*s, 1) and reciprocal weight canvas
    as fp32 tensors on ``device``."""
    blend = torch.from_numpy(plan.blend)[..., None].to(device)
    inv = torch.from_numpy(plan.inv_weight).to(device)
    return blend, inv


def _axis_segments(starts, t: int, total: int):
    """Split [0, total) at every tile boundary into segments, each with the
    list of tiles covering it."""
    bounds = sorted({0, total, *starts, *[s + t for s in starts]})
    bounds = [b for b in bounds if 0 <= b <= total]
    segs = []
    for lo, hi in zip(bounds[:-1], bounds[1:]):
        cover = [i for i, s in enumerate(starts) if s <= lo and hi <= s + t]
        segs.append((lo, hi, cover))
    return segs


def recompose_tiles(tiles_sr: torch.Tensor, plan: TilePlan,
                    consts: Optional[PlanConsts] = None) -> torch.Tensor:
    """(n_tiles, Ts_h, Ts_w, C) SR tiles -> (1, out_h, out_w, C) fp32:
    accumulate blend-weighted tiles (fp32, row-major tile order per
    segment), multiply by the reciprocal weight canvas, crop."""
    blend, inv = consts or plan_consts(plan, tiles_sr.device)
    nh, nw = len(plan.starts_h), len(plan.starts_w)
    tsh, tsw = plan.tile_h * plan.scale, plan.tile_w * plan.scale
    c = tiles_sr.shape[-1]
    hp, wp = plan.pad_h * plan.scale, plan.pad_w * plan.scale
    wt = (tiles_sr.float() * blend).reshape(nh, nw, tsh, tsw, c)
    sh = [s * plan.scale for s in plan.starts_h]
    sw = [s * plan.scale for s in plan.starts_w]

    strips = []
    for i in range(nh):
        pieces = []
        for lo, hi, cover in _axis_segments(sw, tsw, wp):
            if cover:
                p = wt[i, cover[0], :, lo - sw[cover[0]]: hi - sw[cover[0]]]
                for j in cover[1:]:
                    p = p + wt[i, j, :, lo - sw[j]: hi - sw[j]]
            else:
                p = wt.new_zeros((tsh, hi - lo, c))
            pieces.append(p)
        strips.append(torch.cat(pieces, dim=1))
    rows = []
    for lo, hi, cover in _axis_segments(sh, tsh, hp):
        if cover:
            p = strips[cover[0]][lo - sh[cover[0]]: hi - sh[cover[0]]]
            for i in cover[1:]:
                p = p + strips[i][lo - sh[i]: hi - sh[i]]
        else:
            p = wt.new_zeros((hi - lo, wp, c))
        rows.append(p)
    canvas = torch.cat(rows, dim=0) * inv
    return canvas[None, : plan.out_h, : plan.out_w, :]


def _run_groups(fn: Callable, params, tiles: torch.Tensor, chunk: int,
                output_index: Optional[int] = None,
                mesh: Optional[Mesh] = None) -> torch.Tensor:
    """``fn`` over groups of ``chunk`` tiles, concatenated; a multi-output
    model's forward is cut to its ``output_index``.  On a ``mesh`` each
    group is cut into slices as even as its tiles allow, one per data
    device, each run there with that device's parameters
    (``parallel/mesh.data_parallel``); the last group keeps its natural
    size."""
    def run(p, t):
        out = fn(p, t)
        return out if output_index is None else out[output_index]

    outs = []
    for i in range(0, tiles.shape[0], chunk):
        group = tiles[i: i + chunk]
        with span("innfer.tile_group", group.device):
            outs.append(run(params, group) if mesh is None
                        else data_parallel(run, group, mesh, params))
    return torch.cat(outs)


def _count_tiles(plan: TilePlan, n_images: int, h: int, w: int) -> None:
    count("tile_px", n_images * plan.n_tiles * plan.tile_h * plan.tile_w)
    count("tiled_px", n_images * h * w)


def group_chunk(plan: TilePlan, n_images: int, *, tile_batch: int = 8,
                max_group_px: int = MAX_GROUP_PX) -> int:
    """Tiles per dispatch group for a stack of ``n_images``: the plan's
    chunk (default ``min(tile_batch, n_tiles)``) for one image; for a
    stack, grown toward ``max_group_px`` and cut to a multiple of 8 above
    8, the JAX package's group composition
    (innfer_tpu/tiling/engine.py:218-228)."""
    base = plan.chunk or min(tile_batch, plan.n_tiles)
    if n_images == 1:
        return base
    n = plan.n_tiles * n_images
    cap = max(1, max_group_px // max(1, plan.tile_h * plan.tile_w))
    chunk = min(n, max(base, cap))
    return chunk // 8 * 8 if chunk > 8 else chunk


def tiled_apply(apply_fn: Callable, params, x: torch.Tensor, plan: TilePlan, *,
                tile_batch: int = 8, output_index: Optional[int] = None,
                compute_dtype: Optional[torch.dtype] = None,
                consts: Optional[PlanConsts] = None,
                max_group_px: int = MAX_GROUP_PX,
                mesh: Optional[Mesh] = None) -> torch.Tensor:
    """Run ``apply_fn`` over all tiles of ``x`` (B, H, W, C) in groups of
    :func:`group_chunk` and recompose each image from its own tiles.

    B > 1 is cross-image tile stacking: the tiles of every image share the
    dispatch groups, so a stack of small images takes fewer, fuller
    launches.  The last group runs at its natural size (the JAX package
    pads it with zero tiles to keep one compiled shape).  On a ``mesh``
    a group is ``tile_batch`` tiles (a multiple of the data-axis size, as
    the session rounds it), split over the data devices, as the JAX
    package's (innfer_tpu/tiling/engine.py:218-240)."""
    n_im = x.shape[0]
    _count_tiles(plan, n_im, x.shape[1], x.shape[2])
    tiles = extract_tiles(pad_image(x, plan), plan)
    if compute_dtype is not None:
        tiles = tiles.to(compute_dtype)
    chunk = (tile_batch if mesh is not None else
             group_chunk(plan, n_im, tile_batch=tile_batch, max_group_px=max_group_px))
    out = _run_groups(apply_fn, params, tiles, chunk, output_index, mesh)
    n = plan.n_tiles
    return torch.cat([recompose_tiles(out[i * n: (i + 1) * n], plan, consts)
                      for i in range(n_im)])


def _wide_bw(tw: int) -> int:
    """Largest 16-multiple divisor of a wide width in [64, MAX_WIDE_BW]
    (0 if none); a copy of ``innfer_tpu/ops/pallas/rdb.py::_wide_bw``."""
    for bw in range(min(MAX_WIDE_BW, tw) // 16 * 16, 48, -16):
        if tw % bw == 0:
            return bw
    return 0


# The Pallas kernel's block-width caps (innfer_tpu/ops/pallas/rdb.py:470-478).
# They are not block sizes of the port's kernel: they fix hybrid_dims below.
MAX_BW = 320
MAX_WIDE_BW = 256


def hybrid_dims(h: int, w: int) -> tuple:
    """Padded dims of the whole-image trunk canvas, copied exactly from
    ``innfer_tpu/tiling/engine.py::hybrid_dims``: rows to the next
    64-multiple, width to the candidate in [w, w+63] minimizing padded px
    times the Pallas block's halo inflation.  1080x1920 -> 1088x1920.

    This is a border-semantics rule inherited from the TPU, not a block
    size of the port's kernel: the reflect-padded canvas changes border
    pixels of the trunk output, so the port pads exactly as the JAX
    package does for its hybrid output to match."""
    ph = -(-h // 64) * 64
    best = None
    for pw in range(-(-w // 16) * 16, w + 64, 16):
        bw = pw if pw <= MAX_BW else _wide_bw(pw)
        if bw < 64:
            continue
        cost = ph * pw * (bw + 16) / bw
        if best is None or cost < best[0]:
            best = (cost, pw)
    if best is None:
        best = (0, -(-w // 16) * 16)
    return ph, best[1]


def hybrid_apply(trunk_fn: Callable, tail_fn: Callable, params, x: torch.Tensor,
                 plan: TilePlan, *, tile_batch: int = 8,
                 compute_dtype: Optional[torch.dtype] = None,
                 out_h: int = 0, out_w: int = 0,
                 consts: Optional[PlanConsts] = None) -> torch.Tensor:
    """Whole-image trunk, tiled tail.  The trunk runs untiled on the
    reflect-padded image (exact whole-image math, no halo recompute); the
    tail is cut from the trunk's feature map by ``plan``, a cover plan
    over the padded dims, with overlap above the tail's receptive radius."""
    _count_tiles(plan, x.shape[0], x.shape[1], x.shape[2])
    xp = _pad_to(x, plan.pad_h, plan.pad_w)
    if compute_dtype is not None:
        xp = xp.to(compute_dtype)
    with span("innfer.trunk", xp.device):
        h = trunk_fn(params, xp)
    tiles = extract_tiles(h, plan)
    chunk = plan.chunk or min(tile_batch, plan.n_tiles)
    canvas = recompose_tiles(_run_groups(tail_fn, params, tiles, chunk), plan, consts)
    return canvas[:, : out_h or plan.out_h, : out_w or plan.out_w, :]


class TiledRunner:
    """Plan cache + tiled/hybrid execution per image size.

    ``mode``: ``uniform`` (fixed --tile grid), ``auto`` (grid-fit plan,
    upgraded to ``hybrid`` where :meth:`_hybrid_auto_eligible` says),
    ``reference`` (the reference's chop grid of ``patch`` pixels at
    ``step``, ``tiling/plan.make_reference_plan``) or ``hybrid``.
    ``output_index`` picks one output of a multi-output model (PPON, which
    has no trunk/tail split) on the tile grid.  A stack of images shares
    its tile groups (``tiled_apply``), except in hybrid mode, whose
    whole-image trunk runs one image at a time.  ``mesh``: the tile groups
    are split over its data devices (``tiled_apply``); hybrid mode, whose
    trunk is one whole-image forward, is refused on a mesh.
    ``hybrid_canvas``: the hybrid trunk's canvas for an h x w image (the
    model's ``ModelDef.hybrid_canvas``); by default :func:`hybrid_dims`.
    """

    # whole-trunk input-pixel cap for hybrid mode, the JAX package's
    # value; beyond it the runner uses the auto tile grid
    HYBRID_PX_CAP = 9_000_000

    def __init__(self, apply_fn: Callable, scale: int, *, mode: str = "uniform",
                 tile=256, overlap: int = 16, patch: int = 200, step: float = 0.5,
                 tile_batch: int = 8, max_group_px: int = MAX_GROUP_PX,
                 compute_dtype: Optional[torch.dtype] = None,
                 trunk_fn: Callable = None, tail_fn: Callable = None,
                 tail_halo: int = 0, trunk_kernel: bool = False,
                 output_index: Optional[int] = None, mesh: Optional[Mesh] = None,
                 hybrid_canvas: Optional[Callable[[int, int], Tuple[int, int]]] = None):
        if mode not in ("auto", "uniform", "reference", "hybrid"):
            raise ValueError(f"unknown tile mode {mode!r}; use auto, uniform, "
                             "reference or hybrid")
        if mode == "hybrid" and (trunk_fn is None or tail_fn is None):
            raise ValueError(
                "hybrid mode requires a model with a trunk/tail split "
                "(ModelDef.apply_trunk/apply_tail); this architecture "
                "does not expose one")
        if mode == "hybrid" and mesh is not None:
            raise NotImplementedError(
                "hybrid mode is single-chip; use --spatial for "
                "multi-chip whole-image forwards")
        self.apply_fn = apply_fn
        self.scale = scale
        self.mode = mode
        self.tile = tile
        self.overlap = overlap
        self.patch = patch
        self.step = step
        self.tile_batch = tile_batch
        self.max_group_px = max_group_px
        self.compute_dtype = compute_dtype
        self.trunk_fn = trunk_fn
        self.tail_fn = tail_fn
        self.tail_halo = tail_halo
        self.trunk_kernel = trunk_kernel
        self.output_index = output_index
        self.mesh = mesh
        self.hybrid_canvas = hybrid_canvas or hybrid_dims
        self._plans: Dict[tuple, TilePlan] = {}
        self._consts: Dict[tuple, PlanConsts] = {}
        self.last_mode: Optional[str] = None

    def _hybrid_auto_eligible(self, h: int, w: int, on_cuda: bool) -> bool:
        """An auto run upgrades to hybrid where the JAX package's does
        (innfer_tpu/tiling/engine.py:424-441): the model has a trunk/tail
        split, the image is within HYBRID_PX_CAP, and the trunk runs a
        port kernel on this device (``trunk_kernel`` and a CUDA tensor).
        The JAX gate also asks for bf16, because its Pallas kernel fires
        only in bf16; the port's kernel runs fp32 as well, so this gate
        does not.  A trunk of plain ops (SRResNet, ESRGAN with norm layers
        or prelu/swish) keeps the tile grid, and an
        instance-norm trunk keeps the per-tile statistics the JAX package
        computes.  As in the JAX package, a runner on a mesh never
        upgrades: its tile groups are what it splits over the devices."""
        return (on_cuda and self.mesh is None and self.trunk_kernel
                and self.trunk_fn is not None
                and self.tail_fn is not None and h * w <= self.HYBRID_PX_CAP)

    def mode_for(self, h: int, w: int, on_cuda: bool) -> str:
        if self.mode == "hybrid" and h * w > self.HYBRID_PX_CAP:
            return "auto"
        if self.mode == "auto" and self._hybrid_auto_eligible(h, w, on_cuda):
            return "hybrid"
        return self.mode

    def _hybrid_plan(self, h: int, w: int) -> TilePlan:
        ph, pw = self.hybrid_canvas(h, w)
        if isinstance(self.tile, (tuple, list)):
            # user-specified tail grid, overlap clamped up to the
            # seam-exactness bound (2 * tail_halo)
            tl = self.tile
            ov = max(self.overlap, 2 * self.tail_halo)
            if ov > self.overlap:
                log.warning("hybrid mode: overlap %d < 2*tail_halo (%d); "
                            "clamping to %d for seam-exactness",
                            self.overlap, 2 * self.tail_halo, ov)
        else:
            # planner-owned lean tail grid at the minimal exact overlap: the
            # tile height that covers the padded rows in the row count a
            # 576-tall anchor would use (the JAX package's rule)
            ov = 2 * self.tail_halo or self.overlap
            anchor = 576
            n_rows = max(1, -(-(ph - ov) // (anchor - ov)))
            th = -(-(ph + (n_rows - 1) * ov) // n_rows)
            tl = (th, min(self.tile, 256))
        return make_cover_plan(ph, pw, self.scale, tile_h=min(ph, tl[0]),
                               tile_w=min(pw, tl[1]), overlap=ov)

    def plan_for(self, h: int, w: int, on_cuda: bool = False) -> TilePlan:
        mode = self.mode_for(h, w, on_cuda)
        plan = self._plans.get((h, w, mode))
        if plan is None:
            if mode == "hybrid":
                plan = self._hybrid_plan(h, w)
            elif mode == "reference":
                plan = make_reference_plan(h, w, self.scale, patch=self.patch,
                                           step=self.step)
            elif mode == "auto":
                plan = make_auto_plan(h, w, self.scale, overlap=self.overlap,
                                      tile_batch=self.tile_batch,
                                      max_group_px=self.max_group_px)
            elif isinstance(self.tile, (tuple, list)):
                plan = make_uniform_plan(h, w, self.scale, tile_h=self.tile[0],
                                         tile_w=self.tile[1], overlap=self.overlap)
            else:
                plan = make_uniform_plan(h, w, self.scale, tile=self.tile,
                                         overlap=self.overlap)
            self._plans[(h, w, mode)] = plan
        return plan

    def _plan_consts(self, plan: TilePlan, device) -> PlanConsts:
        key = (id(plan), str(device))
        if key not in self._consts:
            self._consts[key] = plan_consts(plan, device)
        return self._consts[key]

    def __call__(self, params, x: torch.Tensor) -> torch.Tensor:
        h, w = x.shape[1], x.shape[2]
        mode = self.mode_for(h, w, x.is_cuda)
        if x.shape[0] > 1 and mode == "hybrid":
            # the whole-image trunk runs one image at a time, as the JAX
            # package's does (innfer_tpu/tiling/engine.py:531-539)
            return torch.cat([self(params, x[i: i + 1]) for i in range(x.shape[0])])
        plan = self.plan_for(h, w, x.is_cuda)
        consts = self._plan_consts(plan, x.device)
        self.last_mode = mode
        with span("innfer.tiling", x.device):
            if mode == "hybrid":
                return hybrid_apply(
                    self.trunk_fn, self.tail_fn, params, x, plan,
                    tile_batch=self.tile_batch,
                    compute_dtype=self.compute_dtype, out_h=h * self.scale,
                    out_w=w * self.scale, consts=consts)
            return tiled_apply(self.apply_fn, params, x, plan,
                               tile_batch=self.tile_batch, output_index=self.output_index,
                               compute_dtype=self.compute_dtype, consts=consts,
                               max_group_px=self.max_group_px, mesh=self.mesh)
