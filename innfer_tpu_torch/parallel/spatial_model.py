"""Whole-model spatially-sharded inference: one huge image, H-sharded.

The port's counterpart of ``innfer_tpu/parallel/spatial_model.py``.  The
image lives row-sharded over a mesh axis for the whole forward: every 3x3
conv exchanges one boundary row with its neighbours (``spatial.py``) and
convolves its own slab, so a single image too large to tile-batch flows
through the full network without host-side splitting.

Supported architectures: the RRDBNet family (ESRGAN / ESRGAN+ / lite,
reference RRDBNet_arch.py:16-62) and SRResNet (SRResNet_arch.py:44-91) in
their default inference configurations: CNA conv blocks, no norm layers,
parameter-free activations, upconv or pixelshuffle upsampling.  Other
configurations are refused with the reason.

Design notes:
  * one forward runs every op shard by shard, in order, from one thread;
    each device's slab takes that device's parameters, and CUDA launches
    are asynchronous, so the devices overlap;
  * edge shards receive zeros, the zero padding at the true image border,
    so the sharded forward equals the unsharded one up to summation order;
  * upsampling (nearest / pixelshuffle) is row-local: a shard just
    multiplies its rows;
  * as in the JAX package, every conv is a plain conv (no fused RDB
    kernel: its tile would need a halo of 5 rows per RDB), and the tail
    materializes nearest-up + conv and the plain HR convs (not the
    collapsed upconv or the phase tail of ``models/common.py``).
"""
from __future__ import annotations

from typing import Any, Dict, List

import torch

from innfer_tpu_torch.models import common as C
from innfer_tpu_torch.models.common import _outm
from innfer_tpu_torch.nn import functional as F
from innfer_tpu_torch.nn import resize as R
from innfer_tpu_torch.ops.rdb import res_scale
from innfer_tpu_torch.parallel.mesh import Mesh, params_on
from innfer_tpu_torch.parallel.spatial import _exchange_halo, gather_rows, shard_rows

Shards = List[torch.Tensor]


def spatial_supported(cfg: Dict[str, Any]) -> bool:
    """True if this config can run the spatially-sharded forward."""
    default_act = "relu" if cfg.get("type") == "sr_resnet" else "leakyrelu"
    return (
        cfg.get("type") in ("rrdb_net", "mrrdb_net", "sr_resnet")
        and cfg.get("norm_type") in (None, "none")
        and (cfg.get("mode") or "CNA").upper() in ("CNA", "CNAC")
        and cfg.get("act_type", default_act) in
        ("relu", "leakyrelu", "lrelu", "tanh", "sigmoid")
        # parameterized final activations (prelu/swish) would need act-key
        # plumbing this forward does not have: reject here, not mid-forward
        and cfg.get("finalact") in
        (None, "relu", "leakyrelu", "lrelu", "tanh", "sigmoid")
        and cfg.get("convtype", "Conv2D") == "Conv2D"
    )


def spatial_rejection_reason(cfg: Dict[str, Any]) -> str:
    """Why this config cannot run spatially sharded (the session's loud
    error).  PAN is refused on purpose: its SCPA trunk is halo-shardable,
    but the default FSA self-attention (PAN_arch.py:178-190) attends over
    all positions, with an attention matrix quadratic in the image's
    pixels, and the bilinear align_corners=True global residual
    (PAN_arch.py:215-222) reads rows by global coordinate; the tiled
    engine serves PAN.  The texts are the JAX package's."""
    kind = cfg.get("type")
    if kind == "pan_net":
        return (
            "pan_net is deliberately unsupported by --spatial: the default "
            "FSA self-attention is global (its attention matrix alone is "
            "quadratic in image pixels — infeasible for the huge images "
            "--spatial targets), and the bilinear(align_corners=True) "
            "global input residual is not shard-local.  Use the tiled "
            "engine (default) for PAN.")
    return (
        "spatial sharding supports the default RRDB/SRResNet inference "
        f"configs only (got {kind}, norm={cfg.get('norm_type')}, "
        f"act={cfg.get('act_type')})")


def _conv3x3h(ps, xs: Shards, key: str) -> Shards:
    """3x3 conv of every slab with a 1-row halo exchange."""
    return [F.conv2d(h, p[f"{key}.weight"], p.get(f"{key}.bias"), padding=[(0, 0), (1, 1)])
            for p, h in zip(ps, _exchange_halo(xs, 1))]


def _act(kind, xs: Shards) -> Shards:
    return [F.act(kind, t) for t in xs]


def _rdb5c_h(ps, x: Shards, prefix: str, *, act_type: str, plus: bool) -> Shards:
    cat = lambda *ts: [torch.cat(parts, dim=-1) for parts in zip(*ts)]  # noqa: E731
    conv = lambda i, t: _conv3x3h(ps, t, f"{prefix}.conv{i}.0")  # noqa: E731
    add = lambda a, b: [u + v for u, v in zip(a, b)]  # noqa: E731

    x1 = _act(act_type, conv(1, x))
    x2 = _act(act_type, conv(2, cat(x, x1)))
    if plus:
        x2 = add(x2, [F.conv2d(t, p[f"{prefix}.conv1x1.weight"], None) for p, t in zip(ps, x)])
    x3 = _act(act_type, conv(3, cat(x, x1, x2)))
    x4 = _act(act_type, conv(4, cat(x, x1, x2, x3)))
    if plus:
        x4 = add(x4, x2)
    x5 = conv(5, cat(x, x1, x2, x3, x4))
    return [a * res_scale(t.dtype) + t for a, t in zip(x5, x)]


def _resnet_block_h(ps, x: Shards, prefix: str, *, act_type: str, scale: float) -> Shards:
    """SRResNet trunk block (SRResNet_arch.py:61-91), halo-exchange convs.
    Default-config key layout: conv0 at res.0 (CNA [conv, act]), conv1 at
    res.2 (act cleared)."""
    h = _act(act_type, _conv3x3h(ps, x, f"{prefix}.res.0"))
    h = _conv3x3h(ps, h, f"{prefix}.res.2")
    return [t + a * torch.tensor(scale, dtype=t.dtype) for t, a in zip(x, h)]


def build_spatial_apply(cfg: Dict[str, Any], mesh: Mesh, axis: str = "data"):
    """Return ``apply(params, x)`` running the full RRDB-family or SRResNet
    forward H-sharded over ``mesh``'s ``axis``.

    ``x`` is (N, H, W, C) with H divisible by the axis size; ``params`` a
    ParamDict or ``parallel/mesh.MeshParams`` (each slab takes its
    device's).  The result is mathematically exact against the reference
    forward (the halo convs see the same neighbour rows) but not bitwise
    equal to ``get_network(cfg).apply``, whose tail takes the collapsed
    upconv and the phase tail: this path materializes nearest-up + conv
    and the plain HR tail, so hold it against a plain-tail forward.  The
    output is gathered to ``x``'s device."""
    if not spatial_supported(cfg):
        raise NotImplementedError(spatial_rejection_reason(cfg))
    kind = cfg.get("type")
    nb = cfg["nb"]
    nr = cfg.get("nr", 3)
    upscale = int(cfg.get("upscale", 4))
    act_type = cfg.get("act_type", "relu" if kind == "sr_resnet" else "leakyrelu")
    plus = bool(cfg.get("plus", False))
    block_scale = float(cfg.get("res_scale", 1))
    up_mode = cfg.get("upsample_mode", "pixelshuffle" if kind == "sr_resnet" else "upconv")
    finalact = cfg.get("finalact")
    outm = cfg.get("outm")
    _n_up, factor = C.n_upscale_blocks(upscale)
    up_convs, hr0 = C.upsample_indices(upscale, up_mode)
    names = (("RDB1", "RDB2", "RDB3") if nr == 3
             else tuple(f"RDBs.{i}" for i in range(nr)))

    def trunk_block(ps, t: Shards, prefix: str) -> Shards:
        if kind == "sr_resnet":
            return _resnet_block_h(ps, t, prefix, act_type=act_type, scale=block_scale)
        out = t
        for name in names:
            out = _rdb5c_h(ps, out, f"{prefix}.{name}", act_type=act_type, plus=plus)
        return [a * res_scale(s.dtype) + s for a, s in zip(out, t)]

    def local(ps, x: Shards) -> Shards:
        fea = _conv3x3h(ps, x, "model.0")
        t = fea
        for i in range(nb):
            t = trunk_block(ps, t, f"model.1.sub.{i}")
        t = _conv3x3h(ps, t, f"model.1.sub.{nb}")
        h = [a + b for a, b in zip(fea, t)]
        for ci in up_convs:
            if up_mode == "upconv":
                h = [R.upsample_nearest(s, factor) for s in h]
                h = _act(act_type, _conv3x3h(ps, h, f"model.{ci}"))
            else:  # pixelshuffle
                h = _conv3x3h(ps, h, f"model.{ci}")
                h = _act(act_type, [F.pixel_shuffle(s, factor) for s in h])
        h = _act(act_type, _conv3x3h(ps, h, f"model.{hr0}"))
        h = _conv3x3h(ps, h, f"model.{hr0 + 2}")
        if finalact:
            h = _act(finalact, h)
        return [_outm(s, outm) for s in h]

    def apply(params, x: torch.Tensor) -> torch.Tensor:
        xs = shard_rows(x, mesh, axis)
        ps = [params_on(params, s.device) for s in xs]
        return gather_rows(local(ps, xs), x.device)

    return apply


class SpatialRunner:
    """Pipeline-facing runner: pad H to a shard multiple with edge rows, run
    the sharded forward, crop the output back.

    Outputs within the receptive field of the padded rows can differ from
    a pure whole-image forward (the pipeline's behaviour for arbitrary
    image heights)."""

    def __init__(self, model, mesh: Mesh, axis: str = "data"):
        self._apply = build_spatial_apply(model.cfg, mesh, axis)
        self.n = mesh.shape[axis]
        self.scale = model.scale
        self.output_index = model.output_index

    def __call__(self, params, x: torch.Tensor) -> torch.Tensor:
        h = x.shape[1]
        pad = (-h) % self.n
        if pad:
            x = torch.cat([x, x[:, -1:].expand(-1, pad, -1, -1)], dim=1)
        out = self._apply(params, x)
        if self.output_index is not None:
            out = out[self.output_index]
        if pad:
            out = out[:, : h * self.scale]
        return out


def spatial_run(model, params, x: torch.Tensor, mesh: Mesh, axis: str = "data") -> torch.Tensor:
    """One-shot convenience wrapper around :class:`SpatialRunner`."""
    return SpatialRunner(model, mesh, axis)(params, x)
