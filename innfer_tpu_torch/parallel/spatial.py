"""Spatial (intra-image) sharding with halo exchange.

The port's counterpart of ``innfer_tpu/parallel/spatial.py``.  The tiled
engine runs independent zero-padded tiles; this is the communicating
alternative: the image lives row-sharded over a mesh axis, one shard per
device, and each conv first copies its neighbours' boundary rows to its
own device (the JAX package's ``ppermute``; here a slice copied with
``.to(device, non_blocking=True)``, peer to peer across cards and
device-local on a repeated device), so one huge image flows through a
conv without replicating or re-tiling it.

``halo_conv2d`` is the building block: a kxk conv over an H-sharded NHWC
tensor, equal to the unsharded conv up to summation order.
"""
from __future__ import annotations

from typing import List, Optional

import torch

from innfer_tpu_torch.nn import functional as F
from innfer_tpu_torch.parallel.mesh import Mesh, _to


def _exchange_halo(shards: List[torch.Tensor], halo: int) -> List[torch.Tensor]:
    """Each (N, h, W, C) shard with ``halo`` rows of its neighbours above
    and below, on its own device.  The edge shards receive zeros: the
    conv's zero padding at the true image border."""
    out = []
    for i, s in enumerate(shards):
        zeros = s.new_zeros((s.shape[0], halo) + tuple(s.shape[2:]))
        top = _to(shards[i - 1][:, -halo:], s.device) if i > 0 else zeros
        bottom = _to(shards[i + 1][:, :halo], s.device) if i < len(shards) - 1 else zeros
        out.append(torch.cat([top, s, bottom], dim=1))
    return out


def shard_rows(x: torch.Tensor, mesh: Mesh, axis: str = "data") -> List[torch.Tensor]:
    """``x`` (N, H, W, C) cut into equal row slabs, one per device of the
    mesh axis, each copied to its device; H must divide by the axis size."""
    devs = mesh.axis_devices(axis)
    if x.shape[1] % len(devs) != 0:
        raise ValueError(
            f"H={x.shape[1]} must be divisible by the {axis}-axis size "
            f"{len(devs)} for spatial sharding (pad the input)")
    return [_to(s, d) for s, d in zip(x.tensor_split(len(devs), dim=1), devs)]


def gather_rows(shards: List[torch.Tensor], device: torch.device) -> torch.Tensor:
    """The row slabs joined on ``device``."""
    return torch.cat([_to(s, device) for s in shards], dim=1)


def halo_conv2d(
    x: torch.Tensor,
    w: torch.Tensor,
    b: Optional[torch.Tensor] = None,
    *,
    mesh: Mesh,
    axis: str = "data",
    padding: int = 1,
) -> torch.Tensor:
    """Conv2d over an image row-sharded across ``mesh``'s ``axis``.

    x: (N, H, W, C) with H divisible by the axis size; w: OIHW.  Each
    device convolves its slab after the halo exchange: the vertical
    padding became the halo, the horizontal padding stays explicit.
    Equivalent to ``F.conv2d(x, w, b, padding=padding)``; the output is
    gathered to ``x``'s device."""
    if padding == 0:
        raise ValueError("halo exchange is only meaningful for padded convs")
    out = [F.conv2d(h, w.to(h.device), None if b is None else b.to(h.device),
                    padding=[(0, 0), (padding, padding)])
           for h in _exchange_halo(shard_rows(x, mesh, axis), padding)]
    return gather_rows(out, x.device)
