"""Device meshes: tile- and image-level data parallelism, and channel tensor
parallelism.

The port's counterpart of ``innfer_tpu/parallel/mesh.py``.  JAX drives its
mesh from one process (``shard_map`` over local devices); so does the
port, over a list of ``torch.device``s:

  * data axis: a dispatch group (tiles, or a stack of images) is cut into
    even slices, one per data device; each slice runs there with that
    device's parameters, and the outputs are gathered back to the input's
    device (:func:`data_parallel`).  Work is launched in order from one
    thread; CUDA launches are asynchronous, so the devices overlap.
  * model axis: the output channels of the large conv weights are sharded
    (:func:`tp_shard_params`); ``nn/functional.conv2d`` and
    ``conv_transpose2d`` run one shard per model device and concatenate
    the outputs on the input's device, the all-gather XLA inserts.

A device list may repeat a device, ``[torch.device("cpu")] * 8`` in the
tests or ``[torch.device("cuda", 0)] * 4`` on one card: every slice, halo
copy and shard then runs on that device, which exercises the real path's
control flow and copies.  Such a mesh measures the mesh code's overhead,
not scaling.
"""
from __future__ import annotations

import contextlib
import re
from typing import Callable, Dict, List, Optional, Sequence

import torch

from innfer_tpu_torch.models.base import ParamDict

AXES = ("data", "model")


def _normalize(dev) -> torch.device:
    """A CUDA device always carries its index, so that device keys compare
    equal to ``tensor.device``."""
    dev = torch.device(dev)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def local_devices(platform: str = "cuda") -> List[torch.device]:
    """Every visible CUDA device (raises with no card), or the one CPU
    device for ``platform="cpu"``."""
    if platform == "cpu":
        return [torch.device("cpu")]
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available for a device mesh; pass an explicit "
            "device list (devices=[torch.device('cpu')] * N for a virtual "
            "mesh on the CPU)")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


class Mesh:
    """A named (data, model) grid of devices: ``devices[i][j]`` is data
    slice i's j-th model device.  ``shape`` is a dict, read the way the
    JAX code reads it (``mesh.shape.get("data", 1)``)."""

    def __init__(self, devices: Sequence[Sequence[torch.device]]):
        self.devices = [[_normalize(d) for d in row] for row in devices]
        if not self.devices or len({len(r) for r in self.devices}) != 1 or not self.devices[0]:
            raise ValueError("a mesh is a non-empty rectangular grid of devices")
        self.shape = {"data": len(self.devices), "model": len(self.devices[0])}

    def axis_devices(self, axis: str) -> List[torch.device]:
        """The devices along ``axis``: the lead (model index 0) device of
        each data slice, or data slice 0's model devices."""
        if axis == "data":
            return [row[0] for row in self.devices]
        if axis == "model":
            return list(self.devices[0])
        raise ValueError(f"unknown mesh axis {axis!r}; the axes are {AXES}")


def make_mesh(n_data: Optional[int] = None, n_model: int = 1, devices=None) -> Mesh:
    """Build a (data, model) mesh over ``devices`` (default: every visible
    CUDA device).  An explicit list may repeat a device."""
    devices = [_normalize(d) for d in (devices if devices is not None else local_devices())]
    if n_data is None:
        n_data = len(devices) // n_model
    use = n_data * n_model
    if use < 1 or use > len(devices):
        raise ValueError(
            f"mesh needs data*model = {n_data}*{n_model} = {use} devices, "
            f"but only {len(devices)} are available "
            f"(platform {devices[0].type if devices else '?'}); for a virtual "
            "test mesh pass devices= a list that repeats one device, e.g. "
            "[torch.device('cpu')] * N or [torch.device('cuda', 0)] * N")
    return Mesh([devices[i * n_model:(i + 1) * n_model] for i in range(n_data)])


class MeshParams(dict):
    """A model's parameters on a mesh: one ParamDict per distinct device
    (device -> ParamDict), so each device keeps its own ``cache`` of
    derived weights (``models/common.derived``, the kernels' packing)."""


def params_on(params, device):
    """The parameters a forward on ``device`` takes: that device's
    ParamDict of a :class:`MeshParams`, else ``params`` itself."""
    if not isinstance(params, MeshParams):
        return params
    dev = _normalize(device)
    if dev not in params:
        raise KeyError(f"no parameters on {dev}: the mesh's parameters live on "
                       f"{sorted(str(d) for d in params)}")
    return params[dev]


def replicate_params(params: Dict[str, torch.Tensor], mesh: Mesh) -> MeshParams:
    """Every parameter on every distinct device of the mesh."""
    out = MeshParams()
    for dev in dict.fromkeys(d for row in mesh.devices for d in row):
        out[dev] = ParamDict((k, v.to(dev)) for k, v in params.items())
    return out


def _out_dim(key: str, v: torch.Tensor, transposed: Sequence[str]) -> Optional[int]:
    """The output-channel dim a parameter shards on, or None: a conv
    weight's O (OIHW dim 0; dim 1 of a ConvTranspose2d weight, which
    keeps the checkpoint's IOHW), the JAX package's HWIO last axis; the
    only dim of a 1-D parameter.  Other ranks replicate (a Conv1d-as-dense
    weight is 2-D in the JAX package, a Conv3d weight 5-D)."""
    if v.dim() == 4:
        return 1 if any(re.fullmatch(p, key) for p in transposed) else 0
    if v.dim() == 1:
        return 0
    return None


def tp_shard_params(params: Dict[str, torch.Tensor], mesh: Mesh, axis: str = "model",
                    transposed: Sequence[str] = ()) -> MeshParams:
    """Tensor-parallel placement, the JAX package's rule
    (``innfer_tpu/parallel/mesh.py:49-63``): a 4-D weight whose output
    channels divide by the model-axis size, and a 1-D parameter that
    divides by it, are sharded over each data slice's model devices; the
    rest is replicated.  ``transposed`` holds the ModelDef's
    ``transposed_keys`` patterns.

    Each data slice's lead device holds one ParamDict of gathered tensors,
    so every consumer other than a conv (the kernels' weight packing, the
    tail rewrites' derived weights, norms, PReLU, dense layers) reads the
    whole parameter, gathered once per device.  A sharded tensor carries
    its shards, one per model device, as ``tensor.tp_shards``; the convs
    of ``nn/functional`` run on those.  A cast or rewrite of the tensor
    drops them and the consumer runs on the gathered tensor, as a Pallas
    call on the TPU cannot be partitioned either."""
    if axis != "model":
        raise ValueError(f"tensor parallelism shards the 'model' axis, not {axis!r}")
    size = mesh.shape["model"]
    out = MeshParams()
    for row in mesh.devices:
        lead = row[0]
        if lead in out:
            continue
        pd = ParamDict()
        for k, v in params.items():
            g = v.detach().to(lead)  # a tensor object of this dict's own
            dim = _out_dim(k, v, transposed)
            if dim is not None and v.shape[dim] % size == 0 and v.shape[dim] >= size:
                g.tp_shards = tuple(s.to(d).contiguous()
                                    for s, d in zip(g.chunk(size, dim=dim), row))
            pd[k] = g
        out[lead] = pd
    return out


def _to(t: torch.Tensor, dev: torch.device) -> torch.Tensor:
    """``t`` on ``dev``: an asynchronous copy where the destination is a
    card (peer to peer across cards, device-local on a repeated one)."""
    return t.to(dev, non_blocking=dev.type == "cuda")


def on_device(dev: torch.device):
    """The context that makes ``dev`` the current CUDA device (a no-op for
    the CPU): work for a card runs with it current, since a kernel of the
    port launches on the current device."""
    return torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext()


def data_parallel(fn: Callable, x: torch.Tensor, mesh: Mesh, params=None) -> torch.Tensor:
    """``fn`` over the batch of ``x`` cut into slices as even as the batch
    allows, one per data device (an empty slice is skipped).  ``fn`` gets
    its slice on its device, with that device current, and, given
    ``params``, that device's parameters first: ``fn(params_on(params,
    dev), slice)``.  The outputs are gathered to ``x``'s device in order."""
    outs = []
    for part, dev in zip(x.tensor_split(mesh.shape["data"]), mesh.axis_devices("data")):
        if not part.shape[0]:
            continue
        with on_device(dev):
            part = _to(part, dev)
            outs.append(fn(part) if params is None else fn(params_on(params, dev), part))
    return torch.cat([_to(o, x.device) for o in outs])
