"""TorchScript models: a ``torch.jit`` archive run natively by the session.

The port of ``innfer_tpu/compat/torchscript.py``, the reference's ``-a ts``
path (run.py:40-42, 193-195, 204-209): the archive is ``torch.jit.load``ed
onto the session's device and wrapped as a :class:`ModelDef` whose params
hold the module, so it runs through the session's ordinary ``Stage`` and
tiled runner.  The JAX package had to run it on a host torch-CPU stage;
here it runs on the card.

  * fp32, true fp32: the reference turns fp16 off for TorchScript
    (run.py:341-343), and the forward runs under ``true_fp32`` so that
    cuDNN and cuBLAS take no TF32 on the card.
  * The scale is PROBED with tiny forwards at load time (64, 128, 256 px)
    instead of trusted from the filename: the recompose needs the true
    scale.  Multi-output modules are rejected.
  * Tiled runs use a uniform plan whose tile is clamped to the image
    (:class:`FitTileRunner`), as the JAX package's stage cuts it.
"""
from __future__ import annotations

import warnings
import zipfile
from typing import Dict, Optional, Tuple

import torch

from innfer_tpu_torch.models.base import ModelDef
from innfer_tpu_torch.nn.functional import true_fp32
from innfer_tpu_torch.tiling.engine import TiledRunner
from innfer_tpu_torch.tiling.plan import TilePlan, make_uniform_plan


def is_torchscript(path: str) -> bool:
    """A TorchScript archive is a zip holding code and constants.pkl."""
    try:
        with zipfile.ZipFile(path) as z:
            return any(n.endswith("constants.pkl") for n in z.namelist())
    except (zipfile.BadZipFile, OSError):
        return False


def _single(out):
    if isinstance(out, (tuple, list)):
        raise ValueError(
            "multi-output TorchScript modules are not supported (the "
            "reference's ts path cannot run them either: run.py:191-192 only "
            "indexes for arch 'ppon')")
    return out


def apply(params: Dict, x: torch.Tensor) -> torch.Tensor:
    """(N, H, W, C) -> (N, H*s, W*s, C) through ``params["module"]``, in
    true fp32."""
    with torch.no_grad(), true_fp32(torch.float32):
        out = _single(params["module"](x.float().permute(0, 3, 1, 2).contiguous()))
    return out.permute(0, 2, 3, 1)


def _probe_scale(params: Dict, device: torch.device) -> Optional[int]:
    """Tiny forwards until one succeeds; scale = out_w / in_w.
    Fixed-topology nets reject small inputs, so walk up."""
    for size in (64, 128, 256):
        try:
            out = apply(params, torch.zeros(1, size, size, 3, device=device))
        except RuntimeError:
            continue
        s, rem = divmod(int(out.shape[2]), size)
        if rem == 0 and s >= 1:
            return s
    return None


def load_torchscript(path: str, *, device: torch.device,
                     scale: Optional[int] = None) -> Tuple[ModelDef, Dict]:
    """The archive as a ModelDef with its probed scale, and its params
    ``{"module": ScriptModule}`` on ``device``."""
    params = {"module": torch.jit.load(path, map_location=device).eval()}
    probed = _probe_scale(params, device)
    if scale and probed and scale != probed:
        print(f"Warning: filename/flag scale {scale} != probed scale "
              f"{probed} for {path}; using {probed}")
    if probed is None:
        warnings.warn(
            f"TorchScript scale probe failed for {path} (no probe size "
            "accepted a 1x3xSxS input); falling back to the unverified "
            f"filename/flag scale {scale or 1}.  If the module expects "
            "non-3-channel input it cannot run in this pipeline; if its "
            "true scale differs, the tiled recompose geometry will be wrong.")
    model = ModelDef(name="torchscript", cfg={"type": "torchscript"}, apply=apply,
                     scale=probed or scale or 1)
    return model, params


class FitTileRunner(TiledRunner):
    """The uniform runner with the square tile clamped to the image
    (``min(tile, h, w)``, overlap below it), as the JAX package's
    TorchScript stage plans it: a small image is not padded up to a tile."""

    def __init__(self, apply_fn, scale: int, *, tile: int = 256, **kw):
        super().__init__(apply_fn, scale, mode="uniform", tile=tile, **kw)

    def plan_for(self, h: int, w: int, on_cuda: bool = False) -> TilePlan:
        key = (h, w, "fit")
        if key not in self._plans:
            tile = min(self.tile, h, w)
            self._plans[key] = make_uniform_plan(h, w, self.scale, tile=tile,
                                                 overlap=min(self.overlap, tile - 1))
        return self._plans[key]
