"""High-level model loading: .pth path -> (ModelDef, params on the device).

The port's counterpart of ``innfer_tpu/loader.py`` (reference run.py:39-101):
checkpoint read, SWA unwrap, arch fingerprinting / hyperparameter
inference (or an explicit arch), network build and parameter conversion.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from innfer_tpu_torch.checkpoint.detect import detect_and_infer, load_checkpoint
from innfer_tpu_torch.checkpoint.remaps import swa_to_normal
from innfer_tpu_torch.config.defaults import get_network_config
from innfer_tpu_torch.device import DeviceLike, resolve_device
from innfer_tpu_torch.models import ModelDef, Params, convert_state, get_network


def load_model(
    path: str,
    arch: str = "infer",
    scale: Optional[int] = None,
    *,
    param_dtype: torch.dtype = torch.float32,
    device: DeviceLike = None,
    strict: bool = True,
) -> Tuple[ModelDef, Params]:
    """Load a checkpoint and build the matching model, params on ``device``
    (the CUDA device unless ``device="cpu"``).

    ``arch='infer'`` auto-detects the architecture from state-dict key
    fingerprints and recovers nb/nf/scale from shapes; otherwise ``arch``
    is a type alias resolved with library defaults.  ``strict=False``
    drops the keys the model lists in ``ignore_key_patterns`` (the
    cyclegan preset's non-strict load).
    """
    dev = resolve_device(device)
    state = swa_to_normal(load_checkpoint(path))
    if arch == "infer":
        _family, cfg, state = detect_and_infer(state, scale=scale)
    elif "wbcunet" in arch:
        # wbcunet_tf names the TF-trained padding and upsampling
        mode = "tf" if "_tf" in arch else "pt"
        cfg = get_network_config({"type": arch.replace("_tf", ""), "mode": mode},
                                 scale if scale else 1)
    else:
        cfg = get_network_config({"type": arch}, scale if scale else 1)
    return load_model_from_state(state, cfg, param_dtype=param_dtype, device=dev,
                                 strict=strict)


def load_model_from_state(
    state: Dict[str, Any],
    cfg: Dict[str, Any],
    *,
    param_dtype: torch.dtype = torch.float32,
    device: DeviceLike = None,
    strict: bool = True,
) -> Tuple[ModelDef, Params]:
    """Build from an already-loaded state dict + full config."""
    dev = resolve_device(device)
    model = get_network(cfg)
    params = convert_state(model, state, param_dtype=param_dtype, device=dev,
                           strict=strict)
    return model, params
