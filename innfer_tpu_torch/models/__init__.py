"""Architecture factory: full config dict -> ModelDef.

The port's registry over the reference's types (architectures/__init__.py:
5-40): RRDBNet, mESRGAN, SRResNet, PPON, PAN, the pix2pix UNet, the
CycleGAN ResNet and WBC, and SwinIR and HAT, which the reference's
registry lacks.  evsrgan (RRDBNet with Conv3D) is built by ``rrdb._build_3d``, for
the library only: ``InferenceSession`` refuses it.
"""
from __future__ import annotations

from typing import Any, Dict

from innfer_tpu_torch.models.base import (ModelDef, ParamDict, Params,  # noqa: F401
                                          cast_params, convert_state,
                                          params_from_jax)


def get_network(cfg: Dict[str, Any]) -> ModelDef:
    cfg = dict(cfg)
    kind = cfg.pop("type").lower()
    cfg["type"] = kind  # keep for ModelDef.cfg
    if kind == "rrdb_net":
        from innfer_tpu_torch.models import rrdb

        return rrdb.build(cfg)
    if kind == "mrrdb_net":
        from innfer_tpu_torch.models import rrdb

        return rrdb.build_mrrdb(cfg)
    if kind == "sr_resnet":
        from innfer_tpu_torch.models import srresnet

        return srresnet.build(cfg)
    if kind == "ppon":
        from innfer_tpu_torch.models import ppon

        return ppon.build(cfg)
    if kind == "swinir":
        from innfer_tpu_torch.models import swinir

        return swinir.build(cfg)
    if kind == "hat":
        from innfer_tpu_torch.models import hat

        return hat.build(cfg)
    if kind == "pan_net":
        from innfer_tpu_torch.models import pan

        return pan.build(cfg)
    if kind == "resnet_net":
        from innfer_tpu_torch.models import resnet

        return resnet.build(cfg)
    if kind == "unet_net":
        from innfer_tpu_torch.models import unet

        return unet.build(cfg)
    if kind == "wbcunet_net":
        from innfer_tpu_torch.models import wbc

        return wbc.build(cfg)
    raise NotImplementedError(f"Model [{kind}] not recognized")
