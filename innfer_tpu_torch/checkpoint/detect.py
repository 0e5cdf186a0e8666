"""Checkpoint reading, architecture fingerprinting and RRDB hyperparameter
inference from state dicts.

The port's own copy of ``innfer_tpu/checkpoint/detect.py`` (reference
run.py:50-165).  Detection reads only key names and ``.shape``, so it takes
torch tensors or numpy arrays.
"""
from __future__ import annotations

import zipfile
from typing import Any, Dict, Optional, Tuple

import torch

from innfer_tpu_torch.checkpoint.remaps import mod_to_normal
from innfer_tpu_torch.config.defaults import get_network_config

StateDict = Dict[str, Any]

SWINIR_KEY = "layers.0.residual_group.blocks.0.attn.relative_position_bias_table"
# the overlapping cross-attention's table: HAT's alone (it shares SWINIR_KEY)
HAT_KEY = "layers.0.residual_group.overlap_attn.relative_position_bias_table"


def load_checkpoint(path: str) -> StateDict:
    """Load a ``.pth``/``.pt`` state dict as ``{key: CPU tensor}``.

    ``torch.load(weights_only=True)`` reads the zip container and the
    legacy format and refuses pickled code.  TorchScript archives are
    rejected with a clear error; nested trainer containers are unwrapped.
    """
    if zipfile.is_zipfile(path):
        with zipfile.ZipFile(path) as zf:
            if any(n.endswith("constants.pkl") for n in zf.namelist()):
                raise ValueError(
                    f"{path} is a TorchScript archive; only state-dict "
                    "checkpoints are supported")
    state = torch.load(path, map_location="cpu", weights_only=True)
    if not isinstance(state, dict):
        raise ValueError(f"{path} did not contain a state dict (got {type(state)})")
    for key in ("params_ema", "params", "state_dict", "model_state_dict"):
        if key in state and isinstance(state[key], dict):
            state = state[key]
            break
    return state


def fingerprint_arch(state: StateDict) -> Tuple[str, StateDict]:
    """Detect the arch family (order of run.py:50-72); mesrgan-layout dicts
    are converted to the flattened esrgan layout on the way."""
    if "SCPA_trunk.0.conv1_a.weight" in state:
        return "pan", state
    if HAT_KEY in state:
        # ahead of SwinIR's key, which HAT's window attention shares
        return "hat", state
    if SWINIR_KEY in state:
        # ahead of conv_first, which SwinIR shares with the mESRGAN layout
        return "swinir", state
    if "model.1.sub.0.res.0.weight" in state:
        return "srgan", state
    if "conv_first.weight" in state:
        return "esrgan", mod_to_normal(state)
    if "model.0.weight" in state:
        return "esrgan", state
    if "CFEM.0.weight" in state:
        return "ppon", state
    if "conv_9.weight" in state:
        return "wbcunet", state
    raise ValueError("Could not infer model parameters from state-dict keys.")


def infer_params(arch: str, state: StateDict, scale: Optional[int] = None,
                 in_nc: int = 3, out_nc: int = 3) -> Dict[str, Any]:
    """Recover hyperparameters from the state dict (run.py:103-165).

    esrgan/srgan (flattened sequential layout):
      * nb    = max ``model.1.sub.<i>`` block index
      * scale = 2 ** (count of ``model.<n>.weight`` convs with n > 6)
      * out_nc from the highest-index conv, nf/in_nc from ``model.0``
      * plus  = any ``conv1x1`` key (ESRGAN+)
    wbcunet: scale 1, pt mode, nf from ``conv``.
    ppon and pan: nb, nf, out_nc and scale from key names and shapes (the
    reference falls back to library defaults for these, run.py:157-163).
    swinir: :func:`swinir_params`; hat: :func:`hat_params`.
    """
    if arch in ("esrgan", "srgan"):
        scale2x = 0
        top_layer = 0
        nb = None
        plus = False
        for key in state:
            parts = key.split(".")
            if len(parts) == 5 and parts[2] == "sub":
                nb = int(parts[3])
            elif len(parts) == 3 and parts[0] == "model" and parts[1].isdigit():
                idx = int(parts[1])
                if idx > 6 and parts[2] == "weight":
                    scale2x += 1
                if idx > top_layer:
                    top_layer = idx
                    out_nc = int(state[key].shape[0])
            if arch == "esrgan" and not plus and "conv1x1" in key:
                plus = True
        nf = int(state["model.0.weight"].shape[0])
        in_nc = int(state["model.0.weight"].shape[1])
        inferred = 2 ** scale2x
        # exact for 2^k scales; true-3x checkpoints read as 2, so an explicit
        # or filename scale is honoured only inside that ambiguity class
        if scale and scale != inferred and not (inferred == 2 and scale == 3):
            print(f"Warning: requested scale {scale} contradicts the "
                  f"checkpoint layout (inferred {inferred}); using {inferred}")
            scale = inferred
        scale = scale or inferred
        net = {"type": arch, "in_nc": in_nc, "out_nc": out_nc, "nf": nf, "nb": nb}
        if arch == "esrgan":
            net["plus"] = plus
    elif arch == "wbcunet":
        scale = 1
        net = {"type": arch, "mode": "pt", "nf": int(state["conv.weight"].shape[0])}
    elif arch == "ppon":
        nb = 1 + max(int(k.split(".")[3]) for k in state
                     if k.startswith("CFEM.1.sub.") and ".RB" in k)
        nf = int(state["CFEM.0.weight"].shape[0])
        crm_idx = [int(k.split(".")[1]) for k in state
                   if k.startswith("CRM.") and k.endswith(".weight")]
        out_nc = int(state[f"CRM.{max(crm_idx)}.weight"].shape[0])
        # 2x and 3x share the single-upsampler layout: prefer 2^n, and let
        # an explicit or filename scale decide
        scale = scale or 2 ** (len(crm_idx) - 2)
        net = {"type": arch, "in_nc": int(state["CFEM.0.weight"].shape[1]),
               "out_nc": out_nc, "nf": nf, "nb": nb}
    elif arch == "swinir":
        net = swinir_params(state)   # its upscale from the tail's keys
    elif arch == "hat":
        net = hat_params(state)
    elif arch == "pan":
        nb = 1 + max(int(k.split(".")[1]) for k in state if k.startswith("SCPA_trunk."))
        nf = int(state["conv_first.weight"].shape[0])
        n_up = sum(1 for k in state if k.startswith("upsample.") and k.endswith(".conv.weight"))
        scale = scale or 2 ** n_up
        net = {
            "type": arch, "in_nc": int(state["conv_first.weight"].shape[1]),
            "out_nc": int(state["conv_last.weight"].shape[0]), "nf": nf,
            "unf": int(state["upsample.1.weight"].shape[0]) if n_up else nf, "nb": nb,
            "self_attention": any(k.startswith("FSA.") for k in state),
            "double_scpa": any(k.startswith("SCPA_trunk2.") for k in state),
        }
    else:
        raise ValueError(f"cannot infer params for arch [{arch}]")
    return get_network_config(net, scale if scale else 1)


def swinir_params(state: StateDict) -> Dict[str, Any]:
    """SwinIR's hyperparameters from its keys and shapes: embed_dim and
    in_chans from ``conv_first``, each group's depth and heads from its
    blocks and their bias tables, the window from a table's (2 w - 1)^2
    rows, mlp_ratio from ``fc1``, the upsampler from the tail's keys
    (``conv_up1``: nearest+conv, x4 with ``conv_up2``; ``upsample.*`` with
    ``conv_before_upsample``: pixelshuffle, without: pixelshuffledirect;
    neither: none), resi_connection from ``layers.0.conv``."""
    groups = 1 + max(int(k.split(".")[1]) for k in state if k.startswith("layers."))
    depths, heads = [], []
    for i in range(groups):
        pre = f"layers.{i}.residual_group.blocks."
        depths.append(1 + max(int(k[len(pre):].split(".")[0]) for k in state
                              if k.startswith(pre)))
        heads.append(int(state[f"{pre}0.attn.relative_position_bias_table"].shape[1]))
    rows = int(state[SWINIR_KEY].shape[0])
    window = (round(rows ** 0.5) + 1) // 2
    embed = int(state["conv_first.weight"].shape[0])
    hidden = int(state["layers.0.residual_group.blocks.0.mlp.fc1.weight"].shape[0])
    n_up = sum(1 for k in state if k.startswith("upsample.") and k.endswith(".weight"))
    if "conv_up1.weight" in state:
        upsampler, upscale = "nearest+conv", 4 if "conv_up2.weight" in state else 2
    elif "conv_before_upsample.0.weight" in state:
        upsampler, upscale = "pixelshuffle", 2 ** n_up
    elif n_up:
        w = state["upsample.0.weight"]
        upsampler = "pixelshuffledirect"
        upscale = round((w.shape[0] // int(state["conv_first.weight"].shape[1])) ** 0.5)
    else:
        upsampler, upscale = "", 1
    resi = "1conv" if "layers.0.conv.weight" in state else "3conv"
    return {"type": "swinir", "in_chans": int(state["conv_first.weight"].shape[1]),
            "embed_dim": embed, "depths": depths, "num_heads": heads, "window_size": window,
            "mlp_ratio": hidden / embed, "upsampler": upsampler, "resi_connection": resi,
            "upscale": upscale}


def hat_params(state: StateDict) -> Dict[str, Any]:
    """HAT's hyperparameters from its keys and shapes (``hat_arch.py``):
    embed_dim, in_chans, the groups' depths and heads and mlp_ratio as
    SwinIR's (:func:`swinir_params`), the window from the HAB tables'
    (2 w - 1)^2 rows, the overlap ratio from the OCA table's (w + ow - 1)^2
    rows (ow = w + int(w overlap_ratio)), compress_ratio from the CAB's
    first conv (embed / its outputs), squeeze_factor from the channel
    attention's first 1x1 conv, the upsampler from the tail's keys
    (``conv_before_upsample`` and ``upsample.*``: pixelshuffle, x3 where
    ``upsample.0`` has 9 nf outputs, else 2 ** its convs; neither: none),
    resi_connection from ``layers.0.conv`` (``1conv``; ``3conv``'s
    ``layers.0.conv.0``; else ``identity``).  conv_scale is not in the
    file: the published 0.01."""
    net = swinir_params(state)
    embed, window = net["embed_dim"], net["window_size"]
    rows = int(state[HAT_KEY].shape[0])
    owin = round(rows ** 0.5) - window + 1
    blk = "layers.0.residual_group.blocks.0.conv_block.cab"
    n_up = sum(1 for k in state if k.startswith("upsample.") and k.endswith(".weight"))
    if "conv_before_upsample.0.weight" in state and n_up:
        nf = int(state["conv_before_upsample.0.weight"].shape[0])
        up = int(state["upsample.0.weight"].shape[0])
        upsampler, upscale = "pixelshuffle", 3 if up == 9 * nf else 2 ** n_up
    else:
        upsampler, upscale = "", 1
    if "layers.0.conv.weight" in state:
        resi = "1conv"
    elif "layers.0.conv.0.weight" in state:
        resi = "3conv"
    else:
        resi = "identity"
    net.update(type="hat", overlap_ratio=(owin - window) / window,
               compress_ratio=embed // int(state[f"{blk}.0.weight"].shape[0]),
               squeeze_factor=embed // int(state[f"{blk}.3.attention.1.weight"].shape[0]),
               conv_scale=0.01, upsampler=upsampler, resi_connection=resi, upscale=upscale)
    return net


def detect_and_infer(state: StateDict, scale: Optional[int] = None
                     ) -> Tuple[str, Dict[str, Any], StateDict]:
    """Fingerprint, then infer the config.  Returns (arch_family,
    full_config, possibly-remapped state dict)."""
    arch, state = fingerprint_arch(state)
    cfg = infer_params(arch, state, scale=scale)
    return arch, cfg, state
