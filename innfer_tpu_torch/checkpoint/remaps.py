"""State-dict remap passes: SWA unwrap, the mESRGAN key-layout
conversion, both ways, and SwinIR's and HAT's tails onto the SR tail's
positions.

The port's own copy of ``innfer_tpu/checkpoint/remaps.py`` (reference
utils/utils.py:629-720).  Values pass through untouched, so the passes
work on torch tensors and numpy arrays alike.
"""
from __future__ import annotations

import re
from typing import Any, Dict

import torch

from innfer_tpu_torch.ops import hat_attn as HA

StateDict = Dict[str, Any]


def swa_to_normal(state: StateDict) -> StateDict:
    """Unwrap an AveragedModel (SWA) checkpoint: drop ``n_averaged`` and
    keep only the keys under ``module.module.``, stripped."""
    if "n_averaged" not in state:
        return state
    out: StateDict = {}
    for k, v in state.items():
        if "n_averaged" in k:
            continue
        if "module.module." in k:
            out[k.replace("module.module.", "")] = v
    return out


_TRUNK_IDX = re.compile(r"^RRDB_trunk\.(\d+)\.")


def mod_to_normal(state: StateDict) -> StateDict:
    """Convert the modified RRDB layout (mesrgan, named submodules) to the
    flattened sequential ESRGAN layout.  The trunk conv index follows the
    checkpoint's real depth (the reference hard-codes nb=23)."""
    if "conv_first.weight" not in state:
        return state
    nb = 1 + max(
        (int(m.group(1)) for k in state if (m := _TRUNK_IDX.match(k))), default=-1
    )
    out: StateDict = {}
    direct = {
        "conv_first": "model.0",
        "trunk_conv": f"model.1.sub.{nb}",
        "upconv1": "model.3",
        "upconv2": "model.6",
        "HRconv": "model.8",
        "conv_last": "model.10",
    }
    for k, v in state.items():
        if "RDB" in k:
            nk = k.replace("RRDB_trunk.", "model.1.sub.")
            if nk.endswith(".weight"):
                nk = nk[: -len(".weight")] + ".0.weight"
            elif nk.endswith(".bias"):
                nk = nk[: -len(".bias")] + ".0.bias"
            out[nk] = v
            continue
        stem, _, leaf = k.rpartition(".")
        if stem in direct and leaf in ("weight", "bias"):
            out[f"{direct[stem]}.{leaf}"] = v
        # anything unrecognized is dropped, matching the reference converter
    return out


def normal_to_mod(state: StateDict) -> StateDict:
    """Inverse of :func:`mod_to_normal`: the flattened ESRGAN layout to the
    modified (mesrgan) one (reference utils.py:629-663; the conversion
    tool's ``normal2mod`` pass)."""
    if "model.0.weight" not in state:
        return state
    sub_idx = re.compile(r"^model\.1\.sub\.(\d+)\.")
    nb = max(
        (int(m.group(1)) for k in state if "RDB" in k and (m := sub_idx.match(k))),
        default=-1,
    ) + 1
    out: StateDict = {}
    direct = {
        "model.0": "conv_first",
        f"model.1.sub.{nb}": "trunk_conv",
        "model.3": "upconv1",
        "model.6": "upconv2",
        "model.8": "HRconv",
        "model.10": "conv_last",
    }
    for k, v in state.items():
        if "RDB" in k:
            nk = k.replace("model.1.sub.", "RRDB_trunk.")
            out[nk.replace(".0.weight", ".weight").replace(".0.bias", ".bias")] = v
            continue
        stem, _, leaf = k.rpartition(".")
        if stem in direct and leaf in ("weight", "bias"):
            out[f"{direct[stem]}.{leaf}"] = v
    return out


# SwinIR's nearest+conv x4 tail, in the flattened positions of
# ``models/common.sr_tail`` at start 0: [Up, conv_up1, act, Up, conv_up2,
# act, conv_hr, act, conv_last]
_SWINIR_TAIL = {"conv_up1": "tail.1", "conv_up2": "tail.4", "conv_hr": "tail.6",
                "conv_last": "tail.8"}
# buffers of the published module that the port computes for each canvas
_SWINIR_BUFFERS = re.compile(r".*\.(relative_position_index|attn_mask)$")


def swinir_to_seq(state: StateDict) -> StateDict:
    """A SwinIR state dict (``network_swinir.py``'s keys) with its x4 tail's
    convs renamed to the SR tail's positions (``conv_up1`` ``tail.1``,
    ``conv_up2`` ``tail.4``, ``conv_hr`` ``tail.6``, ``conv_last``
    ``tail.8``) and the ``relative_position_index`` and ``attn_mask``
    buffers dropped: the program gathers the bias and makes the mask for
    the canvas it runs on."""
    out: StateDict = {}
    for k, v in state.items():
        if _SWINIR_BUFFERS.fullmatch(k):
            continue
        stem, _, leaf = k.rpartition(".")
        out[f"{_SWINIR_TAIL[stem]}.{leaf}" if stem in _SWINIR_TAIL else k] = v
    return out


_HAT_UP = re.compile(r"^upsample\.(\d+)\.(weight|bias)$")
HAT_INDEX_SA, HAT_INDEX_OCA = "relative_position_index_SA", "relative_position_index_OCA"


def hat_to_seq(state: StateDict) -> StateDict:
    """A HAT state dict (``hat_arch.py``'s keys) with its pixelshuffle
    tail's convs at the SR tail's positions (``upsample.<2 i>`` at
    ``tail.<3 i>``, ``conv_last`` after the last) and its index buffers
    checked, then dropped: ``relative_position_index_SA`` and
    ``relative_position_index_OCA`` must equal the indices the program
    computes from the tables' sizes (``ops/hat_attn.py``), or this raises,
    naming the buffer; any ``attn_mask`` is dropped too (the program makes
    the mask for its canvas)."""
    sa = state["layers.0.residual_group.blocks.0.attn.relative_position_bias_table"]
    oca = state["layers.0.residual_group.overlap_attn.relative_position_bias_table"]
    window = (round(sa.shape[0] ** 0.5) + 1) // 2
    kwin = round(oca.shape[0] ** 0.5) - window + 1
    want = {HAT_INDEX_SA: HA.sa_index(window), HAT_INDEX_OCA: HA.oca_index(window, kwin)}
    for key, index in want.items():
        if key in state:
            got = torch.as_tensor(state[key])
            if tuple(got.shape) != tuple(index.shape) or not torch.equal(got.long(), index):
                raise ValueError(
                    f"HAT: the checkpoint's {key} {tuple(got.shape)} differs from the index the "
                    f"program computes {tuple(index.shape)} for window {window} and key window "
                    f"{kwin}; the program reads the tables through its own index, so it refuses "
                    "the file")
    n_up = sum(1 for k in state if _HAT_UP.match(k) and k.endswith(".weight"))
    out: StateDict = {}
    for k, v in state.items():
        if k in want or _SWINIR_BUFFERS.fullmatch(k):
            continue
        m = _HAT_UP.match(k)
        if m:
            out[f"tail.{3 * (int(m.group(1)) // 2)}.{m.group(2)}"] = v
        elif k.startswith("conv_last."):
            out[f"tail.{3 * n_up}.{k.split('.', 1)[1]}"] = v
        else:
            out[k] = v
    return out
