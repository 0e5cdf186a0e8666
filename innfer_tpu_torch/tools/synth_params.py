"""Synthetic (random-init) state dicts and models for the port's bench.

The port's own copy of the JAX package's ``tools/synth_params.py``: the
same torch-layout state dicts (OIHW, the reference's key names) for every
architecture family at any size, drawn from ``np.random.default_rng(seed)``
in the same order, so the same seed and sizes give the same keys and the
same arrays as the JAX package's copy, and both benches run identical
weights.  :func:`build` runs them through the port's own config defaults
and converter, so a synthetic model is built exactly as a checkpoint's is.
"""
from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch

from innfer_tpu_torch.config.defaults import get_network_config
from innfer_tpu_torch.device import DeviceLike
from innfer_tpu_torch.loader import load_model_from_state

StateDict = Dict[str, np.ndarray]


class _Maker:
    def __init__(self, seed: int):
        self.rng = np.random.default_rng(seed)
        self.state: StateDict = {}

    def conv(self, key: str, o: int, i: int, k: int = 3, bias: bool = True):
        std = 1.0 / math.sqrt(i * k * k)
        self.state[f"{key}.weight"] = self.rng.uniform(
            -std, std, size=(o, i, k, k)).astype(np.float32)
        if bias:
            self.state[f"{key}.bias"] = self.rng.uniform(
                -0.01, 0.01, size=(o,)).astype(np.float32)

    def deconv(self, key: str, i: int, o: int, k: int, bias: bool = True):
        std = 1.0 / math.sqrt(i * k * k)
        self.state[f"{key}.weight"] = self.rng.uniform(
            -std, std, size=(i, o, k, k)).astype(np.float32)
        if bias:
            self.state[f"{key}.bias"] = self.rng.uniform(
                -0.01, 0.01, size=(o,)).astype(np.float32)

    def conv1d(self, key: str, o: int, i: int):
        std = 1.0 / math.sqrt(i)
        self.state[f"{key}.weight"] = self.rng.uniform(
            -std, std, size=(o, i, 1)).astype(np.float32)
        self.state[f"{key}.bias"] = self.rng.uniform(
            -0.01, 0.01, size=(o,)).astype(np.float32)

    def norm_affine(self, key: str, c: int, running: bool = True):
        self.state[f"{key}.weight"] = np.ones(c, np.float32)
        self.state[f"{key}.bias"] = np.zeros(c, np.float32)
        if running:
            self.state[f"{key}.running_mean"] = np.zeros(c, np.float32)
            self.state[f"{key}.running_var"] = np.ones(c, np.float32)

    def scalar(self, key: str, v: float = 0.0):
        self.state[key] = np.full((1,), v, np.float32)


def _n_up(scale: int) -> int:
    return 1 if scale == 3 else (0 if scale == 1 else int(math.log2(scale)))


def esrgan_state(nb=23, nf=64, gc=32, in_nc=3, out_nc=3, scale=4, plus=False,
                 seed=0) -> StateDict:
    m = _Maker(seed)
    m.conv("model.0", nf, in_nc)
    for i in range(nb):
        for j in (1, 2, 3):
            p = f"model.1.sub.{i}.RDB{j}"
            for c in range(1, 6):
                m.conv(f"{p}.conv{c}.0", gc if c < 5 else nf, nf + (c - 1) * gc)
            if plus:
                m.conv(f"{p}.conv1x1", gc, nf, k=1, bias=False)
    m.conv(f"model.1.sub.{nb}", nf, nf)
    idx = 2
    for _ in range(_n_up(scale)):
        m.conv(f"model.{idx + 1}", nf, nf)
        idx += 3
    m.conv(f"model.{idx}", nf, nf)
    m.conv(f"model.{idx + 2}", out_nc, nf)
    return m.state


def srresnet_state(nb=16, nf=64, in_nc=3, out_nc=3, scale=4, seed=0) -> StateDict:
    m = _Maker(seed)
    m.conv("model.0", nf, in_nc)
    for i in range(nb):
        m.conv(f"model.1.sub.{i}.res.0", nf, nf)
        m.conv(f"model.1.sub.{i}.res.2", nf, nf)
    m.conv(f"model.1.sub.{nb}", nf, nf)
    idx = 2
    for _ in range(_n_up(scale)):
        factor = 3 if scale == 3 else 2
        m.conv(f"model.{idx}", nf * factor * factor, nf)  # pixelshuffle conv
        idx += 3
    m.conv(f"model.{idx}", nf, nf)
    m.conv(f"model.{idx + 2}", out_nc, nf)
    return m.state


def ppon_state(nb=24, nf=64, in_nc=3, out_nc=3, scale=4, seed=0) -> StateDict:
    m = _Maker(seed)

    def rrblock(prefix):
        for rb in ("RB1", "RB2", "RB3"):
            p = f"{prefix}.{rb}"
            m.conv(f"{p}.c1", nf, nf)
            for r in range(1, 9):
                m.conv(f"{p}.d{r}", nf // 2, nf)
            m.conv(f"{p}.c2", nf, nf * 4, k=1)

    m.conv("CFEM.0", nf, in_nc)
    for i in range(nb):
        rrblock(f"CFEM.1.sub.{i}")
    m.conv(f"CFEM.1.sub.{nb}", nf, nf)
    for i in range(2):
        rrblock(f"SFEM.{i}")
        rrblock(f"PFEM.{i}")
    for mod in ("CRM", "SRM", "PRM"):
        n_up = _n_up(scale)
        for u in range(n_up):
            m.conv(f"{mod}.{3 * u + 1}", nf, nf)
        m.conv(f"{mod}.{3 * n_up}", nf, nf)
        m.conv(f"{mod}.{3 * n_up + 2}", out_nc, nf)
    return m.state


def pan_state(nb=16, nf=40, unf=24, in_nc=3, out_nc=3, scale=4,
              self_attention=True, seed=0) -> StateDict:
    m = _Maker(seed)
    m.conv("conv_first", nf, in_nc)
    for i in range(nb):
        p = f"SCPA_trunk.{i}"
        gw = nf // 2
        m.conv(f"{p}.conv1_a", gw, nf, k=1, bias=False)
        m.conv(f"{p}.conv1_b", gw, nf, k=1, bias=False)
        m.conv(f"{p}.k1.0", gw, gw, bias=False)
        m.conv(f"{p}.PACnv.k2", gw, gw, k=1)
        m.conv(f"{p}.PACnv.k3", gw, gw, bias=False)
        m.conv(f"{p}.PACnv.k4", gw, gw, bias=False)
        m.conv(f"{p}.conv3", nf, nf, k=1, bias=False)
    m.conv("trunk_conv", nf, nf)
    if self_attention:
        m.conv1d("FSA.conv_f", nf // 8, nf)
        m.conv1d("FSA.conv_g", nf // 8, nf)
        m.conv1d("FSA.conv_h", nf, nf)
        m.scalar("FSA.gamma", 0.1)
    n_up = _n_up(scale)
    stride = 5 if n_up >= 2 else 6
    cin = nf
    for u in range(n_up):
        m.conv(f"upsample.{stride * u + 1}", unf, cin)
        m.conv(f"upsample.{stride * u + 2}.conv", unf, unf, k=1)
        m.conv(f"upsample.{stride * u + 4}", unf, unf)
        cin = unf
    m.conv("conv_last", out_nc, unf if n_up else nf)
    return m.state


def unet_state(num_downs=8, ngf=64, input_nc=3, output_nc=3,
               norm="batch", seed=0) -> StateDict:
    m = _Maker(seed)
    use_bias = norm == "instance"
    outer = [input_nc, ngf, ngf * 2, ngf * 4] + [ngf * 8] * (num_downs - 4)
    inner = [ngf, ngf * 2, ngf * 4, ngf * 8] + [ngf * 8] * (num_downs - 4)
    pre = "model.model"
    for l in range(num_downs):
        innermost = l == num_downs - 1
        if l == 0:
            m.conv(f"{pre}.0", inner[l], outer[l], k=4, bias=use_bias)
            m.deconv(f"{pre}.3", inner[l] * 2, output_nc, k=4, bias=True)
        elif innermost:
            m.conv(f"{pre}.1", inner[l], outer[l], k=4, bias=use_bias)
            m.deconv(f"{pre}.3", inner[l], outer[l], k=4, bias=use_bias)
            if norm == "batch":
                m.norm_affine(f"{pre}.4", outer[l])
        else:
            m.conv(f"{pre}.1", inner[l], outer[l], k=4, bias=use_bias)
            m.deconv(f"{pre}.5", inner[l] * 2, outer[l], k=4, bias=use_bias)
            if norm == "batch":
                m.norm_affine(f"{pre}.2", inner[l])
                m.norm_affine(f"{pre}.6", outer[l])
        pre = pre + (".1.model" if l == 0 else ".3.model")
    return m.state


def cyclegan_state(n_blocks=9, ngf=64, input_nc=3, output_nc=3, seed=0) -> StateDict:
    """Instance-norm variant (no norm params)."""
    m = _Maker(seed)
    m.conv("model.1", ngf, input_nc, k=7)
    m.conv("model.4", ngf * 2, ngf)
    m.conv("model.7", ngf * 4, ngf * 2)
    for i in range(n_blocks):
        m.conv(f"model.{10 + i}.conv_block.1", ngf * 4, ngf * 4)
        m.conv(f"model.{10 + i}.conv_block.5", ngf * 4, ngf * 4)
    m.deconv(f"model.{10 + n_blocks}", ngf * 4, ngf * 2, k=3)
    m.deconv(f"model.{13 + n_blocks}", ngf * 2, ngf, k=3)
    m.conv(f"model.{17 + n_blocks}", output_nc, ngf, k=7)
    return m.state


def wbc_state(nf=32, seed=0) -> StateDict:
    m = _Maker(seed)
    m.conv("conv", nf, 3, k=7)
    m.conv("conv_1", nf, nf)
    m.conv("conv_2", nf * 2, nf)
    m.conv("conv_3", nf * 2, nf * 2)
    m.conv("conv_4", nf * 4, nf * 2)
    for i in range(4):
        m.conv(f"block_{i}.conv1", nf * 4, nf * 4)
        m.conv(f"block_{i}.conv2", nf * 4, nf * 4)
    m.conv("conv_5", nf * 2, nf * 4)
    m.conv("conv_6", nf * 2, nf * 2)
    m.conv("conv_7", nf, nf * 2)
    m.conv("conv_8", nf, nf)
    m.conv("conv_9", 3, nf, k=7)
    return m.state


STATES = {"esrgan": (esrgan_state, "esrgan"), "srresnet": (srresnet_state, "srgan"),
          "ppon": (ppon_state, "ppon"), "pan": (pan_state, "pan"),
          "unet": (unet_state, "unet_256"), "cyclegan": (cyclegan_state, "resnet_9blocks"),
          "wbc": (wbc_state, "wbcunet")}
SR_FAMILIES = ("esrgan", "srresnet", "ppon", "pan")


def state(family: str, *, scale: int = 4, seed: int = 0, **kw) -> StateDict:
    """The seeded state dict of ``family``; the image-to-image families
    (unet, cyclegan, wbc) are 1x and take no scale."""
    if family not in STATES:
        raise ValueError(f"unknown family {family}")
    make = STATES[family][0]
    return make(scale=scale, seed=seed, **kw) if family in SR_FAMILIES else make(seed=seed, **kw)


def build(family: str, *, scale: int = 4, dtype: torch.dtype = torch.float32, seed: int = 0,
          device: DeviceLike, **kw):
    """(ModelDef, params on ``device``) for a random-init model of the
    given family, as the JAX package's ``build`` makes it.  ``device`` has
    no default: pass the card, or ``"cpu"``."""
    sd = state(family, scale=scale, seed=seed, **kw)
    spec = {"type": STATES[family][1], **{k: v for k, v in kw.items() if k != "norm"}}
    cfg = get_network_config(spec, scale if family in SR_FAMILIES else 1)
    return load_model_from_state(sd, cfg, param_dtype=dtype, device=device)
