"""evsrgan (RRDBNet with Conv3D, on NDHWC clips) and ``nn/functional.conv3d``
against the JAX package and the reference golden.

conv3d: fp32 within 1e-5 of ``innfer_tpu.nn.functional.conv3d``; bf16 the
JAX package's own values (the same rounding point: fp32 accumulator, fp32
bias, one rounding) in >= 99% of outputs.  The model: the ``evsrgan_x2``
golden >= 80 dB, and the port against the JAX model on the same weights
(``params_from_jax`` carries the DHWIO weights to OIDHW) >= 80 dB.
"""
import json
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from innfer_tpu.checkpoint.torch_pickle import load_checkpoint as jax_load
from innfer_tpu.config.defaults import get_network_config as jax_config
from innfer_tpu.loader import load_model_from_state as jax_load_from_state
from innfer_tpu.models import get_network as jax_get_network
from innfer_tpu.nn import functional as JF
from innfer_tpu_torch.checkpoint.detect import load_checkpoint
from innfer_tpu_torch.config.defaults import get_network_config
from innfer_tpu_torch.loader import load_model, load_model_from_state
from innfer_tpu_torch.models import get_network, params_from_jax
from innfer_tpu_torch.nn import functional as F
from innfer_tpu_torch.pipeline import InferenceSession

GOLDENS = os.path.join(os.path.dirname(__file__), "goldens")


def psnr(a, b):
    mse = np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2)
    return np.inf if mse == 0 else 10 * np.log10(max(1.0, np.abs(b).max()) ** 2 / mse)


def _golden():
    fx = np.load(os.path.join(GOLDENS, "evsrgan_x2.npz"))
    return fx, json.loads(str(fx["meta"]))


@pytest.mark.parametrize("stride,padding,dilation", [(1, 1, 1), (1, 0, 1), (2, 1, 1),
                                                     (1, 2, 2), (1, (0, 1, 1), 1)])
@pytest.mark.parametrize("bias", [True, False])
def test_conv3d_matches_jax_fp32(stride, padding, dilation, bias):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 5, 9, 7, 4)).astype(np.float32)
    w = (rng.standard_normal((3, 3, 3, 4, 6)) * 0.2).astype(np.float32)  # DHWIO
    b = rng.standard_normal(6).astype(np.float32) if bias else None
    ref = np.asarray(JF.conv3d(jnp.asarray(x), jnp.asarray(w),
                               None if b is None else jnp.asarray(b),
                               stride=stride, padding=padding, dilation=dilation))
    wt = torch.from_numpy(np.ascontiguousarray(np.transpose(w, (4, 3, 0, 1, 2))))
    out = F.conv3d(torch.from_numpy(x), wt, None if b is None else torch.from_numpy(b),
                   stride=stride, padding=padding, dilation=dilation)
    assert tuple(out.shape) == ref.shape
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-5)


def test_conv3d_matches_jax_bf16():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((1, 4, 10, 8, 16)).astype(np.float32)
    w = (rng.standard_normal((3, 3, 3, 16, 8)) * 0.1).astype(np.float32)
    b = rng.standard_normal(8).astype(np.float32)  # not bf16-representable
    ref = np.asarray(JF.conv3d(jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16),
                               jnp.asarray(b), padding=1), np.float32)
    wt = torch.from_numpy(np.ascontiguousarray(np.transpose(w, (4, 3, 0, 1, 2)))).bfloat16()
    out = F.conv3d(torch.from_numpy(x).bfloat16(), wt, torch.from_numpy(b), padding=1)
    assert out.dtype == torch.bfloat16
    assert np.mean(out.float().numpy() == ref) >= 0.99


def test_evsrgan_golden():
    fx, meta = _golden()
    model, params = load_model_from_state(load_checkpoint(os.path.join(GOLDENS, "evsrgan_x2.pth")),
                                          dict(meta["cfg"]), device="cpu")
    x = torch.from_numpy(np.ascontiguousarray(np.transpose(fx["input"], (0, 2, 3, 4, 1))))
    with torch.no_grad():
        out = model.apply(params, x).permute(0, 4, 1, 2, 3).numpy()
    assert out.shape == fx["output"].shape
    assert psnr(out, fx["output"]) >= 80


def test_evsrgan_through_load_model_with_the_arch():
    """``-a evsrgan`` builds the Conv3D model with the library defaults and
    keeps the checkpoint's 5-D weights as they are (OIDHW)."""
    model, params = load_model(os.path.join(GOLDENS, "evsrgan_x2.pth"), arch="evsrgan",
                               scale=2, device="cpu")
    state = load_checkpoint(os.path.join(GOLDENS, "evsrgan_x2.pth"))
    assert (model.cfg["convtype"], model.scale, model.cfg["nb"]) == ("Conv3D", 2, 23)
    assert model.apply_trunk is None and not model.trunk_kernel
    for k, v in state.items():
        assert torch.equal(params[k], v.float())


@pytest.mark.parametrize("spec", [
    {"nb": 2, "nf": 8, "gc": 8, "scale": 2},
    {"nb": 1, "nf": 8, "gc": 4, "scale": 4, "act_type": "relu", "finalact": "tanh",
     "outm": "clamp"},
])
def test_port_matches_jax_evsrgan(spec):
    spec = dict(spec)
    scale = spec.pop("scale")
    cfg = jax_config({"type": "evsrgan", **spec}, scale)
    jm, jp = jax_load_from_state(_state(cfg, seed=3), cfg)
    tm = get_network(cfg)
    tp = params_from_jax({k: np.asarray(v) for k, v in jp.items()}, tm)
    assert tuple(tp["model.0.weight"].shape) == (cfg["nf"], 3, 3, 3, 3)
    x = np.random.default_rng(4).random((1, 3, 10, 12, 3), np.float32)
    ref = np.asarray(jm.apply(jp, jnp.asarray(x)))
    with torch.no_grad():
        out = tm.apply(tp, torch.from_numpy(x)).numpy()
    assert out.shape == ref.shape == (1, 3, 10 * scale, 12 * scale, 3)
    assert psnr(out, ref) >= 80


def _state(cfg, seed):
    """A seeded evsrgan state dict (OIDHW) in the flattened key layout."""
    rng = np.random.default_rng(seed)
    nf, gc, nb = cfg["nf"], cfg["gc"], cfg["nb"]
    state = {}

    def conv(key, o, i):
        std = np.sqrt(3.0 / (27 * i))
        state[f"{key}.weight"] = rng.uniform(-std, std, (o, i, 3, 3, 3)).astype(np.float32)
        state[f"{key}.bias"] = rng.uniform(-0.01, 0.01, o).astype(np.float32)

    conv("model.0", nf, 3)
    for i in range(nb):
        for j in (1, 2, 3):
            for c in range(1, 6):
                conv(f"model.1.sub.{i}.RDB{j}.conv{c}.0", gc if c < 5 else nf, nf + (c - 1) * gc)
    conv(f"model.1.sub.{nb}", nf, nf)
    idx = 2
    for _ in range({2: 1, 4: 2}[cfg["upscale"]]):
        conv(f"model.{idx + 1}", nf, nf)
        idx += 3
    conv(f"model.{idx}", nf, nf)
    conv(f"model.{idx + 2}", 3, nf)
    return state


@pytest.mark.parametrize("extra,match", [
    ({"plus": True}, "evsrgan plus"),
    ({"norm_type": "batch"}, "evsrgan norm layers"),
    ({"upsample_mode": "pixelshuffle"}, "upconv upsampling only"),
    ({"act_type": "prelu"}, "only parameter-free activations"),
])
def test_build_rejections_match_jax(extra, match):
    cfg = get_network_config({"type": "evsrgan", **extra}, 2)
    assert cfg == jax_config({"type": "evsrgan", **extra}, 2)
    with pytest.raises(NotImplementedError) as port:
        get_network(cfg)
    with pytest.raises(NotImplementedError) as ref:
        jax_get_network(cfg)
    assert match in str(port.value) and str(port.value) == str(ref.value)


def test_unknown_convtype_is_refused_like_jax():
    cfg = get_network_config({"type": "esrgan", "convtype": "Conv1D"}, 2)
    with pytest.raises(NotImplementedError, match="convtype Conv1D not supported"):
        get_network(cfg)
    with pytest.raises(NotImplementedError, match="convtype Conv1D not supported"):
        jax_get_network(cfg)


def test_session_refuses_evsrgan_with_the_jax_error():
    from innfer_tpu.pipeline import InferenceSession as JaxSession

    path = os.path.join(GOLDENS, "evsrgan_x2.pth")
    with pytest.raises(ValueError) as port:
        InferenceSession(path, arch="evsrgan", compute_dtype=torch.float32, device="cpu")
    with pytest.raises(ValueError) as ref:
        JaxSession(path, arch="evsrgan", compute_dtype=jnp.float32)
    assert "Conv3D" in str(port.value)
    assert str(port.value) == str(ref.value).replace("innfer_tpu.loader", "innfer_tpu_torch.loader")


def test_params_from_jax_carries_5d_weights_to_oidhw():
    _fx, meta = _golden()
    state = jax_load(os.path.join(GOLDENS, "evsrgan_x2.pth"))
    jm, jp = jax_load_from_state(state, dict(meta["cfg"]))
    tp = params_from_jax({k: np.asarray(v) for k, v in jp.items()})
    for k, v in state.items():
        np.testing.assert_array_equal(tp[k].numpy(), v)
