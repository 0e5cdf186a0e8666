"""The port's RRDBNet (innfer_tpu_torch/models/rrdb.py) against the JAX
model on identical weights, and against the reference goldens.

Weights cross from the JAX package with ``params_from_jax``; inputs are
seeded numpy arrays.  fp32 tolerance atol 1e-4 (two frameworks' CPU convs
sum in different orders over a few layers).  Goldens: >= 80 dB in fp32,
>= 60 dB for the fp16 checkpoint, the JAX suite's bars.
"""
import json
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from innfer_tpu.config.defaults import get_network_config as jax_config
from innfer_tpu.loader import load_model_from_state as jax_load_from_state
from innfer_tpu.models.base import cast_params as jax_cast_params
from innfer_tpu_torch.checkpoint.detect import load_checkpoint
from innfer_tpu_torch.config.defaults import get_network_config
from innfer_tpu_torch.loader import load_model, load_model_from_state
from innfer_tpu_torch.models import cast_params, get_network, params_from_jax
from innfer_tpu_torch.ops import rdb as RDB
from innfer_tpu_torch.ops.rdb import fused_rdb
from tools import synth_params as SP

GOLDENS = os.path.join(os.path.dirname(__file__), "goldens")


def psnr(a, b):
    peak = max(1.0, float(np.abs(b).max()))
    mse = np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2)
    return np.inf if mse == 0 else 10 * np.log10(peak ** 2 / mse)


def _pair(plus=False, scale=4):
    """The same small ESRGAN in both packages: (jax model, jax params,
    port model, port params)."""
    spec = {"type": "esrgan", "nb": 2, "nf": 32, "gc": 16, "plus": plus}
    state = SP.esrgan_state(nb=2, nf=32, gc=16, scale=scale, plus=plus, seed=3)
    jm, jp = jax_load_from_state(state, jax_config(spec, scale))
    tm = get_network(jax_config(spec, scale))
    tp = params_from_jax({k: np.asarray(v) for k, v in jp.items()})
    return jm, jp, tm, tp


def _x(h=20, w=28, seed=0):
    return np.random.default_rng(seed).random((1, h, w, 3), np.float32)


@pytest.mark.parametrize("part", ["trunk", "tail", "apply"])
@pytest.mark.parametrize("plus", [False, True])
def test_matches_jax_model_fp32(part, plus):
    jm, jp, tm, tp = _pair(plus=plus)
    x = _x()
    if part == "tail":
        x = np.array(jm.apply_trunk(jp, jnp.asarray(x)))  # writable copy
    fn_j = {"trunk": jm.apply_trunk, "tail": jm.apply_tail, "apply": jm.apply}[part]
    fn_t = {"trunk": tm.apply_trunk, "tail": tm.apply_tail, "apply": tm.apply}[part]
    ref = np.asarray(fn_j(jp, jnp.asarray(x)))
    out = fn_t(tp, torch.from_numpy(x)).numpy()
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, atol=1e-4, rtol=0)


@pytest.mark.parametrize("nb", [1, 2])
def test_bf16_trunk_rounds_like_the_jax_package(nb):
    """The RDB and RRDB residuals and the LReLU slope multiply by 0.2 in the
    activation dtype (bf16(0.2) = 0.2001953125), as the JAX package does;
    a Python 0.2 multiplies by fp32 0.2f and changes the rounding of about
    15% of a 1-RRDB trunk's outputs (23% at 2 RRDBs).

    The biases are made bf16-representable so that this test isolates the
    0.2 scales from the conv bias (held on its own, with fp32 biases, by
    tests/test_torch_functional.py); what is left is the two frameworks'
    CPU conv summation order flipping a rare bf16 rounding, which the next
    convs spread (0.03% of values at nb=1, 0.4% at nb=2, each at most one
    bf16 ulp)."""
    spec = {"type": "esrgan", "nb": nb, "nf": 32, "gc": 16}
    state = SP.esrgan_state(nb=nb, nf=32, gc=16, scale=4, seed=5)
    # bf16-representable biases: no rounding when the port casts them
    state = {k: (v.astype(jnp.bfloat16).astype(np.float32) if v.ndim == 1 else v)
             for k, v in state.items()}
    jm, jp = jax_load_from_state(state, jax_config(spec, 4))
    tm = get_network(jax_config(spec, 4))
    tp = params_from_jax({k: np.asarray(v) for k, v in jp.items()})
    x = np.random.default_rng(1).random((1, 24, 32, 3), np.float32)
    ref = np.asarray(jm.apply_trunk(jax_cast_params(jp, jnp.bfloat16),
                                    jnp.asarray(x, jnp.bfloat16)), np.float32)
    out = tm.apply_trunk(cast_params(tp, torch.bfloat16),
                         torch.from_numpy(x).to(torch.bfloat16)).float().numpy()
    d = np.abs(out - ref)
    assert (d > 0).mean() < 0.01, (d > 0).mean()
    assert (d <= 2.0 ** -8 * np.maximum(np.abs(ref), 1)).all(), d.max()


def test_kernel_backend_on_cpu_runs_the_plain_version(monkeypatch):
    """The kernel's route (``rdb.fusable`` patched to the card's answer) on
    CPU tensors goes through the wrapper's plain version: the same function
    as the model's plain gather form, no launches."""
    _jm, _jp, tm, tp = _pair()
    x = torch.from_numpy(_x(seed=1))
    plain = tm.apply(tp, x).numpy()
    calls = []
    monkeypatch.setattr(RDB, "fusable", lambda *a, **k: calls.append(1) or RDB.takes(*a, **k))
    before = fused_rdb.launches
    np.testing.assert_allclose(tm.apply(tp, x).numpy(), plain, atol=1e-5, rtol=0)
    assert len(calls) == 6 and fused_rdb.launches == before


def _golden(name):
    fx = np.load(os.path.join(GOLDENS, f"{name}.npz"))
    return fx, json.loads(str(fx["meta"]))


@pytest.mark.parametrize("name,min_db", [
    ("esrgan_x1", 80), ("esrgan_x2", 80), ("esrgan_x3", 80), ("esrgan_x4", 80),
    ("esrgan_x4_legacy", 80), ("esrgan_x4_swa", 80), ("esrgan_plus_x2", 80),
    ("esrganlite_x4", 80), ("mesrgan_x4", 80), ("esrgan_x4_fp16", 60),
])
def test_golden_through_load_model(name, min_db):
    fx, meta = _golden(name)
    # x3 shares the single-upsampler layout with x2: the scale comes from
    # the caller, as the CLI takes it from the '3x_' filename
    model, params = load_model(os.path.join(GOLDENS, f"{name}.pth"),
                               scale=meta.get("scale"), device="cpu")
    x = torch.from_numpy(np.ascontiguousarray(np.transpose(fx["input"], (0, 2, 3, 1))))
    with torch.no_grad():
        out = model.apply(params, x).permute(0, 3, 1, 2).numpy()
    assert out.shape == fx["output"].shape
    assert psnr(out, fx["output"]) >= min_db


@pytest.mark.parametrize("name", ["esrgan_x2", "esrgan_x4_swa", "esrgan_plus_x2",
                                  "mesrgan_x4", "esrganlite_x4", "esrgan_x4_legacy"])
def test_detection_equals_jax(name):
    from innfer_tpu.checkpoint.detect import detect_and_infer as jax_detect
    from innfer_tpu.checkpoint.remaps import swa_to_normal as jax_swa
    from innfer_tpu.checkpoint.torch_pickle import load_checkpoint as jax_load
    from innfer_tpu_torch.checkpoint.detect import detect_and_infer
    from innfer_tpu_torch.checkpoint.remaps import swa_to_normal

    path = os.path.join(GOLDENS, f"{name}.pth")
    fam, cfg, state = detect_and_infer(swa_to_normal(load_checkpoint(path)))
    jfam, jcfg, jstate = jax_detect(jax_swa(jax_load(path)))
    assert (fam, cfg) == (jfam, jcfg)
    assert sorted(state) == sorted(jstate)


def test_golden_nr2_through_load_model_from_state():
    fx, meta = _golden("esrgan_nr2_x2")
    state = load_checkpoint(os.path.join(GOLDENS, "esrgan_nr2_x2.pth"))
    model, params = load_model_from_state(state, dict(meta["cfg"]), device="cpu")
    x = torch.from_numpy(np.ascontiguousarray(np.transpose(fx["input"], (0, 2, 3, 1))))
    with torch.no_grad():
        out = model.apply(params, x).permute(0, 3, 1, 2).numpy()
    assert psnr(out, fx["output"]) >= 80


@pytest.mark.parametrize("spec", [
    {"type": "wbcunet"},
    {"type": "wbcunet_tf"},
    {"type": "evsrgan"},
    {"type": "unet_128"},
    {"type": "p2p_128"},
    {"type": "unet_256"},
])
def test_configs_of_later_slices_raise(spec):
    """The families of the later slices (evsrgan's Conv3D, the
    image-to-image families) build from the JAX package's config, as the
    JAX package's models; none raises any more."""
    from innfer_tpu.models import get_network as jax_get_network

    cfg = get_network_config(dict(spec), 2)
    assert cfg == jax_config(dict(spec), 2)
    model = get_network(cfg)
    jax_model = jax_get_network(cfg)
    assert (model.name, model.scale, model.cfg) == (jax_model.name, jax_model.scale,
                                                    jax_model.cfg)


@pytest.mark.parametrize("spec", [
    "esrgan", "esrgan-lite", "evsrgan", "mesrgan", "rrdb_net",
    {"type": "esrgan", "nb": 3, "nf": 16, "plus": True, "outm": "clamp"},
    {"which_model_G": "mesrgan", "nb": 2},
])
def test_config_defaults_equal_jax(spec):
    assert get_network_config(spec, 4) == jax_config(spec, 4)


def test_cast_params_keeps_biases_fp32_and_the_diagnostic():
    from innfer_tpu_torch.models.base import ParamDict, cast_params

    _jm, _jp, _tm, tp = _pair()
    cast = cast_params(tp, torch.bfloat16)
    assert isinstance(cast, ParamDict) and cast.cache == {}
    assert cast["model.0.weight"].dtype == torch.bfloat16
    assert cast["model.0.bias"].dtype == torch.float32
    with pytest.raises(KeyError, match="does not match the checkpoint"):
        cast["model.99.weight"]


def test_default_device_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        load_model(os.path.join(GOLDENS, "esrgan_x2.pth"))
