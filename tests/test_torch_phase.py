"""The port's exact tail rewrites against the JAX package: ``nn/phase.py``,
``collapse_upconv_weight``, the phase-space tail, asymmetric conv2d
padding, and the derived-weight cache.

Tolerances: the phase functions are pure placements of taps, so they are
held at fp32 1e-5 (accumulation order only); the collapse pre-sums taps in
fp32, 1e-6 in fp32 and bit-equal in bf16 (a sum of two to four bf16 taps
is exact in fp32).  Each tail form against the plain tail: fp32 >= 110 dB,
bf16 >= 35 dB, the JAX package's own bars (tests/test_phase.py).  The
forms are forced by patching the predicates of ``models/common.py``, as
the JAX package's tests force its materialized tail:
  a: plain (nearest-up + HR conv); b: LR-collapsed upconv blocks;
  c: collapsed blocks + the phase tail (the JAX package's default);
  d: c with the dense phase conv.
"""
import json
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from innfer_tpu.config.defaults import get_network_config as jax_config
from innfer_tpu.loader import load_model_from_state as jax_load_from_state
from innfer_tpu.models import common as JC
from innfer_tpu.nn import functional as JF
from innfer_tpu.nn import phase as JPH
from innfer_tpu.tiling import engine as JE
from innfer_tpu_torch.checkpoint.detect import load_checkpoint
from innfer_tpu_torch.checkpoint.remaps import swa_to_normal
from innfer_tpu_torch.loader import load_model_from_state
from innfer_tpu_torch.models import cast_params, get_network, params_from_jax
from innfer_tpu_torch.models import common as C
from innfer_tpu_torch.nn import functional as F
from innfer_tpu_torch.nn import phase as PH
from innfer_tpu_torch.tiling import engine as TE
from tools import synth_params as SP

GOLDENS = os.path.join(os.path.dirname(__file__), "goldens")
FORMS = ("a", "b", "c", "d")


def psnr(a, b):
    mse = np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2)
    return np.inf if mse == 0 else 10 * np.log10(max(1.0, np.abs(b).max()) ** 2 / mse)


def _oihw(w_hwio):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(w_hwio, (3, 2, 0, 1))))


def _hwio(w_oihw):
    return np.transpose(w_oihw.float().numpy(), (2, 3, 1, 0))


def force(monkeypatch, form):
    """Route the port's tails through one form (see the module docstring)."""
    if form == "a":
        monkeypatch.setattr(C, "upconv_collapse_ok", lambda *a, **k: False)
    if form in "ab":
        monkeypatch.setattr(C, "phase_tail_ok", lambda *a, **k: False)
    if form == "d":
        def dense(params, p, key, r=2, act=None):
            return F.act(act, PH.phase_conv3x3_dense(p, params[f"{key}.weight"],
                                                     params.get(f"{key}.bias"), r))

        monkeypatch.setattr(C, "phase_hr_conv", dense)


# ---------------------------------------------------------------------------
# nn/phase.py against innfer_tpu/nn/phase.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("r", [2, 3])
def test_windows_and_selections_equal_jax(r):
    assert PH._phase_windows(r) == JPH._phase_windows(r)
    np.testing.assert_array_equal(PH._phase_sel(r), JPH._phase_sel(r))


def _w(rng, cin=5, cout=7):
    return (rng.standard_normal((3, 3, cin, cout)) * 0.2).astype(np.float32)


@pytest.mark.parametrize("r", [2, 3])
def test_phase_kernels_equal_jax(r):
    w = _w(np.random.default_rng(r))
    ref = JPH.phase_kernels(jnp.asarray(w), r)
    out = PH.phase_kernels(_oihw(w), r)
    assert len(out) == len(ref) == r * r
    for (k, pad), (kj, padj) in zip(out, ref):
        assert pad == tuple(tuple(p) for p in padj)
        np.testing.assert_array_equal(_hwio(k), np.asarray(kj))


@pytest.mark.parametrize("fn", ["phase_conv3x3", "phase_conv3x3_dense"])
@pytest.mark.parametrize("r", [2, 3])
@pytest.mark.parametrize("bias", [True, False])
def test_phase_convs_match_jax(fn, r, bias):
    rng = np.random.default_rng(10 + r)
    w = _w(rng)
    b = rng.standard_normal(7).astype(np.float32) if bias else None
    p = rng.standard_normal((2, 6, 4, r * r * 5)).astype(np.float32)
    ref = getattr(JPH, fn)(jnp.asarray(p), jnp.asarray(w), None if b is None else jnp.asarray(b), r)
    out = getattr(PH, fn)(torch.from_numpy(p), _oihw(w),
                          None if b is None else torch.from_numpy(b), r)
    assert out.shape == ref.shape
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0, atol=1e-5)


def _hr_to_phase(hr, r):
    b, h, w, c = hr.shape
    t = hr.reshape(b, h // r, r, w // r, r, c)
    return np.ascontiguousarray(t.transpose(0, 1, 3, 2, 4, 5).reshape(b, h // r, w // r, r * r * c))


@pytest.mark.parametrize("r", [2, 3])
def test_phase_conv_equals_the_hr_conv(r):
    """The merged per-phase conv (one conv, per-phase crops) is the HR
    conv: tests/test_phase.py's contract on the port."""
    rng = np.random.default_rng(20 + r)
    hr = rng.standard_normal((2, 6 * r, 4 * r, 5)).astype(np.float32)
    w, b = _w(rng), torch.from_numpy(rng.standard_normal(7).astype(np.float32))
    ref = F.conv2d(torch.from_numpy(hr), _oihw(w), b, padding=1)
    out = PH.phase_shuffle_out(PH.phase_conv3x3(torch.from_numpy(_hr_to_phase(hr, r)),
                                                _oihw(w), b, r), r)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=0, atol=1e-5)


@pytest.mark.parametrize("r", [2, 3])
def test_shuffle_and_permutations_equal_jax(r):
    rng = np.random.default_rng(30 + r)
    p = rng.standard_normal((2, 4, 3, r * r * 3)).astype(np.float32)
    np.testing.assert_array_equal(PH.phase_shuffle_out(torch.from_numpy(p), r).numpy(),
                                  np.asarray(JPH.phase_shuffle_out(jnp.asarray(p), r)))
    w = _w(rng, cin=4, cout=3 * r * r)
    np.testing.assert_array_equal(_hwio(PH.cmajor_to_phase_major(_oihw(w), r)),
                                  np.asarray(JPH.cmajor_to_phase_major(jnp.asarray(w), r)))
    b = rng.standard_normal(3 * r * r).astype(np.float32)
    np.testing.assert_array_equal(
        PH.cmajor_bias_to_phase_major(torch.from_numpy(b), r).numpy(),
        np.asarray(JPH.cmajor_bias_to_phase_major(jnp.asarray(b), r)))
    np.testing.assert_array_equal(PH.phase_bias(torch.from_numpy(b[:3]), r).numpy(),
                                  np.asarray(JPH.phase_bias(jnp.asarray(b[:3]), r)))
    assert PH.phase_bias(None, r) is None and PH.cmajor_bias_to_phase_major(None, r) is None


def test_pixelshuffle_conv_in_phase_major_order():
    """pixelshuffle conv + PixelShuffle == phase-major conv + shuffle out."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((1, 6, 5, 4)).astype(np.float32))
    w = _oihw(_w(rng, cin=4, cout=12))
    b = torch.from_numpy(rng.standard_normal(12).astype(np.float32))
    ref = F.pixel_shuffle(F.conv2d(x, w, b, padding=1), 2)
    out = PH.phase_shuffle_out(F.conv2d(x, PH.cmajor_to_phase_major(w, 2),
                                        PH.cmajor_bias_to_phase_major(b, 2), padding=1), 2)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# collapse_upconv_weight and asymmetric conv2d padding
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("r", [2, 3, 4])
@pytest.mark.parametrize("bias", [True, False])
def test_collapse_matches_jax_fp32(r, bias):
    rng = np.random.default_rng(40 + r)
    w = rng.standard_normal((3, 3, 8, 5)).astype(np.float32)
    b = rng.standard_normal(5).astype(np.float32) if bias else None
    wj, bj = JC.collapse_upconv_weight(jnp.asarray(w), None if b is None else jnp.asarray(b), r)
    wt, bt = C.collapse_upconv_weight(_oihw(w), None if b is None else torch.from_numpy(b), r)
    np.testing.assert_allclose(_hwio(wt), np.asarray(wj), rtol=0, atol=1e-6)
    if bias:
        np.testing.assert_array_equal(bt.numpy(), np.asarray(bj))
    else:
        assert bt is None and bj is None


@pytest.mark.parametrize("r", [2, 3, 4])
def test_collapse_matches_jax_bf16_bit_equal(r):
    w = jnp.asarray(np.random.default_rng(50 + r).standard_normal((3, 3, 8, 5)), jnp.bfloat16)
    wj, _ = JC.collapse_upconv_weight(w, None, r)
    wt, _ = C.collapse_upconv_weight(_oihw(np.asarray(w, np.float32)).bfloat16(), None, r)
    assert wt.dtype == torch.bfloat16
    np.testing.assert_array_equal(_hwio(wt), np.asarray(wj, np.float32))


@pytest.mark.parametrize("r", [2, 3])
def test_collapsed_block_equals_nearest_up_and_conv(r):
    """tests/test_upconv_collapse.py's contract on the port."""
    rng = np.random.default_rng(60 + r)
    x = torch.from_numpy(rng.standard_normal((2, 7, 9, 8)).astype(np.float32))
    w = _oihw(rng.standard_normal((3, 3, 8, 5)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal(5).astype(np.float32))
    from innfer_tpu_torch.nn import resize as R

    ref = F.conv2d(R.upsample_nearest(x, r), w, b, padding=1)
    w2, b2 = C.collapse_upconv_weight(w, b, r)
    out = F.pixel_shuffle(F.conv2d(x, w2, b2, padding=1), r)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("pad", [[(1, 0), (0, 1)], [(0, 1), (1, 0)], [(0, 2), (1, 1)],
                                 [(2, 2), (1, 1)], ((1, 0), (1, 0))])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_asymmetric_conv2d_padding_matches_jax(pad, dtype):
    rng = np.random.default_rng(7)
    x = rng.standard_normal((1, 7, 9, 4)).astype(np.float32)
    w = rng.standard_normal((3, 3, 4, 6)).astype(np.float32) * 0.3
    b = rng.standard_normal(6).astype(np.float32)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    ref = np.asarray(JF.conv2d(jnp.asarray(x, jdt), jnp.asarray(w, jdt), jnp.asarray(b),
                               padding=list(pad)), np.float32)
    tdt = getattr(torch, dtype)
    out = F.conv2d(torch.from_numpy(x).to(tdt), _oihw(w).to(tdt), torch.from_numpy(b),
                   padding=pad)
    assert out.dtype == tdt and tuple(out.shape) == ref.shape
    if dtype == "float32":
        np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-5)
    else:  # the same rounding point: all but a rare conv-order flip equal
        assert np.mean(out.float().numpy() == ref) >= 0.99


# ---------------------------------------------------------------------------
# Each tail form against the plain tail, as tests/test_phase.py does
# ---------------------------------------------------------------------------

def _model(family, scale, dtype=torch.float32, **kw):
    make = {"esrgan": SP.esrgan_state, "srresnet": SP.srresnet_state, "ppon": SP.ppon_state}
    spec = {"esrgan": "esrgan", "srresnet": "srgan", "ppon": "ppon"}[family]
    state = make[family](scale=scale, seed=0, **kw)
    cfg = jax_config(dict({"type": spec}, **kw), scale)
    return load_model_from_state(state, cfg, param_dtype=dtype, device="cpu")


def _forms(monkeypatch, family, scale, dtype=torch.float32, forms=FORMS, **kw):
    model, params = _model(family, scale, dtype, **kw)
    x = torch.from_numpy(np.random.default_rng(3).random((1, 24, 20, 3), np.float32)).to(dtype)
    pick = (lambda o: o) if model.output_index is None else (lambda o: o[model.output_index])
    outs = {}
    for form in forms:
        with monkeypatch.context() as m:
            force(m, form)
            with torch.no_grad():
                outs[form] = pick(model.apply(params, x)).float().numpy()
    return outs


@pytest.mark.parametrize("case", [("esrgan", 2), ("esrgan", 4), ("esrgan", 8),
                                  ("srresnet", 4), ("ppon", 4)])
def test_each_tail_form_matches_the_plain_tail_fp32(monkeypatch, case):
    family, scale = case
    kw = dict(nb=1, nf=16)
    outs = _forms(monkeypatch, family, scale, **kw)
    for form in FORMS[1:]:
        assert outs[form].shape == outs["a"].shape
        assert psnr(outs[form], outs["a"]) >= 110, form


@pytest.mark.parametrize("case", [("esrgan", 4), ("srresnet", 4), ("ppon", 4)])
def test_each_tail_form_matches_the_plain_tail_bf16(monkeypatch, case):
    family, scale = case
    outs = _forms(monkeypatch, family, scale, torch.bfloat16, nb=1, nf=16)
    for form in FORMS[1:]:
        assert psnr(outs[form], outs["a"]) >= 35, form


@pytest.mark.parametrize("case", [("esrgan", 4, "c"), ("esrgan", 2, "c"), ("srresnet", 4, "c"),
                                  ("ppon", 4, "c"), ("esrgan", 3, "b")])
def test_default_predicates_run_the_adopted_form(monkeypatch, case):
    """The H100 A/B adopted collapsed upconv blocks and the phase tail
    (form c) wherever they are eligible, PPON's three branches included:
    scale 3 only collapses (form b)."""
    family, scale, adopted = case
    model, params = _model(family, scale, nb=1, nf=16)
    x = torch.from_numpy(np.random.default_rng(4).random((1, 16, 20, 3), np.float32))
    pick = (lambda o: o) if model.output_index is None else (lambda o: o[model.output_index])
    outs = {}
    for form in ("default", adopted, "a"):
        with monkeypatch.context() as m, torch.no_grad():
            if form != "default":
                force(m, form)
            outs[form] = pick(model.apply(params, x))
    assert torch.equal(outs["default"], outs[adopted])
    assert not torch.equal(outs["default"], outs["a"])


def test_scale3_is_bit_equal_to_the_materialized_path(monkeypatch):
    """Factor 3 never takes the phase tail: the default predicates and a
    forced materialized tail give the same bits."""
    model, params = _model("esrgan", 3, nb=1, nf=16)
    x = torch.from_numpy(np.random.default_rng(3).random((1, 24, 20, 3), np.float32))
    with torch.no_grad():
        out = model.apply(params, x)
        with monkeypatch.context() as m:
            m.setattr(C, "phase_tail_ok", lambda *a, **k: False)
            ref = model.apply(params, x)
    assert torch.equal(out, ref)


@pytest.mark.parametrize("name", ["esrgan_prelu_x2", "esrgan_swish_x2"])
def test_phase_tail_skips_parameterised_acts(monkeypatch, name):
    """prelu and swish carry per-channel parameters: the phase tail is not
    eligible, so the forced (c) form runs the materialized tail after the
    collapsed blocks, bit-equal to (b)."""
    fx = np.load(os.path.join(GOLDENS, f"{name}.npz"))
    model, params = load_model_from_state(
        load_checkpoint(os.path.join(GOLDENS, f"{name}.pth")),
        dict(json.loads(str(fx["meta"]))["cfg"]), device="cpu")
    x = torch.from_numpy(np.ascontiguousarray(np.transpose(fx["input"], (0, 2, 3, 1))))
    outs = {}
    for form in ("b", "c"):
        with monkeypatch.context() as m, torch.no_grad():
            force(m, form)
            outs[form] = model.apply(params, x)
    assert torch.equal(outs["b"], outs["c"])


# ---------------------------------------------------------------------------
# The port's model in the JAX package's form against the JAX model
# ---------------------------------------------------------------------------

def _pair(family, scale, **kw):
    spec = {"esrgan": "esrgan", "srresnet": "srgan"}[family]
    make = {"esrgan": SP.esrgan_state, "srresnet": SP.srresnet_state}[family]
    cfg = jax_config(dict({"type": spec}, **kw), scale)
    jm, jp = jax_load_from_state(make(scale=scale, seed=5, **kw), cfg)
    tm = get_network(cfg)
    return jm, jp, tm, params_from_jax({k: np.asarray(v) for k, v in jp.items()}, tm)


@pytest.mark.parametrize("case", [("esrgan", 2), ("esrgan", 4), ("srresnet", 4)])
def test_jax_form_matches_jax_model_fp32(monkeypatch, case):
    force(monkeypatch, "c")
    jm, jp, tm, tp = _pair(*case, nb=1, nf=16)
    x = np.random.default_rng(8).random((1, 20, 28, 3), np.float32)
    ref = np.asarray(jm.apply(jp, jnp.asarray(x)))
    with torch.no_grad():
        out = tm.apply(tp, torch.from_numpy(x)).numpy()
    assert psnr(out, ref) >= 80


@pytest.mark.parametrize("tile", [(32, 32), 256])
def test_jax_form_hybrid_runner_matches_jax_runner(monkeypatch, tile):
    force(monkeypatch, "c")
    jm, jp, tm, tp = _pair("esrgan", 4, nb=1, nf=16)
    x = np.random.default_rng(9).random((1, 40, 52, 3), np.float32)
    kw = dict(mode="hybrid", tile=tile, overlap=8, tile_batch=4, tail_halo=tm.tail_halo)
    ref = np.asarray(JE.TiledRunner(jm.apply, 4, trunk_fn=jm.apply_trunk,
                                    tail_fn=jm.apply_tail, **kw)(jp, jnp.asarray(x)))
    runner = TE.TiledRunner(tm.apply, 4, trunk_fn=tm.apply_trunk, tail_fn=tm.apply_tail, **kw)
    with torch.no_grad():
        out = runner(tp, torch.from_numpy(x)).numpy()
    assert out.shape == ref.shape == (1, 160, 208, 3)
    assert psnr(out, ref) >= 80


# ---------------------------------------------------------------------------
# The goldens of the tail's families through every form
# ---------------------------------------------------------------------------

TAIL_GOLDENS = {
    **{n: ("output", 80) for n in (
        "esrgan_x1", "esrgan_x2", "esrgan_x3", "esrgan_x4", "esrgan_x4_legacy",
        "esrgan_x4_swa", "esrgan_plus_x2", "esrgan_nr2_x2", "esrganlite_x4", "mesrgan_x4",
        "esrgan_bn_x2", "esrgan_in_x2", "esrgan_nac_bn_x2", "esrgan_prelu_x2",
        "esrgan_swish_x2", "srresnet_x2", "srresnet_x3", "srresnet_x4",
        "srresnet_bn_x2", "srresnet_nac_bn_x2", "srresnet_cnac_bn_x2")},
    "chop_esrgan_x2": ("whole", 80), "esrgan_x4_fp16": ("output", 60),
    "ppon_x4": ("output_2", 55)}


@pytest.mark.parametrize("name", sorted(TAIL_GOLDENS))
def test_goldens_hold_in_every_tail_form(monkeypatch, name):
    key, min_db = TAIL_GOLDENS[name]
    fx = np.load(os.path.join(GOLDENS, f"{name}.npz"))
    meta = json.loads(str(fx["meta"]))
    state = swa_to_normal(load_checkpoint(os.path.join(GOLDENS, f"{name}.pth")))
    model, params = load_model_from_state(state, dict(meta["cfg"]), device="cpu")
    x = torch.from_numpy(np.ascontiguousarray(np.transpose(fx["input"], (0, 2, 3, 1))))
    pick = (lambda o: o) if model.output_index is None else (lambda o: o[model.output_index])
    for form in ("default",) + FORMS:
        with monkeypatch.context() as m, torch.no_grad():
            if form != "default":
                force(m, form)
            out = pick(model.apply(params, x)).permute(0, 3, 1, 2).numpy()
        assert psnr(out, fx[key]) >= min_db, form


# ---------------------------------------------------------------------------
# Derived weights are cached per ParamDict and dtype
# ---------------------------------------------------------------------------

def test_derived_weights_are_built_once_per_dict_and_dtype(monkeypatch):
    force(monkeypatch, "c")
    calls = []
    collapse, kernels = C.collapse_upconv_weight, PH.phase_kernels
    monkeypatch.setattr(C, "collapse_upconv_weight",
                        lambda *a, **k: calls.append("collapse") or collapse(*a, **k))
    monkeypatch.setattr(PH, "phase_kernels",
                        lambda *a, **k: calls.append("phase") or kernels(*a, **k))
    model, params = _model("esrgan", 4, nb=1, nf=16)
    x = torch.rand(1, 12, 10, 3, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        first = model.apply(params, x)
        # up1 collapsed, up2 collapsed into the phase tail, HR conv and conv_last
        assert sorted(calls) == ["collapse", "collapse", "phase", "phase"]
        assert torch.equal(model.apply(params, x), first)
        assert len(calls) == 4  # cached: the second forward derives nothing
        cast = cast_params(params, torch.bfloat16)
        model.apply(cast, x.bfloat16())
        assert len(calls) == 8  # the cast is a new dict with its own cache
        assert {k[2] for k in cast.cache} == {torch.bfloat16}
        assert {k[2] for k in params.cache} == {torch.float32}
        model.apply(dict(params), x)  # a plain dict caches nothing
        assert len(calls) == 12
