"""The port's tile plans and tiled/hybrid runner against the JAX package's.

Plans and ``hybrid_dims`` must be equal (the hybrid trunk canvas decides
border pixels).  Runner outputs are compared on the CPU in fp32 at
>= 80 dB; both packages' hybrid tails run the phase-space rewrite.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from innfer_tpu.config.defaults import get_network_config as jax_config
from innfer_tpu.loader import load_model_from_state as jax_load_from_state
from innfer_tpu.tiling import engine as JE
from innfer_tpu.tiling import plan as JP
from innfer_tpu_torch.models import get_network, params_from_jax
from innfer_tpu_torch.tiling import engine as TE
from innfer_tpu_torch.tiling import plan as TP
from tools import synth_params as SP


def psnr(a, b):
    mse = np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2)
    return np.inf if mse == 0 else 10 * np.log10(1.0 / mse)


def test_hybrid_dims_equal_jax():
    sizes = [(1080, 1920), (540, 960), (720, 1280), (2160, 3840), (1, 1), (100, 130)]
    sizes += [(h, w) for h in range(7, 700, 61) for w in range(5, 2200, 113)]
    for h, w in sizes:
        assert TE.hybrid_dims(h, w) == JE.hybrid_dims(h, w), (h, w)
    assert TE.hybrid_dims(1080, 1920) == (1088, 1920)


def _plan_fields_equal(a, b):
    for f in ("in_h", "in_w", "pad_h", "pad_w", "tile_h", "tile_w", "scale",
              "starts_h", "starts_w", "chunk"):
        assert getattr(a, f) == getattr(b, f), f
    np.testing.assert_array_equal(a.blend, b.blend)
    np.testing.assert_array_equal(a.inv_weight, b.inv_weight)


@pytest.mark.parametrize("h,w", [(40, 52), (70, 90), (240, 320), (1080, 1920), (33, 200)])
def test_plans_equal_jax(h, w):
    _plan_fields_equal(TP.make_uniform_plan(h, w, 2, tile=32, overlap=8),
                       JP.make_uniform_plan(h, w, 2, tile=32, overlap=8))
    _plan_fields_equal(TP.make_uniform_plan(h, w, 4, tile_h=24, tile_w=40, overlap=8, bucket=16),
                       JP.make_uniform_plan(h, w, 4, tile_h=24, tile_w=40, overlap=8, bucket=16))
    _plan_fields_equal(TP.make_auto_plan(h, w, 4, overlap=16),
                       JP.make_auto_plan(h, w, 4, overlap=16, align=8))
    _plan_fields_equal(TP.make_cover_plan(h, w, 4, tile_h=30, tile_w=48, overlap=8),
                       JP.make_cover_plan(h, w, 4, tile_h=30, tile_w=48, overlap=8))
    if min(h, w) % 2 == 0:
        _plan_fields_equal(TP.make_reference_plan(h, w, 2, patch=24),
                           JP.make_reference_plan(h, w, 2, patch=24))


def _models():
    spec = {"type": "esrgan", "nb": 1, "nf": 16, "gc": 8}
    state = SP.esrgan_state(nb=1, nf=16, gc=8, scale=4, seed=5)
    jm, jp = jax_load_from_state(state, jax_config(spec, 4))
    tm = get_network(jax_config(spec, 4))
    tp = params_from_jax({k: np.asarray(v) for k, v in jp.items()})
    return jm, jp, tm, tp


@pytest.mark.parametrize("mode,tile,overlap", [
    ("uniform", 16, 8),
    ("auto", 256, 16),
    ("hybrid", (48, 48), 16),
    ("hybrid", 256, 16),
])
def test_runner_matches_jax(mode, tile, overlap):
    jm, jp, tm, tp = _models()
    x = np.random.default_rng(6).random((1, 70, 90, 3), np.float32)
    kw = dict(mode=mode, tile=tile, overlap=overlap, tile_batch=4,
              trunk_fn=None, tail_fn=None, tail_halo=tm.tail_halo)
    jr = JE.TiledRunner(jm.apply, 4, **{**kw, "trunk_fn": jm.apply_trunk,
                                        "tail_fn": jm.apply_tail})
    tr = TE.TiledRunner(tm.apply, 4, **{**kw, "trunk_fn": tm.apply_trunk,
                                        "tail_fn": tm.apply_tail})
    ref = np.asarray(jr(jp, jnp.asarray(x)))
    with torch.no_grad():
        out = tr(tp, torch.from_numpy(x)).numpy()
    assert out.shape == ref.shape == (1, 280, 360, 3)
    assert psnr(out, ref) >= 80
    assert tr.last_mode == mode  # a CPU run never upgrades auto


def test_auto_upgrades_to_hybrid_on_cuda_only():
    _jm, _jp, tm, _tp = _models()
    r = TE.TiledRunner(tm.apply, 4, mode="auto", trunk_fn=tm.apply_trunk,
                       tail_fn=tm.apply_tail, tail_halo=tm.tail_halo,
                       trunk_kernel=tm.trunk_kernel)
    assert r.mode_for(1080, 1920, on_cuda=True) == "hybrid"
    assert r.mode_for(1080, 1920, on_cuda=False) == "auto"
    assert r.mode_for(4320, 7680, on_cuda=True) == "auto"  # over the px cap
    plain = TE.TiledRunner(tm.apply, 4, mode="auto")       # no trunk/tail split
    assert plain.mode_for(1080, 1920, on_cuda=True) == "auto"
    # the planner-owned hybrid tail grid is the JAX package's lean grid
    plan = r.plan_for(1080, 1920, on_cuda=True)
    assert (plan.pad_h, plan.pad_w, plan.tile_h, plan.tile_w) == (1088, 1920, 548, 256)
    assert plan.starts_h == (0, 540)


def test_runner_rejects_unported_modes():
    TE.TiledRunner(lambda p, x: x, 2, mode="reference")  # ported with the batched path
    with pytest.raises(ValueError, match="unknown tile mode 'spatial'"):
        TE.TiledRunner(lambda p, x: x, 2, mode="spatial")
    with pytest.raises(ValueError, match="trunk/tail split"):
        TE.TiledRunner(lambda p, x: x, 2, mode="hybrid")


def test_pad_to_matches_jax():
    x = np.random.default_rng(7).random((1, 9, 13, 3), np.float32)
    for ph, pw in ((9, 13), (12, 20), (30, 13), (16, 40)):
        ref = np.asarray(JE._pad_to(jnp.asarray(x), ph, pw))
        out = TE._pad_to(torch.from_numpy(x), ph, pw).numpy()
        np.testing.assert_array_equal(out, ref)
