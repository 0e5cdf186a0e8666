"""The port's device mesh, halo exchange and spatial forward against the JAX
package's (innfer_tpu/parallel/), with the engine's, session's and CLI's
mesh rules.

JAX runs on the 8 virtual CPU devices of tests/conftest.py; the port runs
on meshes of one CPU device repeated (``make_mesh(..., devices=[cpu] * k)``),
which takes every per-device slice and halo copy of the real path.
Everything is fp32.  Tolerances: ``halo_conv2d`` atol 2e-5 (the JAX bar,
tests/test_tiling.py:237-248); the spatial forwards >= 80 dB against the
JAX package's spatial forward and against the port's whole-image forward
with the plain tail forced (``models/common.upconv_collapse_ok`` and
``phase_tail_ok`` patched to False, the form the spatial path computes);
dp tiles and tp against one device atol 1e-5 on the ``chop_esrgan_x2``
golden (tests/test_tiling.py:205, :223); u8 outputs within one level.
"""
import json
import os
import os.path as osp
import re

import cv2
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh as JaxMesh

from innfer_tpu.checkpoint.torch_pickle import load_checkpoint as jax_load
from innfer_tpu.cli import resolve_batch as jax_resolve_batch
from innfer_tpu.config.defaults import get_network_config as jax_config
from innfer_tpu.loader import load_model_from_state as jax_load_from_state
from innfer_tpu.nn import functional as JF
from innfer_tpu.parallel import spatial as JS
from innfer_tpu.parallel import spatial_model as JSM
from innfer_tpu.pipeline import select_presets as jax_presets
from innfer_tpu_torch import cli
from innfer_tpu_torch.checkpoint.detect import load_checkpoint
from innfer_tpu_torch.loader import load_model_from_state
from innfer_tpu_torch.models import common as C
from innfer_tpu_torch.models import get_network, params_from_jax
from innfer_tpu_torch.nn import functional as F
from innfer_tpu_torch.parallel import mesh as M
from innfer_tpu_torch.parallel import spatial as S
from innfer_tpu_torch.parallel import spatial_model as SM
from innfer_tpu_torch.pipeline import InferenceSession, select_presets
from innfer_tpu_torch.tiling import engine as TE
from tools import synth_params as SP

GOLDENS = osp.join(osp.dirname(__file__), "goldens")
CPU = torch.device("cpu")


def psnr(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    mse = np.mean((a - b) ** 2)
    return np.inf if mse == 0 else 10 * np.log10(max(1.0, np.abs(b).max()) ** 2 / mse)


def cpu_mesh(n_data, n_model=1):
    return M.make_mesh(n_data, n_model, devices=[CPU] * (n_data * n_model))


def jax_mesh(n):
    return JaxMesh(np.array(jax.devices()[:n]).reshape(n, 1), ("data", "model"))


def _pair(state, spec, scale):
    """The JAX package's and the port's model of one state dict."""
    cfg = jax_config(spec, scale)
    jm, jp = jax_load_from_state(state, cfg)
    tm = get_network(cfg)
    return jm, jp, tm, params_from_jax({k: np.asarray(v) for k, v in jp.items()}, tm)


def _plain_tail(monkeypatch):
    monkeypatch.setattr(C, "upconv_collapse_ok", lambda *a, **k: False)
    monkeypatch.setattr(C, "phase_tail_ok", lambda *a, **k: False)


def _pixelshuffle_plus_state():
    """An ESRGAN+ 2x state dict with a pixelshuffle upsample block:
    [conv@2, shuffle@3, act@4], so the upconv's model.3 becomes a
    (4 nf, nf) conv at model.2."""
    state = SP.esrgan_state(nb=1, nf=16, gc=8, scale=2, plus=True, seed=3)
    rng = np.random.default_rng(9)
    del state["model.3.weight"], state["model.3.bias"]
    state["model.2.weight"] = (rng.standard_normal((64, 16, 3, 3)) / 12).astype(np.float32)
    state["model.2.bias"] = (rng.standard_normal(64) * 0.01).astype(np.float32)
    return state


SPATIAL_CASES = {
    "esrgan_x4": (lambda: SP.esrgan_state(nb=2, nf=16, gc=8, scale=4, seed=1),
                  {"type": "esrgan", "nb": 2, "nf": 16, "gc": 8}, 4, (1, 64, 24, 3)),
    "esrgan_plus_pixelshuffle_x2": (_pixelshuffle_plus_state,
                                    {"type": "esrgan", "nb": 1, "nf": 16, "gc": 8, "plus": True,
                                     "upsample_mode": "pixelshuffle"}, 2, (1, 64, 40, 3)),
    "srresnet_x4": (lambda: SP.srresnet_state(nb=3, nf=16, scale=4, seed=2),
                    {"type": "srgan", "nb": 3, "nf": 16}, 4, (1, 64, 40, 3)),
}


# ---------------------------------------------------------------------------
# halo_conv2d
# ---------------------------------------------------------------------------

def test_halo_conv_matches_jax_and_unsharded():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 64, 24, 8), dtype=np.float32)
    w = rng.standard_normal((3, 3, 8, 16), dtype=np.float32)   # HWIO
    b = rng.standard_normal(16, dtype=np.float32)
    ref = np.asarray(jax.jit(lambda t: JS.halo_conv2d(t, jnp.asarray(w), jnp.asarray(b),
                                                      mesh=jax_mesh(8), padding=1))(x))
    wt = torch.from_numpy(w).permute(3, 2, 0, 1).contiguous()
    out = S.halo_conv2d(torch.from_numpy(x), wt, torch.from_numpy(b), mesh=cpu_mesh(8))
    np.testing.assert_allclose(out.numpy(), ref, atol=2e-5, rtol=2e-5)
    plain = F.conv2d(torch.from_numpy(x), wt, torch.from_numpy(b), padding=1)
    np.testing.assert_allclose(out.numpy(), plain.numpy(), atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(ref, np.asarray(JF.conv2d(jnp.asarray(x), jnp.asarray(w),
                                                         jnp.asarray(b), padding=1)),
                               atol=2e-5, rtol=2e-5)


def test_halo_conv_padding_two_and_refusals():
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((1, 24, 10, 4), dtype=np.float32))
    w = torch.from_numpy(rng.standard_normal((6, 4, 5, 5), dtype=np.float32))
    out = S.halo_conv2d(x, w, mesh=cpu_mesh(4), padding=2)
    np.testing.assert_allclose(out.numpy(), F.conv2d(x, w, padding=2).numpy(), atol=2e-5)
    with pytest.raises(ValueError, match="only meaningful for padded convs"):
        S.halo_conv2d(x, w, mesh=cpu_mesh(4), padding=0)
    with pytest.raises(ValueError, match="must be divisible by the data-axis size 5"):
        S.halo_conv2d(x, w, mesh=cpu_mesh(5), padding=2)


def test_exchange_halo_edges_get_zeros():
    shards = [torch.full((1, 2, 3, 1), float(i + 1)) for i in range(3)]
    out = S._exchange_halo(shards, 1)
    assert [tuple(o[0, :, 0, 0].tolist()) for o in out] == [
        (0.0, 1.0, 1.0, 2.0), (1.0, 2.0, 2.0, 3.0), (2.0, 3.0, 3.0, 0.0)]


# ---------------------------------------------------------------------------
# The spatial forward
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", list(SPATIAL_CASES))
def test_spatial_forward_matches_jax_and_plain_tail(monkeypatch, case):
    make_state, spec, scale, shape = SPATIAL_CASES[case]
    jm, jp, tm, tp = _pair(make_state(), spec, scale)
    assert SM.spatial_supported(tm.cfg) and JSM.spatial_supported(jm.cfg)
    x = np.random.default_rng(4).random(shape, np.float32)
    ref = np.asarray(jax.jit(JSM.build_spatial_apply(jm.cfg, jax_mesh(8)))(jp, jnp.asarray(x)))
    with torch.no_grad():
        out = SM.build_spatial_apply(tm.cfg, cpu_mesh(8))(tp, torch.from_numpy(x)).numpy()
        _plain_tail(monkeypatch)
        whole = tm.apply(tp, torch.from_numpy(x)).numpy()
    assert out.shape == ref.shape == whole.shape == (1, shape[1] * scale, shape[2] * scale, 3)
    assert psnr(out, ref) >= 80, case
    assert psnr(out, whole) >= 80, case


def test_spatial_forward_takes_each_devices_params():
    """A MeshParams input: every slab reads its own device's ParamDict."""
    make_state, spec, scale, shape = SPATIAL_CASES["srresnet_x4"]
    _jm, _jp, tm, tp = _pair(make_state(), spec, scale)
    mesh = cpu_mesh(4)
    mp = M.replicate_params(tp, mesh)
    assert list(mp) == [CPU] and M.params_on(mp, CPU) is not tp
    x = torch.from_numpy(np.random.default_rng(5).random(shape, np.float32))
    with torch.no_grad():
        a = SM.build_spatial_apply(tm.cfg, mesh)(mp, x)
        b = SM.build_spatial_apply(tm.cfg, mesh)(tp, x)
    assert torch.equal(a, b)


@pytest.mark.parametrize("family", ["esrgan", "srresnet"])
def test_pad_and_crop_wrapper(monkeypatch, family):
    make_state, spec, scale = ((lambda: SP.esrgan_state(nb=1, nf=16, gc=8, scale=2, seed=6),
                                {"type": "esrgan", "nb": 1, "nf": 16, "gc": 8}, 2)
                               if family == "esrgan" else
                               (lambda: SP.srresnet_state(nb=2, nf=16, scale=2, seed=6),
                                {"type": "srgan", "nb": 2, "nf": 16}, 2))
    jm, jp, tm, tp = _pair(make_state(), spec, scale)
    x = np.random.default_rng(7).random((1, 100, 32, 3), np.float32)
    ref = np.asarray(JSM.spatial_run(jm, jp, jnp.asarray(x), jax_mesh(8)))
    with torch.no_grad():
        out = SM.spatial_run(tm, tp, torch.from_numpy(x), cpu_mesh(8)).numpy()
        _plain_tail(monkeypatch)
        whole = tm.apply(tp, torch.from_numpy(x)).numpy()
    assert out.shape == ref.shape == (1, 200, 64, 3)
    assert psnr(out, ref) >= 80
    # rows far from the padded bottom edge match the whole forward
    assert psnr(out[:, :160], whole[:, :160]) >= 80


def test_rejection_texts_equal_jax():
    cfgs = [{"type": "pan_net"}, {"type": "rrdb_net", "nb": 1, "norm_type": "batch"},
            {"type": "sr_resnet", "nb": 1, "norm_type": "instance", "act_type": "prelu"}]
    for cfg in cfgs:
        assert SM.spatial_rejection_reason(cfg) == JSM.spatial_rejection_reason(cfg)
    reason = SM.spatial_rejection_reason({"type": "pan_net"})
    assert "FSA" in reason and "quadratic" in reason and "align_corners" in reason


@pytest.mark.parametrize("cfg", [
    {"type": "rrdb_net", "nb": 1}, {"type": "mrrdb_net", "nb": 1}, {"type": "sr_resnet", "nb": 1},
    {"type": "pan_net", "nb": 1}, {"type": "ppon", "nb": 1},
    {"type": "rrdb_net", "nb": 1, "norm_type": "batch"},
    {"type": "rrdb_net", "nb": 1, "norm_type": "none", "mode": "NAC"},
    {"type": "rrdb_net", "nb": 1, "act_type": "prelu"},
    {"type": "rrdb_net", "nb": 1, "finalact": "swish"},
    {"type": "rrdb_net", "nb": 1, "finalact": "tanh"},
    {"type": "rrdb_net", "nb": 1, "convtype": "Conv3D"},
])
def test_spatial_supported_equals_jax(cfg):
    assert SM.spatial_supported(cfg) == JSM.spatial_supported(cfg)
    if not SM.spatial_supported(cfg):
        with pytest.raises(NotImplementedError, match="spatial|pan_net"):
            SM.build_spatial_apply(cfg, cpu_mesh(2))


def test_indivisible_height_raises():
    make_state, spec, scale, _ = SPATIAL_CASES["srresnet_x4"]
    _jm, _jp, tm, tp = _pair(make_state(), spec, scale)
    apply = SM.build_spatial_apply(tm.cfg, cpu_mesh(8))
    with pytest.raises(ValueError, match="H=100 must be divisible by the data-axis size 8"):
        apply(tp, torch.zeros(1, 100, 32, 3))


# ---------------------------------------------------------------------------
# make_mesh and the parameter placements
# ---------------------------------------------------------------------------

def test_make_mesh_shapes_and_refusal():
    mesh = M.make_mesh(None, 2, devices=[CPU] * 8)
    assert mesh.shape == {"data": 4, "model": 2}
    assert mesh.axis_devices("data") == [CPU] * 4 and mesh.axis_devices("model") == [CPU] * 2
    assert M.make_mesh(3, devices=[CPU] * 8).shape == {"data": 3, "model": 1}
    with pytest.raises(ValueError, match=r"mesh needs data\*model = 2\*1 = 2 devices, but only "
                                         r"1 are available \(platform cpu\).*devices="):
        M.make_mesh(2, devices=M.local_devices("cpu"))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            M.make_mesh()


def _chop_golden():
    fx = np.load(osp.join(GOLDENS, "chop_esrgan_x2.npz"))
    meta = json.loads(str(fx["meta"]))
    path = osp.join(GOLDENS, "chop_esrgan_x2.pth")
    model, params = load_model_from_state(load_checkpoint(path), dict(meta["cfg"]), device="cpu")
    return model, params, torch.from_numpy(np.transpose(fx["input"], (0, 2, 3, 1)))


def test_tp_shard_rule_equals_jax():
    """The sharded set is the JAX rule's: 4-D weights on O, 1-D params, when
    they divide by the model-axis size; a transposed conv's O is its dim 1."""
    model, params, _x = _chop_golden()
    tp = M.params_on(M.tp_shard_params(params, cpu_mesh(4, 2)), CPU)
    for k, v in params.items():
        sharded = hasattr(tp[k], "tp_shards")
        out = v.shape[0] if v.dim() in (1, 4) else None
        assert sharded == (out is not None and out % 2 == 0), k
        if sharded:
            assert [s.shape[0] for s in tp[k].tp_shards] == [out // 2] * 2
        assert not hasattr(v, "tp_shards")  # the source params stay as they were
    w = torch.zeros(8, 6, 4, 4)  # ConvTranspose2d (I, O, kh, kw)
    sh = M.tp_shard_params({"up.weight": w}, cpu_mesh(1, 3), transposed=(r"up\.weight",))
    assert [tuple(s.shape) for s in M.params_on(sh, CPU)["up.weight"].tp_shards] == [(8, 2, 4, 4)] * 3


def test_tp_matches_replicated_on_golden():
    """(4 x 2) tensor parallelism against replicated params, atol 1e-5, the
    JAX bar; the sharded convs really run one shard at a time."""
    model, params, x = _chop_golden()
    tp = M.tp_shard_params(params, cpu_mesh(4, 2))
    calls = []
    real = F._conv

    def spy(fn, t, w, *a, **k):
        calls.append(w.shape[0])
        return real(fn, t, w, *a, **k)

    with torch.no_grad():
        ref = model.apply(params, x)
        F._conv = spy
        try:
            out = model.apply(M.params_on(tp, CPU), x)
        finally:
            F._conv = real
    np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=1e-5, rtol=1e-5)
    assert 4 in calls and 16 in calls  # conv0's 8 outputs in 2 shards; gc=32 in 2


def test_tp_transposed_conv_matches_replicated():
    """The pix2pix UNet's deconvs shard their IOHW dim 1."""
    p = select_presets("unet_128")
    sess = InferenceSession(osp.join(GOLDENS, "unet128.pth"), arch="unet_128", presets=p,
                            compute_dtype=torch.float32, device="cpu")
    st = sess.stages[0]
    tp = M.tp_shard_params(st.params, cpu_mesh(1, 2), transposed=st.model.transposed_keys)
    deconvs = [k for k in st.params if st.params[k].dim() == 4
               and any(re.fullmatch(q, k) for q in st.model.transposed_keys)]
    # the outermost deconv's 3 outputs do not divide by 2 and replicate
    assert len(deconvs) == 7
    assert [hasattr(M.params_on(tp, CPU)[k], "tp_shards") for k in deconvs] == [
        st.params[k].shape[1] % 2 == 0 for k in deconvs]
    assert sum(hasattr(M.params_on(tp, CPU)[k], "tp_shards") for k in deconvs) == 6
    x = torch.from_numpy(np.random.default_rng(8).random((1, 128, 128, 3), np.float32) * 2 - 1)
    with torch.no_grad():
        ref = st.model.apply(st.params, x)
        out = st.model.apply(M.params_on(tp, CPU), x)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=1e-5, rtol=1e-5)


# ---------------------------------------------------------------------------
# The engine on a mesh
# ---------------------------------------------------------------------------

def test_dp_tiles_match_single_device_on_golden():
    model, params, x = _chop_golden()
    single = TE.TiledRunner(model.apply, model.scale, mode="uniform", tile=16, overlap=8,
                            tile_batch=8)
    mesh = cpu_mesh(8)
    sizes = []

    def apply(p, t):
        sizes.append(t.shape[0])
        return model.apply(p, t)

    sharded = TE.TiledRunner(apply, model.scale, mode="uniform", tile=16, overlap=8,
                             tile_batch=8, mesh=mesh)
    with torch.no_grad():
        out_single = single(params, x)
        out_sharded = sharded(M.replicate_params(params, mesh), x)
    np.testing.assert_allclose(out_sharded.numpy(), out_single.numpy(), atol=1e-5, rtol=1e-5)
    n = single.plan_for(24, 40).n_tiles
    # groups of 8 tiles, one per device; the last group at its natural size
    assert sum(sizes) == n and set(sizes) == {1}


def test_dp_tile_stack_matches_per_image():
    """Cross-image tile stacking on a mesh: a stack's groups of tile_batch
    tiles, split over the data devices, give each image its own output."""
    model, params, x = _chop_golden()
    mesh = cpu_mesh(3)
    runner = TE.TiledRunner(model.apply, model.scale, mode="uniform", tile=16, overlap=8,
                            tile_batch=6, mesh=mesh)
    mp = M.replicate_params(params, mesh)
    with torch.no_grad():
        stack = runner(mp, torch.cat([x, x.flip(2)]))
        solo = runner(mp, x.flip(2))
    np.testing.assert_allclose(stack[1:].numpy(), solo.numpy(), atol=1e-5, rtol=1e-5)


def test_dp_last_group_slices_as_even_as_its_tiles_allow():
    seen = []

    def fn(p, t):
        seen.append((t.shape[0], p))
        return t

    tiles = torch.arange(11.0).reshape(11, 1, 1, 1)
    mp = M.MeshParams({CPU: "params-on-cpu"})
    out = TE._run_groups(fn, mp, tiles, 8, mesh=cpu_mesh(4))
    assert torch.equal(out, tiles)
    assert [s for s, _ in seen] == [2, 2, 2, 2, 1, 1, 1] and {p for _, p in seen} == {"params-on-cpu"}


def test_tp_and_dp_runner_matches_jax_on_golden():
    """A (4 x 2) mesh through the tiled runner against the JAX package's
    sharded runner on its (4 x 2) virtual mesh."""
    from innfer_tpu.parallel.mesh import make_mesh as jax_make_mesh
    from innfer_tpu.parallel.mesh import tp_shard_params as jax_tp
    from innfer_tpu.tiling.engine import TiledRunner as JaxRunner

    model, params, x = _chop_golden()
    meta = json.loads(str(np.load(osp.join(GOLDENS, "chop_esrgan_x2.npz"))["meta"]))
    jm, jp = jax_load_from_state(jax_load(osp.join(GOLDENS, "chop_esrgan_x2.pth")),
                                 dict(meta["cfg"]))
    jmesh = jax_make_mesh(n_data=4, n_model=2)
    ref = np.asarray(JaxRunner(jm.apply, jm.scale, mode="uniform", tile=16, overlap=8,
                               tile_batch=4, mesh=jmesh)(jax_tp(jp, jmesh), jnp.asarray(x.numpy())))
    mesh = cpu_mesh(4, 2)
    runner = TE.TiledRunner(model.apply, model.scale, mode="uniform", tile=16, overlap=8,
                            tile_batch=4, mesh=mesh)
    with torch.no_grad():
        out = runner(M.tp_shard_params(params, mesh), x).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=1e-5)


def test_hybrid_refused_and_auto_stays_on_tiles_on_a_mesh():
    model = get_network(jax_config({"type": "esrgan", "nb": 1, "nf": 16, "gc": 8}, 4))
    kw = dict(trunk_fn=model.apply_trunk, tail_fn=model.apply_tail, trunk_kernel=True)
    with pytest.raises(NotImplementedError, match="hybrid mode is single-chip; use --spatial"):
        TE.TiledRunner(model.apply, 4, mode="hybrid", mesh=cpu_mesh(2), **kw)
    auto = TE.TiledRunner(model.apply, 4, mode="auto", mesh=cpu_mesh(2), **kw)
    assert auto.mode_for(1080, 1920, on_cuda=True) == "auto"
    assert TE.TiledRunner(model.apply, 4, mode="auto", **kw).mode_for(
        1080, 1920, on_cuda=True) == "hybrid"


# ---------------------------------------------------------------------------
# The session
# ---------------------------------------------------------------------------

def _imgs(shapes, seed=0):
    return [np.random.default_rng(seed + i).integers(0, 256, (h, w, 3), dtype=np.uint8)
            for i, (h, w) in enumerate(shapes)]


def _u8_close(a, b):
    assert a.shape == b.shape and a.dtype == b.dtype == np.uint8
    assert np.abs(a.astype(int) - b.astype(int)).max() <= 1


@pytest.mark.parametrize("name,arch,shape", [("esrgan_x2.pth", "infer", (16, 16)),
                                             ("cyclegan6.pth", "resnet_6blocks", (32, 32))])
def test_run_batch_data_mesh_matches_no_mesh(monkeypatch, name, arch, shape):
    def mk(mesh):
        p = select_presets(arch)
        p.chop = False
        return InferenceSession(osp.join(GOLDENS, name), arch=arch, presets=p,
                                compute_dtype=torch.float32, device="cpu", mesh=mesh)

    imgs = _imgs([shape] * 8)
    calls = []
    real = M.data_parallel

    def spy(fn, x, mesh):
        calls.append((x.shape[0], mesh.shape["data"]))
        return real(fn, x, mesh)

    import innfer_tpu_torch.pipeline as P

    monkeypatch.setattr(P, "data_parallel", spy)
    outs_m = mk(cpu_mesh(4)).run_batch(imgs)
    outs_s = mk(None).run_batch(imgs)
    assert calls == [(8, 4)]
    for a, b in zip(outs_m, outs_s):
        _u8_close(a, b)
    # a stack that does not divide by the data axis runs unsplit
    mk(cpu_mesh(3)).run_batch(imgs)
    assert calls == [(8, 4)]


def test_session_places_params_and_rounds_tile_batch():
    path = osp.join(GOLDENS, "esrgan_x2.pth")
    s = InferenceSession(path, compute_dtype=torch.float32, device="cpu", tile_batch=5,
                         mesh=cpu_mesh(4))
    st = s.stages[0]
    assert isinstance(st.params, M.MeshParams) and st.runner.tile_batch == 8
    assert not any(hasattr(v, "tp_shards") for v in M.params_on(st.params, CPU).values())
    s = InferenceSession(path, compute_dtype=torch.float32, device="cpu", mesh=cpu_mesh(2, 2))
    assert any(hasattr(v, "tp_shards") for v in M.params_on(s.stages[0].params, CPU).values())
    img = _imgs([(20, 28)])[0]
    single = InferenceSession(path, compute_dtype=torch.float32, device="cpu")
    _u8_close(s.run_image(img), single.run_image(img))


def test_session_spatial_matches_whole_image():
    path = osp.join(GOLDENS, "esrgan_x2.pth")
    p = select_presets("infer")
    p.chop = False
    whole = InferenceSession(path, presets=p, compute_dtype=torch.float32, device="cpu")
    sp = InferenceSession(path, compute_dtype=torch.float32, device="cpu", mesh=cpu_mesh(8),
                          spatial=True)
    assert isinstance(sp.stages[0].runner, SM.SpatialRunner)
    img = _imgs([(24, 20)])[0]
    _u8_close(sp.run_image(img), whole.run_image(img))


def test_session_refusals(tmp_path):
    path = osp.join(GOLDENS, "esrgan_x2.pth")
    kw = dict(compute_dtype=torch.float32, device="cpu")
    with pytest.raises(NotImplementedError, match="--spatial shards the image over the 'data' "
                                                  "axis only.*--tp"):
        InferenceSession(path, mesh=cpu_mesh(2, 2), spatial=True, **kw)
    with pytest.raises(ValueError, match="spatial=True needs a device mesh"):
        InferenceSession(path, spatial=True, **kw)
    with pytest.raises(NotImplementedError, match="hybrid mode is single-chip"):
        InferenceSession(path, mesh=cpu_mesh(2), tile_mode="hybrid", **kw)
    with pytest.raises(NotImplementedError, match="FSA self-attention"):
        InferenceSession(osp.join(GOLDENS, "pan_x4.pth"), mesh=cpu_mesh(8), spatial=True, **kw)
    with pytest.raises(NotImplementedError, match=r"--spatial: spatial sharding supports the "
                                                  r"default RRDB/SRResNet .*\(got ppon"):
        InferenceSession(osp.join(GOLDENS, "ppon_x4.pth"), mesh=cpu_mesh(2), spatial=True, **kw)

    class Up(torch.nn.Module):
        def forward(self, x):
            return torch.nn.functional.interpolate(x, scale_factor=2.0, mode="nearest")

    ts = str(tmp_path / "2x_up.pt")
    torch.jit.trace(Up(), torch.zeros(1, 3, 8, 8)).save(ts)
    with pytest.raises(NotImplementedError, match="--spatial cannot shard a TorchScript"):
        InferenceSession(ts, arch="ts", mesh=cpu_mesh(2), spatial=True, **kw)


# ---------------------------------------------------------------------------
# The CLI
# ---------------------------------------------------------------------------

def _in_dir(tmp_path, shapes):
    d = tmp_path / "in"
    d.mkdir()
    for i, (h, w) in enumerate(shapes):
        cv2.imwrite(str(d / f"i{i}.png"), _imgs([(h, w)], seed=30 + i)[0])
    return d


def _read(d):
    return {n: cv2.imread(str(d / n)) for n in sorted(os.listdir(d))}


def test_cli_dp_tp_and_spatial_match_single(tmp_path, monkeypatch):
    """--dp/--tp build a (data, model) mesh over the local devices (eight
    of the CPU here) and reproduce the single-device output; --spatial
    --dp 8 reproduces the whole-image forward."""
    monkeypatch.setattr(M, "local_devices", lambda platform="cuda": [CPU] * 8)
    inp = _in_dir(tmp_path, [(20, 28)])
    base = ["-m", osp.join(GOLDENS, "esrgan_x2.pth"), "-i", str(inp), "-no_fp16", "-cpu"]
    runs = {"single": ["--tile", "16", "--overlap", "8"],
            "dp_tp": ["--tile", "16", "--overlap", "8", "--dp", "4", "--tp", "2",
                      "--tile-batch", "4"],
            "all": ["--tile", "16", "--overlap", "8", "--dp", "-1", "--tp", "2"],
            "whole": ["--tile-mode", "none"],
            "spatial": ["--spatial", "--dp", "4"]}
    outs = {}
    for name, extra in runs.items():
        assert cli.main(base + ["-o", str(tmp_path / name)] + extra) == 0
        outs[name] = _read(tmp_path / name)["i0.png"]
    assert outs["single"].shape == (40, 56, 3)
    _u8_close(outs["dp_tp"], outs["single"])
    _u8_close(outs["all"], outs["single"])
    _u8_close(outs["spatial"], outs["whole"])


def test_cli_mesh_errors(tmp_path):
    inp = _in_dir(tmp_path, [(16, 16)])
    base = ["-m", osp.join(GOLDENS, "esrgan_x2.pth"), "-i", str(inp), "-o",
            str(tmp_path / "o"), "-cpu"]
    with pytest.raises(SystemExit, match="--spatial requires a device mesh; add --dp N"):
        cli.main(base + ["--spatial"])
    with pytest.raises(SystemExit, match="--spatial requires a device mesh"):
        cli.main(base + ["--spatial", "--dp", "1"])
    with pytest.raises(ValueError, match="mesh needs data\\*model = 2\\*1"):
        cli.main(base + ["--dp", "2"])   # one CPU device
    with pytest.raises(SystemExit, match="--batch and --spatial are incompatible"):
        cli.resolve_batch(2, select_presets("infer"), spatial=True)


@pytest.mark.parametrize("arch", ["infer", "unet_256", "resnet_9blocks", "wbcunet"])
@pytest.mark.parametrize("batch", [0, 1, 3])
@pytest.mark.parametrize("spatial", [False, True])
def test_resolve_batch_equals_jax(arch, batch, spatial):
    if spatial and batch > 1:
        with pytest.raises(SystemExit):
            jax_resolve_batch(batch, jax_presets(arch), spatial=True)
        with pytest.raises(SystemExit):
            cli.resolve_batch(batch, select_presets(arch), spatial=True)
        return
    assert (cli.resolve_batch(batch, select_presets(arch), spatial=spatial)
            == jax_resolve_batch(batch, jax_presets(arch), spatial=spatial))


def test_cli_parser_flags_equal_jax_defaults():
    from innfer_tpu.cli import build_parser as jax_parser

    ours = vars(cli.build_parser().parse_args(["-m", "x"]))
    theirs = vars(jax_parser().parse_args(["-m", "x"]))
    for k in ("dp", "tp", "spatial", "coordinator", "num_processes", "process_id",
              "shard_index", "num_shards"):
        assert ours[k] == theirs[k], k


class _Current:
    """A stand-in for ``torch.cuda.device``: records which device is
    current while a block runs."""

    def __init__(self):
        self.stack = []

    def __call__(self, dev):
        cur = self

        class _Ctx:
            def __enter__(self):
                cur.stack.append(torch.device(dev))

            def __exit__(self, *exc):
                cur.stack.pop()

        return _Ctx()


def test_kernel_launch_makes_the_tensors_card_current(monkeypatch):
    """A kernel launches on the current device: ``_build.launch`` makes the
    tensor's card current around the C call and passes that card's stream,
    and every wrapper launches through it."""
    import inspect

    from innfer_tpu_torch.ops import _build, rdb, resnet_block

    cur = _Current()
    monkeypatch.setattr(torch.cuda, "device", cur)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d: type("S", (), {"cuda_stream": f"stream of {d}"}))
    seen = []

    class Lib:
        def innfer_k(self, *args):
            seen.append((list(cur.stack), args))
            return 0

    _build.launch(Lib(), "innfer_k", "k", torch.device("cuda", 1), 3, 4)
    assert seen == [([torch.device("cuda", 1)], (3, 4, "stream of cuda:1"))] and not cur.stack
    for mod, n in ((rdb, 2), (resnet_block, 1)):
        src = inspect.getsource(mod)
        assert src.count("_build.launch(lib, ") == n and "current_stream" not in src
        assert not re.search(r"lib\.innfer_\w+_forward\w*\(", src)


def test_data_parallel_runs_each_slice_with_its_card_current(monkeypatch):
    cur = _Current()
    monkeypatch.setattr(torch.cuda, "device", cur)
    monkeypatch.setattr(M, "_to", lambda t, dev: t)
    cards = [torch.device("cuda", i) for i in range(3)]
    mesh = M.make_mesh(3, devices=cards)
    mp = M.MeshParams({d: f"params of {d}" for d in cards})
    seen = []

    def fn(p, t):
        seen.append((list(cur.stack), p, t.shape[0]))
        return t

    x = torch.arange(5.0).reshape(5, 1)
    assert torch.equal(M.data_parallel(fn, x, mesh, mp), x)
    assert seen == [([d], f"params of {d}", n) for d, n in zip(cards, (2, 2, 1))]
    assert not cur.stack
    with pytest.raises(KeyError, match="no parameters on cuda:1"):
        M.params_on(M.MeshParams({cards[0]: 0}), cards[1])
