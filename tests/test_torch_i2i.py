"""The image-to-image slice of the port against the JAX package and the
reference goldens: the pix2pix UNet, WBC, the image filters
(ops/filters.py), the TF-style ops, linear_resize, and the session and CLI
with the pix2pix and WBC presets, chains, -cf, -comp and -norm.

Tolerances:
  * goldens: fp32 >= 80 dB; WBC's guided-filter output >= 70 dB (the JAX
    suite's bar, tests/test_model_parity_zoo.py);
  * port model vs JAX model on identical weights, fp32: max-abs <= 1e-5 of
    the output's peak; bf16: the share of outputs equal to the JAX
    package's, stated at each assertion;
  * filters vs JAX in fp32: max-abs 1e-6 of max(1, peak) (filter2d,
    gaussian_blur3) and 1e-5 (the guided filter, whose cov/var terms
    cancel); color_fix: u8
    within 1 level; tf_same_padding, tf_2x_bilinear and the sRGB
    transforms' u8 cast: bit-equal;
  * linear_resize vs the JAX package's cv2.INTER_CUBIC: u8 within 1 level
    in >= 99% of values;
  * sessions and CLIs, fp32 on the CPU: u8 PNGs within 1 level.
"""
import json
import logging
import os

import cv2
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from innfer_tpu.checkpoint.detect import detect_and_infer as jax_detect
from innfer_tpu.checkpoint.torch_pickle import load_checkpoint as jax_load
from innfer_tpu.cli import main as jax_cli
from innfer_tpu.config.defaults import get_network_config as jax_config
from innfer_tpu.io import images as jio
from innfer_tpu.loader import load_model as jax_load_model
from innfer_tpu.loader import load_model_from_state as jax_load_from_state
from innfer_tpu.models.base import cast_params as jax_cast_params
from innfer_tpu.nn import functional as JFn
from innfer_tpu.nn import resize as JR
from innfer_tpu.ops import colors as JC
from innfer_tpu.ops import filters as JF
from innfer_tpu.pipeline import InferenceSession as JaxSession
from innfer_tpu.pipeline import select_presets as jax_presets
from innfer_tpu_torch import cli as torch_cli
from innfer_tpu_torch import pipeline
from innfer_tpu_torch.checkpoint.detect import detect_and_infer, load_checkpoint
from innfer_tpu_torch.config.defaults import get_network_config
from innfer_tpu_torch.io import images as iio
from innfer_tpu_torch.loader import load_model, load_model_from_state
from innfer_tpu_torch.models import cast_params, get_network, params_from_jax
from innfer_tpu_torch.nn import functional as F
from innfer_tpu_torch.nn import resize as R
from innfer_tpu_torch.ops import colors
from innfer_tpu_torch.ops import filters
from innfer_tpu_torch.pipeline import InferenceSession, select_presets
from tools import synth_params as SP

GOLDENS = os.path.join(os.path.dirname(__file__), "goldens")


def psnr(a, b, peak=None):
    peak = max(1.0, float(np.abs(b).max())) if peak is None else peak
    mse = np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2)
    return np.inf if mse == 0 else 10 * np.log10(peak ** 2 / mse)


def _t(a):
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------------------
# Goldens
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["unet128", "unet256", "wbc_pt", "wbc_tf"])
def test_golden_fp32(name):
    fx = np.load(os.path.join(GOLDENS, f"{name}.npz"))
    meta = json.loads(str(fx["meta"]))
    cfg = dict(meta["cfg"], meval=meta.get("meval", True))
    state = load_checkpoint(os.path.join(GOLDENS, f"{name}.pth"))
    model, params = load_model_from_state(state, cfg, device="cpu")
    x = _t(np.transpose(fx["input"], (0, 2, 3, 1)))
    with torch.no_grad():
        out = model.apply(params, x)
    assert psnr(out.permute(0, 3, 1, 2).numpy(), fx["output"]) >= 80
    if "output_gf" in fx.files:
        gf = filters.guided_filter(x, out, r=1, eps=5e-3)
        assert psnr(gf.permute(0, 3, 1, 2).numpy(), fx["output_gf"]) >= 70


def test_golden_wbc_is_detected_as_jax_detects_it():
    path = os.path.join(GOLDENS, "wbc_pt.pth")
    fam, cfg, _ = detect_and_infer(load_checkpoint(path))
    assert (fam, cfg) == jax_detect(jax_load(path))[:2]
    model, _ = load_model(path, device="cpu")
    assert model.name == "wbcunet_net" and model.cfg["nf"] == 8 and model.scale == 1


# ---------------------------------------------------------------------------
# Port model vs JAX model on identical weights
# ---------------------------------------------------------------------------

_MODELS = {
    "unet_bn_deconv": (lambda: SP.unet_state(num_downs=5, ngf=8, seed=1),
                       {"type": "unet_net", "num_downs": 5, "ngf": 8, "meval": False}, (32, 64)),
    "unet_in": (lambda: SP.unet_state(num_downs=5, ngf=8, norm="instance", seed=2),
                {"type": "unet_net", "num_downs": 5, "ngf": 8, "norm_type": "instance"}, (32, 64)),
    "wbc_pt": (lambda: SP.wbc_state(nf=8, seed=3), {"type": "wbcunet", "nf": 8}, (20, 24)),
    "wbc_tf": (lambda: SP.wbc_state(nf=8, seed=4), {"type": "wbcunet", "nf": 8, "mode": "tf"},
               (20, 24)),
}


def _pair(name):
    make, spec, size = _MODELS[name]
    cfg = jax_config(spec, 1)
    if "meval" in spec:
        cfg["meval"] = spec["meval"]
    jm, jp = jax_load_from_state(make(), cfg)
    tm = get_network(cfg)
    tp = params_from_jax({k: np.asarray(v) for k, v in jp.items()}, tm)
    x = np.random.default_rng(5).uniform(-1, 1, (2, *size, 3)).astype(np.float32)
    return jm, jp, tm, tp, x


@pytest.mark.parametrize("name", list(_MODELS))
def test_matches_jax_model_fp32(name):
    jm, jp, tm, tp, x = _pair(name)
    want = np.asarray(jm.apply(jp, jnp.asarray(x)))
    with torch.no_grad():
        got = tm.apply(tp, _t(x)).numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


# the share of bf16 outputs equal to the JAX package's, measured on these
# seeds: both UNets 100%, WBC pt and tf 99.97% (its convs sum in another
# order, and a flipped rounding propagates through the skips)
@pytest.mark.parametrize("name", list(_MODELS))
def test_bf16_rounds_like_the_jax_package(name):
    jm, jp, tm, tp, x = _pair(name)
    want = np.asarray(jm.apply(jax_cast_params(jp, jnp.bfloat16),
                               jnp.asarray(x, jnp.bfloat16)).astype(jnp.float32))
    with torch.no_grad():
        got = tm.apply(cast_params(tp, torch.bfloat16), _t(x).bfloat16()).float().numpy()
    assert (got == want).mean() >= 0.999


# ---------------------------------------------------------------------------
# Ops vs JAX
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("border", ["reflect", "replicate", "constant"])
@pytest.mark.parametrize("ksize,normalized", [((3, 3), False), ((4, 2), True), ((5, 5), False)])
def test_filter2d_matches_jax(border, ksize, normalized):
    g = np.random.default_rng(6)
    x = g.random((2, 11, 13, 3), np.float32)
    k = g.random(ksize, np.float32)
    want = np.asarray(JF.filter2d(jnp.asarray(x), jnp.asarray(k), border, normalized))
    got = filters.filter2d(_t(x), _t(k), border, normalized).numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-6 * max(1.0, np.abs(want).max())


def test_gaussian_blur3_matches_jax():
    x = np.random.default_rng(7).random((1, 9, 14, 3), np.float32)
    np.testing.assert_allclose(filters.gaussian_blur3(_t(x)).numpy(),
                               np.asarray(JF.gaussian_blur3(jnp.asarray(x))), atol=1e-6, rtol=0)


@pytest.mark.parametrize("mode", ["regular", "fast", "conv"])
def test_guided_filter_matches_jax(mode):
    """The three modes, as tests/test_aux.py drives the JAX package's."""
    g = np.random.default_rng(8)
    x, y = (g.random((1, 8, 8, 3), np.float32) for _ in range(2))
    x_hr = g.random((1, 16, 16, 3), np.float32)
    w = (g.standard_normal((1, 1, 6, 3)) * 0.1).astype(np.float32)  # HWIO
    jkw = dict(r=1, mode=mode)
    tkw = dict(r=1, mode=mode)
    if mode == "conv":
        jkw["conv_a"] = lambda t: JFn.conv2d(t, jnp.asarray(w))
        tkw["conv_a"] = lambda t: F.conv2d(t, _t(np.transpose(w, (3, 2, 0, 1))))
    hr = x_hr if mode != "regular" else None
    want = np.asarray(JF.guided_filter(jnp.asarray(x), jnp.asarray(y),
                                       None if hr is None else jnp.asarray(hr), **jkw))
    got = filters.guided_filter(_t(x), _t(y), None if hr is None else _t(hr), **tkw).numpy()
    assert got.shape == ((1, 16, 16, 3) if hr is not None else (1, 8, 8, 3))
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    if mode != "regular":
        with pytest.raises(ValueError):
            filters.guided_filter(_t(x), _t(y), r=1, mode=mode)


def test_guided_filter_wbc_call_rounds_once_to_y_dtype():
    g = np.random.default_rng(9)
    x = g.uniform(-1, 1, (1, 12, 16, 3)).astype(np.float32)
    y = g.uniform(-1, 1, (1, 12, 16, 3)).astype(np.float32)
    for jdt, tdt in ((jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)):
        want = np.asarray(JF.guided_filter(jnp.asarray(x, jdt), jnp.asarray(y, jdt),
                                           r=1, eps=5e-3).astype(jnp.float32))
        got = filters.guided_filter(_t(x).to(tdt), _t(y).to(tdt), r=1, eps=5e-3)
        assert got.dtype == tdt
        tol = 1e-5 if tdt == torch.float32 else 2 ** -7
        np.testing.assert_allclose(got.float().numpy(), want, atol=tol, rtol=0)
    with pytest.raises(ValueError, match="radius"):
        filters.guided_filter(_t(x), _t(y))


@pytest.mark.parametrize("ref_hw,out_hw", [((10, 14), (40, 56)), ((16, 20), (16, 20))])
def test_color_fix_matches_jax(ref_hw, out_hw):
    """Both branches: bicubic down/up when the output is larger (SR), the
    plain blur otherwise; HWC u8 in, u8 out, within one level."""
    g = np.random.default_rng(10)
    ref = g.integers(0, 256, ref_hw + (3,), dtype=np.uint8)
    out = g.integers(0, 256, out_hw + (3,), dtype=np.uint8)
    want = np.asarray(JF.color_fix(jnp.asarray(ref), jnp.asarray(out)))
    got = filters.color_fix(_t(ref), _t(out)).numpy()
    assert got.dtype == np.uint8 and got.shape == want.shape
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


def test_srgb_transforms_match_jax():
    v = np.arange(256, dtype=np.uint8).reshape(1, 16, 16, 1)
    lin = colors.srgb_to_linear(_t(v))
    np.testing.assert_allclose(lin.numpy(), np.asarray(JC.srgb_to_linear(jnp.asarray(v))),
                               atol=1e-6, rtol=0)
    # the u8 cast truncates: linear 0.5 -> 187.5... -> 187 in both
    lin = np.linspace(-0.1, 1.1, 1000, dtype=np.float32)
    np.testing.assert_array_equal(colors.linear_to_srgb(_t(lin)).numpy(),
                                  np.asarray(JC.linear_to_srgb(jnp.asarray(lin))))
    assert colors.linear_to_srgb(torch.tensor([0.5])).item() == 187


@pytest.mark.parametrize("jdt,tdt", [(jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)])
def test_tf_ops_bit_equal_to_jax(jdt, tdt):
    x = np.random.default_rng(11).standard_normal((2, 5, 7, 4)).astype(np.float32)
    jx, tx = jnp.asarray(x, jdt), _t(x).to(tdt)
    for jfn, tfn in ((JFn.tf_same_padding, F.tf_same_padding),
                     (JR.tf_2x_bilinear, R.tf_2x_bilinear)):
        want = np.asarray(jfn(jx).astype(jnp.float32))
        got = tfn(tx)
        assert got.dtype == tdt
        np.testing.assert_array_equal(got.float().numpy(), want)


# ---------------------------------------------------------------------------
# Host-side images
# ---------------------------------------------------------------------------

# measured on these inputs: every value within one level of the JAX
# package's cv2.INTER_CUBIC result, 99.999-100% of them equal
@pytest.mark.parametrize("shape,st", [((100, 140, 3), 128), ((200, 300, 3), 256),
                                      ((37, 50), 64), ((60, 70, 4), 128)])
def test_linear_resize_matches_jax_cv2(shape, st):
    g = np.random.default_rng(12)
    yy, xx = np.mgrid[0:shape[0], 0:shape[1]]
    smooth = 128 + 100 * np.sin(xx / 9.0) * np.cos(yy / 7.0)
    img = np.clip(smooth.reshape(shape[:2] + (1,) * (len(shape) - 2))
                  + g.normal(0, 12, shape), 0, 255).astype(np.uint8)
    want = jio.linear_resize(img, st)
    got = iio.linear_resize(img, st)
    assert got.shape == want.shape and got.dtype == np.uint8
    assert got.shape[0] % st == 0 and got.shape[1] % st == 0
    d = np.abs(got.astype(int) - want.astype(int))
    assert (d <= 1).mean() >= 0.99
    assert iio.linear_resize(got, st) is got  # already multiples: unchanged


def test_merge_imgs_matches_jax_and_needs_no_cv2(monkeypatch, tmp_path):
    g = np.random.default_rng(13)
    a = g.integers(0, 256, (6, 8, 3), dtype=np.uint8)
    b = g.integers(0, 256, (24, 32, 3), dtype=np.uint8)
    c = g.integers(0, 256, (10, 9, 3), dtype=np.uint8)
    want = jio.merge_imgs([a, b, c])
    monkeypatch.setattr(iio, "cv2", None)
    np.testing.assert_array_equal(iio.merge_imgs([a, b, c]), want)
    assert iio.merge_imgs(b) is b
    iio.save_img_comp([a, b], str(tmp_path / "comp.png"))
    np.testing.assert_array_equal(iio.read_img(str(tmp_path / "comp.png")),
                                  jio.merge_imgs([a, b]))


# ---------------------------------------------------------------------------
# Detection, config and presets
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("spec", ["wbcunet", "wbcunet_tf", "unet_128", "unet_256", "p2p_128",
                                  "p2p_256", {"type": "wbcunet", "mode": "tf", "nf": 16},
                                  {"type": "unet_net", "num_downs": 6, "ngf": 8,
                                   "norm_type": "instance", "upsample_mode": "upconv"}])
def test_i2i_config_defaults_equal_jax(spec):
    assert get_network_config(spec, 1) == jax_config(spec, 1)


def test_explicit_wbc_tf_arch_loads_in_tf_mode(tmp_path):
    path = str(tmp_path / "cartoon.pth")
    torch.save({k: _t(v) for k, v in SP.wbc_state(nf=32, seed=1).items()}, path)
    for arch, mode in (("wbcunet_tf", "tf"), ("wbcunet", "pt")):
        model, _ = load_model(path, arch=arch, device="cpu")
        assert model.cfg == jax_load_model(path, arch=arch)[0].cfg
        assert model.cfg["mode"] == mode


@pytest.mark.parametrize("arch,models_arg,norm", [
    ("infer", "", False), ("unet_512", "", False), ("unet_128", "", False),
    ("p2p_256", "", False), ("resnet_9blocks", "", False),
    ("infer", "wbc_smooth.pth", False), ("infer", "wbc_tf_thing.pth", False),
    ("infer", "wbc_artframe.pth", False), ("infer", "wbc.tf.pth", False),
    ("wbcunet_tf", "", False), ("infer", "4x_model.pth", True)])
def test_select_presets_equal_jax(arch, models_arg, norm):
    """The cases of tests/test_pipeline.py's TestPresets, plus -norm."""
    assert vars(select_presets(arch, models_arg, norm)) == vars(
        jax_presets(arch, models_arg, norm))


# ---------------------------------------------------------------------------
# Session and CLI on the CPU against the JAX package's
# ---------------------------------------------------------------------------

def _save(state, path):
    torch.save({k: _t(v) for k, v in state.items()}, str(path))
    return str(path)


def _images(d, sizes, seed):
    d.mkdir()
    g = np.random.default_rng(seed)
    for name, (h, w) in sizes.items():
        yy, xx = np.mgrid[0:h, 0:w]
        base = (128 + 90 * np.sin(xx / 5.0 + yy / 7.0))[..., None]
        cv2.imwrite(str(d / f"{name}.png"),
                    np.clip(base + g.normal(0, 20, (h, w, 3)), 0, 255).astype(np.uint8))
    return str(d)


def _same_pngs(dir_a, dir_b, names):
    for n in names:
        a = cv2.imread(os.path.join(dir_a, f"{n}.png"), cv2.IMREAD_UNCHANGED)
        b = cv2.imread(os.path.join(dir_b, f"{n}.png"), cv2.IMREAD_UNCHANGED)
        assert a is not None and a.shape == b.shape and a.dtype == np.uint8
        assert np.abs(a.astype(int) - b.astype(int)).max() <= 1


def test_pix2pix_session_matches_jax(tmp_path):
    """unet_128 (ngf 64, seven downs): linear_resize to multiples of 128,
    train-mode BatchNorm, [-1, 1], whole image."""
    ckpt = _save(SP.unet_state(num_downs=7, ngf=64, seed=14), tmp_path / "p2p.pth")
    in_dir = _images(tmp_path / "in", {"a": (100, 140)}, seed=15)
    JaxSession(ckpt, arch="unet_128", compute_dtype=jnp.float32).process(
        in_dir, str(tmp_path / "jax"), verbose=False)
    sess = InferenceSession(ckpt, arch="unet_128", compute_dtype=torch.float32, device="cpu")
    assert sess.stages[0].model.cfg["meval"] is False and not sess.stages[0].chop
    written = sess.process(in_dir, str(tmp_path / "port"), verbose=False)
    assert cv2.imread(written[0]).shape == (128, 256, 3)
    _same_pngs(str(tmp_path / "jax"), str(tmp_path / "port"), ["a"])


def test_wbc_session_and_chain_match_jax(tmp_path):
    """The WBC preset (modcrop 4, guided filter after each stage) for one
    model and for a wbc+wbc chain."""
    a = _save(SP.wbc_state(nf=32, seed=16), tmp_path / "wbc_a.pth")
    b = _save(SP.wbc_state(nf=32, seed=17), tmp_path / "wbc_b.pth")
    in_dir = _images(tmp_path / "in", {"x": (38, 45), "y": (32, 28)}, seed=18)
    for label, models in (("one", a), ("chain", f"{a}+{b}")):
        JaxSession(models, compute_dtype=jnp.float32).process(
            in_dir, str(tmp_path / f"jax_{label}"), verbose=False)
        sess = InferenceSession(models, compute_dtype=torch.float32, device="cpu")
        assert sess.presets.use_guided_filter and len(sess.stages) == (2 if label == "chain" else 1)
        sess.process(in_dir, str(tmp_path / f"port_{label}"), verbose=False)
        assert cv2.imread(str(tmp_path / f"port_{label}" / "x.png")).shape == (36, 44, 3)
        _same_pngs(str(tmp_path / f"jax_{label}"), str(tmp_path / f"port_{label}"), ["x", "y"])


@pytest.mark.parametrize("flags", [["-cf"], ["-comp"], ["-norm"], ["-cf", "-comp"]])
def test_cli_flags_match_jax_cli(tmp_path, flags):
    """-cf on a 2x SR model (the bicubic down/up branch of color_fix),
    -comp (prepared input beside the output), -norm ([-1, 1] in and out)."""
    ckpt = _save(SP.esrgan_state(nb=1, nf=16, gc=8, scale=2, seed=2), tmp_path / "2x_synth.pth")
    in_dir = _images(tmp_path / "in", {"a": (20, 28), "b": (24, 24)}, seed=20)
    common = ["-m", ckpt, "-i", in_dir, "--tile", "16", "--overlap", "8"] + flags
    assert jax_cli(common + ["-o", str(tmp_path / "jax"), "-no_fp16", "-cpu"]) == 0
    assert torch_cli.main(common + ["-o", str(tmp_path / "port"), "-cpu"]) == 0
    _same_pngs(str(tmp_path / "jax"), str(tmp_path / "port"), ["a", "b"])
    if "-comp" in flags:
        assert cv2.imread(str(tmp_path / "port" / "a.png")).shape == (40, 112, 3)


def test_cli_resolves_a_chain_in_the_models_dir(tmp_path):
    models = tmp_path / "models"
    models.mkdir()
    _save(SP.wbc_state(nf=32, seed=21), models / "wbc_first.pth")
    _save(SP.wbc_state(nf=32, seed=22), models / "wbc_second.pth")
    in_dir = _images(tmp_path / "in", {"a": (24, 32)}, seed=23)
    common = ["-m", "first>second", "-i", in_dir, "--models-dir", str(models)]
    # the JAX CLI's -m names the preset: "wbc" is in the resolved paths only
    for cli, extra, out in ((jax_cli, ["-no_fp16", "-cpu", "--batch", "1"], "jax"),
                            (torch_cli.main, ["-cpu"], "port")):
        assert cli(common + ["-a", "wbcunet", "-o", str(tmp_path / out)] + extra) == 0
    _same_pngs(str(tmp_path / "jax"), str(tmp_path / "port"), ["a"])


# ---------------------------------------------------------------------------
# The whole-image memory guard
# ---------------------------------------------------------------------------

def test_memory_guard_refuses_train_mode_unet(tmp_path, monkeypatch):
    ckpt = _save(SP.unet_state(num_downs=7, ngf=64, seed=24), tmp_path / "p2p.pth")
    sess = InferenceSession(ckpt, arch="p2p_128", compute_dtype=torch.float32, device="cpu")
    img = np.zeros((128, 128, 3), np.uint8)
    need = pipeline._whole_forward_bytes(sess.stages[0].model, (1, 128, 128, 3))
    assert need == 128 * 128 * 64 * 2 * 4 * 3
    assert pipeline.whole_image_budget(torch.device("cpu")) is None  # waived on the CPU
    monkeypatch.setattr(pipeline, "whole_image_budget", lambda dev: need - 1)
    with pytest.raises(ValueError, match="train-mode normalization"):
        sess.run_image(img)
    monkeypatch.setattr(pipeline, "whole_image_budget", lambda dev: need)
    assert sess.run_image(img).shape == (128, 128, 3)


def test_memory_guard_tiles_wbc(tmp_path, monkeypatch, caplog):
    ckpt = _save(SP.wbc_state(nf=32, seed=25), tmp_path / "wbc.pth")
    sess = InferenceSession(ckpt, compute_dtype=torch.float32, device="cpu")
    img = np.random.default_rng(26).integers(0, 256, (136, 200, 3), dtype=np.uint8)
    whole = sess.run_image(img)
    monkeypatch.setattr(pipeline, "whole_image_budget", lambda dev: 1 << 20)
    with caplog.at_level(logging.WARNING, logger="innfer_tpu_torch"):
        tiled = sess.run_image(img)
        sess.run_image(img)
    stage = sess.stages[0]
    assert stage._fallback is not None and stage._fallback.last_mode == "auto"
    assert stage._fallback.plan_for(136, 200).n_tiles > 1
    assert sum("falling back to tiled" in r.message for r in caplog.records) == 1
    assert tiled.shape == whole.shape == (136, 200, 3)
    assert psnr(tiled, whole, 255.0) >= 30
