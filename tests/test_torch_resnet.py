"""The port's CycleGAN ResNet generator (innfer_tpu_torch/models/resnet.py)
and its fused ResnetBlock (ops/resnet_block.py) against the JAX package
and the reference goldens, on the CPU.

Inputs and weights are seeded numpy arrays handed to both packages.
Tolerances:
  * fp32, kernel plain version vs the JAX Pallas kernel in interpret mode:
    atol 1e-4 (true fp32 on both sides; the convs and the IN means sum in
    different orders, and IN divides by a standard deviation near 1);
  * bf16: PSNR >= 55 dB (the bar of tests/test_pallas_resnet_block.py:72),
    and |a - b| <= 2^-7 (|b| + |b - x| + 1) for every value: one bf16 ulp
    (at most 2^-7 relative) of the sum x + h2, of h2 ~ b - x, and of h2's
    unit scale.  The two sides differ only in summation order, which can
    flip a rounding of the sum, of h2, or of h1; a flipped h1 reaches h2
    as an absolute error of IN's unit-variance scale, not a relative one
    (it dominates where conv2's sum nearly cancels its mean: the largest
    such error seen here is 1.3e-3, 6x below the bar);
  * goldens: >= 80 dB in fp32, the JAX suite's bar;
  * whole models and sessions in fp32: atol 1e-4 / u8 |delta| <= 1.
"""
import json
import os

import cv2
import numpy as np
import pytest
import torch
import torch.nn.functional as TF

import jax.numpy as jnp

from innfer_tpu.cli import main as jax_cli
from innfer_tpu.config.defaults import get_network_config as jax_config
from innfer_tpu.loader import load_model_from_state as jax_load_from_state
from innfer_tpu.ops.pallas.resnet_block import fused_resnet_block as jax_block
from innfer_tpu.pipeline import InferenceSession as JaxSession
from innfer_tpu_torch import cli as torch_cli
from innfer_tpu_torch.checkpoint.detect import load_checkpoint
from innfer_tpu_torch.config.defaults import get_network_config
from innfer_tpu_torch.loader import load_model_from_state
from innfer_tpu_torch.models import convert_state, get_network, params_from_jax
from innfer_tpu_torch.nn import functional as F
from innfer_tpu_torch.ops import resnet_block as RB
from innfer_tpu_torch.ops.conv3x3 import n_tile
from innfer_tpu_torch.ops.resnet_block import (fused_resnet_block, pack_resnet_block,
                                               resnet_block_ok,
                                               resnet_block_reference)
from innfer_tpu_torch.pipeline import InferenceSession, select_presets
from test_pallas_resnet_block import xla_block
from test_torch_rdb import read_packed
from tools import synth_params as SP

GOLDENS = os.path.join(os.path.dirname(__file__), "goldens")


def psnr(a, b, peak=None):
    if peak is None:
        peak = max(1.0, float(np.abs(b).max()))
    mse = np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2)
    return np.inf if mse == 0 else 10 * np.log10(peak ** 2 / mse)


def _block_params(c=256, seed=0):
    """HWIO weights (the JAX layout) and fp32 biases, seeded numpy."""
    g = np.random.default_rng(seed)
    w1, w2 = (g.standard_normal((3, 3, c, c)).astype(np.float32) * 0.02 for _ in range(2))
    b1, b2 = (g.standard_normal(c).astype(np.float32) * 0.1 for _ in range(2))
    return w1, b1, w2, b2


def _oihw(w):
    return torch.from_numpy(np.ascontiguousarray(w.transpose(3, 2, 0, 1)))


def _both(shape, dtype, bias, seed=5):
    """(port plain version, JAX Pallas interpret) on the same inputs, and x."""
    w1, b1, w2, b2 = _block_params(shape[-1])
    if not bias:
        b1 = b2 = None
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    tdt, jdt = (torch.float32, jnp.float32) if dtype == "fp32" else (torch.bfloat16, jnp.bfloat16)
    xt = torch.from_numpy(x).to(tdt)
    tb = lambda b: None if b is None else torch.from_numpy(b)  # noqa: E731
    got = resnet_block_reference(xt, _oihw(w1), tb(b1), _oihw(w2), tb(b2)).float().numpy()
    jb = lambda b: None if b is None else jnp.asarray(b)  # noqa: E731
    ref = np.asarray(jax_block(jnp.asarray(x, jdt), jnp.asarray(w1, jdt), jb(b1),
                               jnp.asarray(w2, jdt), jb(b2), interpret=True), np.float32)
    return got, ref, xt.float().numpy()


JAX_SHAPES = [(2, 8, 16, 256), (1, 12, 32, 256), (3, 16, 16, 256)]


@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("shape", JAX_SHAPES)
def test_block_reference_matches_jax_kernel_fp32(shape, bias):
    got, ref, _ = _both(shape, "fp32", bias)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=0)


@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("shape", JAX_SHAPES)
def test_block_reference_matches_jax_kernel_bf16(shape, bias):
    got, ref, x = _both(shape, "bf16", bias)
    assert psnr(got, ref) >= 55
    bar = 2.0 ** -7 * (np.abs(ref) + np.abs(ref - x) + 1)
    assert (np.abs(got - ref) <= bar).all(), np.abs(got - ref).max()


def test_block_reference_matches_jax_xla_block_on_a_width_the_tpu_refuses():
    """W=20 is not a 16-multiple: the TPU kernel refuses it, the port's
    kernel gate takes it; hold the plain version to the XLA block."""
    shape = (2, 10, 20, 256)
    w1, b1, w2, b2 = _block_params()
    x = np.random.default_rng(9).standard_normal(shape).astype(np.float32)
    with pytest.raises(ValueError, match="16-multiple"):
        jax_block(jnp.asarray(x), jnp.asarray(w1), None, jnp.asarray(w2), None, interpret=True)
    assert resnet_block_ok(shape, torch.float32)
    ref = np.asarray(xla_block(jnp.asarray(x), jnp.asarray(w1), jnp.asarray(b1),
                               jnp.asarray(w2), jnp.asarray(b2)))
    got = resnet_block_reference(torch.from_numpy(x), _oihw(w1), torch.from_numpy(b1),
                                 _oihw(w2), torch.from_numpy(b2)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=0)


def test_wrapper_on_cpu_takes_the_plain_version_and_checks_its_gate():
    w1, b1, w2, b2 = (torch.from_numpy(a) for a in _block_params(32))
    w1, w2 = w1.permute(3, 2, 0, 1).contiguous(), w2.permute(3, 2, 0, 1).contiguous()
    x = torch.from_numpy(np.random.default_rng(2).standard_normal((2, 2, 3, 32), np.float32))
    before = fused_resnet_block.launches
    out = fused_resnet_block(x, w1, b1, w2, None)
    assert fused_resnet_block.launches == before
    torch.testing.assert_close(out, resnet_block_reference(x, w1, b1, w2, None), rtol=0, atol=0)
    for bad in (x[:, :1], x[..., :16], x.to(torch.float16)):
        assert not resnet_block_ok(tuple(bad.shape), bad.dtype)
        with pytest.raises(ValueError, match="H, W >= 2"):
            fused_resnet_block(bad.contiguous(), w1, b1, w2, b2)


def _chan(n, mu, m2, nb, mb, m2b):
    nab = n + nb
    d = mb - mu
    return nab, mu + d * (nb / nab), m2 + m2b + d * d * (n * nb / nab)


def _tile_stats(acc, th, lanes=8):
    """conv3x3_tc.cuh's statistics and resnet_block.cu's in_merge: per tile
    of th rows x 64 columns (tiles numbered row-major) the count, mean and
    centred M2 of each channel; lane l merges tiles l, l + lanes, ... with
    Chan's formula, then the lanes are merged in lane order."""
    b_, h, w, c = acc.shape
    tiles = []
    for y0 in range(0, h, th):
        for x0 in range(0, w, 64):
            t = acc[:, y0:y0 + th, x0:x0 + 64].reshape(b_, -1, c)
            mb = t.sum(1) / t.shape[1]
            tiles.append((float(t.shape[1]), mb, (t - mb[:, None]).square().sum(1)))
    parts = []
    for lane in range(lanes):
        n, mu, m2 = 0.0, torch.zeros(b_, c), torch.zeros(b_, c)
        for nb, mb, m2b in tiles[lane::lanes]:
            n, mu, m2 = _chan(n, mu, m2, nb, mb, m2b)
        parts.append((n, mu, m2))
    n, mu, m2 = parts[0]
    for part in parts[1:]:
        if part[0] > 0:
            n, mu, m2 = _chan(n, mu, m2, *part)
    return mu, m2 / n


def _emulate_block(x, packed, eps=1e-5):
    """The CUDA host function's split of the work, in PyTorch: reflect
    conv reading the packed weights at the C code's offsets, the fp32
    pre-norm sum, tile statistics merged as the bf16 path merges them,
    normalize + ReLU into h1, the second conv, normalize + residual."""
    dt = x.dtype
    b_, h, w, c = x.shape
    th = 2 * {256: 1, 128: 2, 64: 2}.get(n_tile(c), 4)

    def conv_in(t, wp, bias):
        wc = read_packed(wp, c, c).permute(2, 3, 1, 0)  # (ky, kx, cin, cout)
        tp = TF.pad(t.float().permute(0, 3, 1, 2), (1, 1, 1, 1), mode="reflect").permute(0, 2, 3, 1)
        acc = sum(tp[:, ky: ky + h, kx: kx + w, :] @ wc[ky, kx]
                  for ky in range(3) for kx in range(3)) + bias
        mean, var = _tile_stats(acc, th)
        return (acc - mean[:, None, None]) * torch.rsqrt(var + eps)[:, None, None]

    h1 = torch.relu(conv_in(x, packed.w1, packed.b1)).to(dt)
    h2 = conv_in(h1, packed.w2, packed.b2).to(dt)
    return (x.float() + h2.float()).to(dt)


@pytest.mark.parametrize("shape", [(2, 9, 70, 32), (1, 5, 7, 256), (1, 6, 66, 64),
                                   (1, 40, 130, 32)])
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_packed_layout_emulation_matches_reference(shape, dtype):
    """pack_resnet_block's layout read at the C code's offsets, and the
    tile statistics merged with Chan's formula, compute the plain
    version's function: fp32 atol 1e-4, bf16 at the ulp bar (module
    docstring).  The shapes cut ragged row and column tiles."""
    tdt = torch.float32 if dtype == "fp32" else torch.bfloat16
    w1, b1, w2, b2 = (torch.from_numpy(a) for a in _block_params(shape[-1], seed=7))
    w1, w2 = w1.permute(3, 2, 0, 1).contiguous(), w2.permute(3, 2, 0, 1).contiguous()
    x = torch.from_numpy(np.random.default_rng(8).standard_normal(shape).astype(np.float32)).to(tdt)
    packed = pack_resnet_block(w1, b1, w2, b2, tdt)
    emu = _emulate_block(x, packed).float()
    ref = resnet_block_reference(x, w1, b1, w2, b2).float()
    if dtype == "fp32":
        assert (emu - ref).abs().max().item() < 1e-4
    else:
        bar = 2.0 ** -7 * (ref.abs() + (ref - x.float()).abs() + 1)
        assert ((emu - ref).abs() <= bar).all()


# --- the model ---------------------------------------------------------------


def _golden(name):
    fx = np.load(os.path.join(GOLDENS, f"{name}.npz"))
    return fx, json.loads(str(fx["meta"]))


@pytest.mark.parametrize("name,strict", [
    ("cyclegan9", False), ("cyclegan6", False), ("cyclegan_zero", False),
    ("cyclegan_dropout", False), ("cyclegan_bn_eval", False), ("cyclegan_bn_train", True),
])
def test_golden_through_the_port(name, strict):
    fx, meta = _golden(name)
    state = load_checkpoint(os.path.join(GOLDENS, f"{name}.pth"))
    cfg = dict(meta["cfg"])
    cfg["meval"] = meta.get("meval", True)
    model, params = load_model_from_state(state, cfg, device="cpu", strict=strict)
    if cfg["norm_type"] == "batch":  # BN stats survive non-strict loading
        assert any(k.endswith("running_mean") for k in params)
    x = torch.from_numpy(np.ascontiguousarray(np.transpose(fx["input"], (0, 2, 3, 1))))
    with torch.no_grad():
        out = model.apply(params, x).permute(0, 3, 1, 2).numpy()
    assert out.shape == fx["output"].shape
    assert psnr(out, fx["output"]) >= 80


def test_nonstrict_load_drops_only_instance_norm_stats():
    state = dict(SP.cyclegan_state(n_blocks=2, ngf=8, seed=1))
    state["model.2.running_mean"] = np.zeros(8, np.float32)
    state["model.2.num_batches_tracked"] = np.zeros((), np.int64)
    model = get_network(get_network_config("resnet_6blocks", 1))
    assert "model.2.running_mean" in convert_state(model, state)
    kept = convert_state(model, state, strict=False)
    assert sorted(kept) == sorted(SP.cyclegan_state(n_blocks=2, ngf=8, seed=1))


def _pair(**cfg_kw):
    spec = {"type": "resnet_6blocks", "n_blocks": 2, **cfg_kw}
    state = SP.cyclegan_state(n_blocks=2, ngf=8, seed=4)
    jm, jp = jax_load_from_state(state, jax_config(spec, 1))
    tm = get_network(jax_config(spec, 1))
    return jm, jp, tm, params_from_jax({k: np.asarray(v) for k, v in jp.items()}, tm)


@pytest.mark.parametrize("route", ["torch", "kernel"])
def test_matches_jax_model_fp32_through_params_from_jax(route, monkeypatch):
    """The deconv weights cross from the JAX layout (flipped (kh,kw,I,O))
    back to the checkpoint's (I,O,kh,kw); the kernel's route
    (``resnet_block.fusable`` patched to the card's answer) on the CPU runs
    the block's plain version."""
    if route == "kernel":
        monkeypatch.setattr(RB, "fusable", RB.takes)
    jm, jp, tm, tp = _pair()
    assert tm.transposed_keys == jm.transposed_keys
    state = SP.cyclegan_state(n_blocks=2, ngf=8, seed=4)
    for key in (r"model.12.weight", r"model.15.weight"):
        np.testing.assert_array_equal(tp[key].numpy(), state[key])
    x = np.random.default_rng(0).random((1, 28, 36, 3), np.float32) * 2 - 1
    ref = np.asarray(jm.apply(jp, jnp.asarray(x)))
    out = tm.apply(tp, torch.from_numpy(x)).numpy()
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, atol=1e-4, rtol=0)


def test_upconv_variant_matches_jax_model_fp32():
    """upsample_mode='upconv': nearest 2x then a 3x3 conv at key .1."""
    state = dict(SP.cyclegan_state(n_blocks=2, ngf=8, seed=6))
    g = np.random.default_rng(6)
    for idx, (o, i) in ((12, (16, 32)), (15, (8, 16))):
        del state[f"model.{idx}.weight"], state[f"model.{idx}.bias"]
        state[f"model.{idx}.1.weight"] = g.uniform(-0.1, 0.1, (o, i, 3, 3)).astype(np.float32)
        state[f"model.{idx}.1.bias"] = g.uniform(-0.01, 0.01, o).astype(np.float32)
    spec = {"type": "resnet_6blocks", "n_blocks": 2, "upsample_mode": "upconv"}
    jm, jp = jax_load_from_state(state, jax_config(spec, 1))
    tm = get_network(jax_config(spec, 1))
    assert tm.transposed_keys == ()
    tp = params_from_jax({k: np.asarray(v) for k, v in jp.items()}, tm)
    x = np.random.default_rng(1).random((1, 24, 32, 3), np.float32) * 2 - 1
    np.testing.assert_allclose(tm.apply(tp, torch.from_numpy(x)).numpy(),
                               np.asarray(jm.apply(jp, jnp.asarray(x))), atol=1e-4, rtol=0)


def test_batch_norm_training_is_per_image():
    """ROADMAP queue C: train-mode BN reduces per image, so a batch of two
    images gives each image's own single-image result."""
    g = np.random.default_rng(3)
    x = torch.from_numpy(g.standard_normal((2, 6, 5, 4), np.float32))
    wb = [torch.from_numpy(g.standard_normal(4, np.float32)) for _ in range(2)]
    both = F.batch_norm(x, *wb, None, None, training=True)
    for i in range(2):
        one = F.batch_norm(x[i:i + 1], *wb, None, None, training=True)
        torch.testing.assert_close(both[i:i + 1], one, rtol=0, atol=0)


@pytest.mark.parametrize("spec", ["resnet_9blocks", "resnet_6blocks", "cg_6", "cg9",
                                  {"type": "resnet_9", "ngf": 32}])
def test_config_defaults_equal_jax(spec):
    assert get_network_config(spec, 1) == jax_config(spec, 1)


@pytest.fixture
def cg_in_dir(tmp_path):
    d = tmp_path / "in"
    d.mkdir()
    g = np.random.default_rng(6)
    for name, (h, w) in {"a": (40, 56), "b": (72, 48)}.items():
        cv2.imwrite(str(d / f"{name}.png"), g.integers(0, 256, (h, w, 3), dtype=np.uint8))
    return str(d)


def _assert_same_pngs(dir_a, dir_b):
    for n in ("a", "b"):
        a = cv2.imread(os.path.join(dir_a, f"{n}.png"), cv2.IMREAD_UNCHANGED)
        b = cv2.imread(os.path.join(dir_b, f"{n}.png"), cv2.IMREAD_UNCHANGED)
        assert b is not None and a.shape == b.shape and b.dtype == np.uint8
        assert np.abs(a.astype(int) - b.astype(int)).max() <= 1


CYCLEGAN9 = os.path.join(GOLDENS, "cyclegan9.pth")


def test_session_matches_jax_session_on_the_golden(cg_in_dir, tmp_path):
    """The cyclegan preset (normalize to [-1, 1], non-strict load) through
    both packages' sessions in fp32, auto tile plans, u8 PNGs."""
    kw = dict(arch="resnet_9blocks", tile=32, overlap=8, tile_batch=4, tile_mode="auto")
    JaxSession(CYCLEGAN9, compute_dtype=jnp.float32, **kw).process(
        cg_in_dir, str(tmp_path / "jax"), verbose=False)
    sess = InferenceSession(CYCLEGAN9, compute_dtype=torch.float32, device="cpu", **kw)
    assert sess.presets == select_presets("resnet_9blocks") and not sess.presets.strict
    sess.process(cg_in_dir, str(tmp_path / "port"), verbose=False)
    _assert_same_pngs(str(tmp_path / "jax"), str(tmp_path / "port"))


def test_cli_matches_jax_cli_on_the_golden(cg_in_dir, tmp_path):
    common = ["-m", CYCLEGAN9, "-a", "resnet_9blocks", "-i", cg_in_dir]
    assert jax_cli(common + ["-o", str(tmp_path / "jax"), "-no_fp16", "-cpu"]) == 0
    assert torch_cli.main(common + ["-o", str(tmp_path / "port"), "-cpu"]) == 0
    _assert_same_pngs(str(tmp_path / "jax"), str(tmp_path / "port"))
