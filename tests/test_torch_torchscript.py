"""The port's TorchScript models (innfer_tpu_torch/compat/torchscript.py),
run through the session's Stage, against the contract of
tests/test_torchscript.py and the JAX package's stage, on the CPU.  Archives are tiny random modules scripted in the test.
Tolerances: the tiled glue of a pointwise module equals its whole-image
forward to 1e-6; both packages run the same torch forward, so their
outputs agree to 1e-6 (u8: one rounding step).
"""
import os.path as osp

import cv2
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from innfer_tpu.compat.torchscript import TorchScriptStage as JaxStage
from innfer_tpu.pipeline import InferenceSession as JaxSession
from innfer_tpu_torch import cli
from innfer_tpu_torch.compat.torchscript import is_torchscript, load_torchscript
from innfer_tpu_torch.loader import load_model
from innfer_tpu_torch.pipeline import InferenceSession, select_presets

GOLDENS = osp.join(osp.dirname(__file__), "goldens")
CPU = torch.device("cpu")


class _Pointwise(torch.nn.Module):
    """1x1 conv, scale 1: the tiled output equals the whole output."""

    def __init__(self):
        super().__init__()
        self.conv = torch.nn.Conv2d(3, 3, 1)

    def forward(self, x):
        return self.conv(x)


class _Up2(torch.nn.Module):
    """3x3 conv + PixelShuffle: a 2x SR net for scale probing."""

    def __init__(self):
        super().__init__()
        self.conv = torch.nn.Conv2d(3, 12, 3, padding=1)
        self.ps = torch.nn.PixelShuffle(2)

    def forward(self, x):
        return self.ps(self.conv(x))


def _save_ts(tmp_path, module_cls, name):
    torch.manual_seed(0)
    path = str(tmp_path / name)
    torch.jit.script(module_cls()).save(path)
    return path


def _stage(ts, chop=True, **kw):
    """The session's Stage for an archive (``arch='ts'``), on the CPU."""
    presets = select_presets("ts")
    presets.chop = chop
    return InferenceSession(ts, presets=presets, device="cpu", **kw).stages[0]


def _write_png(path, h, w, seed=0):
    img = np.random.default_rng(seed).integers(0, 256, (h, w, 3), dtype=np.uint8)
    cv2.imwrite(str(path), img)
    return img


def test_is_torchscript_fingerprint(tmp_path):
    ts = _save_ts(tmp_path, _Pointwise, "m.pt")
    assert is_torchscript(ts)
    assert not is_torchscript(osp.join(GOLDENS, "esrgan_x2.pth"))
    (tmp_path / "junk.pt").write_bytes(b"not a zip")
    assert not is_torchscript(str(tmp_path / "junk.pt"))
    with pytest.raises(ValueError, match="TorchScript archive"):
        load_model(ts, device="cpu")


def test_scale_probe(tmp_path):
    assert load_torchscript(_save_ts(tmp_path, _Pointwise, "a.pt"), device=CPU)[0].scale == 1
    assert load_torchscript(_save_ts(tmp_path, _Up2, "b.pt"), device=CPU)[0].scale == 2


def test_chop_equals_whole_for_pointwise(tmp_path):
    ts = _save_ts(tmp_path, _Pointwise, "m.pt")
    x = torch.from_numpy(np.random.default_rng(1).random((1, 70, 90, 3), np.float32))
    whole = _stage(ts, chop=False)(x)
    tiled = _stage(ts, tile=32, overlap=8)(x)
    assert tiled.shape == whole.shape == (1, 70, 90, 3)
    np.testing.assert_allclose(tiled.numpy(), whole.numpy(), atol=1e-6, rtol=0)


@pytest.mark.parametrize("chop,tile", [(True, 32), (True, 64), (False, 32)])
def test_stage_matches_jax_stage(tmp_path, chop, tile):
    """A tile of 64 exceeds the 40-row image and is clamped to 40, as the
    JAX package's stage clamps it."""
    ts = _save_ts(tmp_path, _Up2, "2x.pt")
    x = np.random.default_rng(2).random((2, 40, 52, 3), np.float32)
    ref = np.asarray(JaxStage(ts, chop=chop, tile=tile, overlap=8)(jnp.asarray(x)))
    out = _stage(ts, chop=chop, tile=tile, overlap=8)(torch.from_numpy(x))
    assert out.shape == ref.shape == (2, 80, 104, 3)
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-6, rtol=0)


def test_stage_runs_true_fp32_and_restores_the_flags(tmp_path):
    """The forward runs with TF32 off in cuDNN and cuBLAS and in fp32 (the
    reference turns fp16 off for TorchScript); the flags come back after."""
    stage = _stage(_save_ts(tmp_path, _Up2, "2x.pt"), chop=False)
    seen = []

    class Spy(torch.nn.Module):
        def forward(self, x):
            seen.append((torch.backends.cudnn.allow_tf32,
                         torch.backends.cuda.matmul.allow_tf32, x.dtype))
            return x

    stage.params["module"] = Spy()
    cudnn = torch.backends.cudnn.allow_tf32
    stage(torch.zeros(1, 8, 8, 3, dtype=torch.bfloat16))
    assert seen == [(False, False, torch.float32)]
    assert torch.backends.cudnn.allow_tf32 == cudnn


@pytest.mark.parametrize("arch", ["infer", "ts"])
def test_session_e2e_sr(tmp_path, arch):
    """A directory through InferenceSession, the archive found by its
    fingerprint or by arch 'ts'; the session computes in fp32 even when
    bf16 was asked for."""
    ts = _save_ts(tmp_path, _Up2, "2x_up.pt")
    inp, out = tmp_path / "in", tmp_path / "out"
    inp.mkdir()
    _write_png(inp / "a.png", 40, 56)
    sess = InferenceSession(ts, arch=arch, compute_dtype=torch.bfloat16, tile=32, overlap=8,
                            device="cpu")
    assert sess.compute_dtype == torch.float32 and sess.stages[0].model.scale == 2
    written = sess.process(str(inp), str(out), verbose=False)
    assert cv2.imread(written[0]).shape == (80, 112, 3)


def test_session_matches_jax_session(tmp_path):
    ts = _save_ts(tmp_path, _Up2, "2x_up.pt")
    inp = tmp_path / "in"
    inp.mkdir()
    _write_png(inp / "a.png", 45, 61, seed=3)
    JaxSession(ts, compute_dtype=jnp.float32, tile=32, overlap=8).process(
        str(inp), str(tmp_path / "jax"), verbose=False)
    InferenceSession(ts, compute_dtype=torch.float32, tile=32, overlap=8, device="cpu").process(
        str(inp), str(tmp_path / "port"), verbose=False)
    a = cv2.imread(str(tmp_path / "jax" / "a.png"))
    b = cv2.imread(str(tmp_path / "port" / "a.png"))
    assert a.shape == b.shape == (90, 122, 3)
    assert np.abs(a.astype(int) - b.astype(int)).max() <= 1


def test_whole_image_preset(tmp_path):
    ts = _save_ts(tmp_path, _Up2, "2x.pt")
    presets = select_presets("infer")
    presets.chop = False
    sess = InferenceSession(ts, presets=presets, device="cpu")
    img = np.random.default_rng(4).integers(0, 256, (24, 20, 3), dtype=np.uint8)
    assert sess.run_image(img).shape == (48, 40, 3)


def test_cli_arch_ts(tmp_path):
    ts = _save_ts(tmp_path, _Up2, "2x_up.pt")
    inp, out = tmp_path / "in", tmp_path / "out"
    inp.mkdir()
    _write_png(inp / "img.png", 20, 28)
    assert cli.main(["-m", ts, "-a", "ts", "-i", str(inp), "-o", str(out), "-cpu"]) == 0
    assert cv2.imread(str(out / "img.png")).shape == (40, 56, 3)


def test_multi_output_module_rejected(tmp_path):
    class TwoOut(torch.nn.Module):
        def forward(self, x):
            return x, x

    path = str(tmp_path / "two.pt")
    torch.jit.script(TwoOut()).save(path)
    with pytest.raises(ValueError, match="multi-output"):
        load_torchscript(path, device=CPU)
