"""The port's checkpoint conversion tool and ``normal_to_mod`` against the
JAX package's: the same keys and bit-equal values, outputs that both
packages' loaders read."""
import os

import numpy as np
import pytest
import torch

from innfer_tpu.checkpoint.remaps import mod_to_normal as jax_mod_to_normal
from innfer_tpu.checkpoint.remaps import normal_to_mod as jax_normal_to_mod
from innfer_tpu.checkpoint.torch_pickle import load_checkpoint as jax_load
from innfer_tpu.tools import convert as jax_convert
from innfer_tpu_torch.checkpoint.detect import load_checkpoint
from innfer_tpu_torch.checkpoint.remaps import mod_to_normal, normal_to_mod
from innfer_tpu_torch.loader import load_model
from innfer_tpu_torch.tools import convert

GOLDENS = os.path.join(os.path.dirname(__file__), "goldens")


def _both(tmp_path, capsys, name, *args):
    """Run both tools on one golden; returns the two outputs' paths and
    the tail of each tool's closing line."""
    src = os.path.join(GOLDENS, name)
    outs, lines = [], []
    for tag, tool in (("port", convert), ("jax", jax_convert)):
        dst = str(tmp_path / f"{tag}.pth")
        assert tool.main([src, dst, *args]) == 0
        lines.append(capsys.readouterr().out.strip())
        outs.append(dst)
    assert lines[0].startswith(f"{src} -> {outs[0]}: ")
    assert lines[0].split(": ", 1)[1] == lines[1].split(": ", 1)[1]
    return outs


def _assert_same_state(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        assert torch.equal(a[k], b[k]), k


@pytest.mark.parametrize("name,args", [
    ("mesrgan_x4.pth", ["--remap", "mod2normal"]),
    ("mesrgan_x4.pth", ["--remap", "mod2normal", "--dtype", "fp16"]),
    ("mesrgan_x4.pth", ["--remap", "mod2normal", "--dtype", "bf16"]),
    ("esrgan_x4_swa.pth", ["--remap", "swa"]),
    ("esrgan_x4.pth", ["--remap", "normal2mod", "--dtype", "fp32"]),
    ("esrgan_x4_fp16.pth", ["--dtype", "bf16"]),
])
def test_tool_matches_the_jax_tool(tmp_path, capsys, name, args):
    port, ref = _both(tmp_path, capsys, name, *args)
    a = torch.load(port, map_location="cpu", weights_only=True)
    b = torch.load(ref, map_location="cpu", weights_only=True)
    _assert_same_state(a, b)
    if "--dtype" in args:
        want = {"fp16": torch.float16, "bf16": torch.bfloat16,
                "fp32": torch.float32}[args[args.index("--dtype") + 1]]
        assert {v.dtype for v in a.values()} == {want}  # biases too
    # each output through both packages' loaders
    for path in (port, ref):
        ours, theirs = load_checkpoint(path), jax_load(path)
        assert sorted(ours) == sorted(theirs)
        for k, v in ours.items():
            np.testing.assert_array_equal(v.float().numpy(), np.asarray(theirs[k], np.float32))


def test_converted_checkpoints_load_as_models(tmp_path, capsys):
    normal, _ = _both(tmp_path, capsys, "mesrgan_x4.pth", "--remap", "mod2normal")
    model, params = load_model(normal, device="cpu")
    ref_model, ref_params = load_model(os.path.join(GOLDENS, "mesrgan_x4.pth"), device="cpu")
    assert (model.cfg["nb"], model.scale) == (ref_model.cfg["nb"], ref_model.scale)
    x = torch.rand(1, 12, 10, 3, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        assert torch.equal(model.apply(params, x), ref_model.apply(ref_params, x))


def test_normal2mod_round_trip(tmp_path, capsys):
    mod, _ = _both(tmp_path, capsys, "esrgan_x4.pth", "--remap", "normal2mod")
    back = str(tmp_path / "back.pth")
    assert convert.main([mod, back, "--remap", "mod2normal"]) == 0
    _assert_same_state(torch.load(back, weights_only=True),
                       load_checkpoint(os.path.join(GOLDENS, "esrgan_x4.pth")))


@pytest.mark.parametrize("name", ["esrgan_x4.pth", "esrgan_x2.pth", "esrganlite_x4.pth",
                                  "mesrgan_x4.pth"])
def test_normal_to_mod_matches_jax(name):
    state = jax_load(os.path.join(GOLDENS, name))
    state = jax_mod_to_normal(state)
    ref = jax_normal_to_mod(state)
    out = normal_to_mod(mod_to_normal(load_checkpoint(os.path.join(GOLDENS, name))))
    assert list(out) == list(ref)
    for k, v in out.items():
        np.testing.assert_array_equal(v.float().numpy(), np.asarray(ref[k], np.float32))


def test_normal_to_mod_leaves_other_layouts():
    state = {"conv_first.weight": torch.zeros(1)}
    assert normal_to_mod(state) is state
