"""The port's bench entry (bench_torch.py) and its weights module, on the CPU.

* every config of bench.py runs in-process with ``--cpu`` at a tiny size and
  prints one line with every key; the line says it is a CPU rehearsal;
* ``innfer_tpu_torch/tools/synth_params.py`` gives the JAX package's
  ``tools/synth_params.py`` keys and arrays, every family, two seeds;
* in fp32 each device-step config's output equals the JAX package's, built
  by ``tools/synth_params.build`` on the same numpy input, bench.py's recipe
  with the tile mode pinned to uniform on both sides (the JAX runner without
  its TPU tile quantum): >= 80 dB against max(1, max|ref|), and for SRResNet,
  PAN and PPON also tests/test_torch_zoo.py's max-abs 1e-5 x max(1, max|ref|);
* without ``--cpu`` and with no card the command raises; a perturbed output
  (and a changed PNG in an ``_e2e`` pass) exits 1;
* building a session asks cuDNN for deterministic algorithms (C4).
"""
import json
import math
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import bench_torch as B
from innfer_tpu.checkpoint.writer import write_checkpoint
from innfer_tpu.ops.filters import color_fix as jax_color_fix
from innfer_tpu.ops.filters import guided_filter as jax_guided_filter
from innfer_tpu.pipeline import InferenceSession as JaxSession
from innfer_tpu.pipeline import np2tensor as jax_np2tensor
from innfer_tpu.tiling.engine import TiledRunner as JaxRunner
from innfer_tpu_torch.pipeline import InferenceSession
from innfer_tpu_torch.tools import synth_params as TS
from tools import synth_params as SP

TINY = ["--cpu", "--height", "32", "--width", "48", "--nb", "1", "--nf", "8", "--tile", "16",
        "--overlap", "4", "--tile-batch", "2", "--iters", "1"]
STEP_CONFIGS = [m for m in B.CONFIGS if not m.endswith("_e2e")]
KEYS = ("metric", "value", "unit", "samples_ms", "median_ms", "min_ms", "max_ms", "n", "setup_s",
        "device", "launches", "fidelity_db", "fidelity_bar_db", "fidelity_against",
        "fidelity_ok", "fidelity_misses")


def _argv(model, *extra):
    return ["--model", model, *TINY, *(["--batch", "1"] if model == "unet" else []), *extra]


@pytest.mark.parametrize("model", B.CONFIGS)
def test_each_config_prints_one_line_on_the_cpu(model, monkeypatch, capsys):
    monkeypatch.setenv("INNFER_E2E_IMGS", "2")
    line = B.main(_argv(model))
    printed = capsys.readouterr().out.strip().splitlines()
    assert json.loads(printed[-1]) == line
    assert all(k in line for k in KEYS), set(KEYS) - set(line)
    assert line["metric"].startswith(B.CPU_PREFIX) and line["unit"] == "MP/s"
    assert line["device"] == {"platform": "cpu"}
    assert line["n"] == len(line["samples_ms"]) == 1
    assert line["median_ms"] == line["samples_ms"][0] > 0 and line["setup_s"] > 0
    assert math.isclose(line["value"] * line["median_ms"] / 1e3, _out_mp(model), rel_tol=1e-9)
    assert line["launches"] == {"fused_rdb": 0, "fused_rdb_padded": 0, "fused_rrdb_trunk": 0,
                                "fused_resnet_block": 0}
    assert line["fidelity_ok"] and line["fidelity_misses"] == []
    if model.endswith("_e2e"):
        assert line["fidelity_db"] == "inf" and set(line["stages"]) >= {"read", "image", "encode"}
    else:
        assert line["fidelity_db"] >= line["fidelity_bar_db"] == B.PLAIN_DB
        assert line["output_u8_std"] > 0
        assert "kernel_vs_plain_db" not in line  # no kernel runs on the CPU


def _out_mp(model):
    """Output megapixels of one step at TINY's 32x48: bench.py's sizes."""
    return {"esrgan": 32 * 48 * 16, "srresnet": 32 * 48 * 16, "chain": 16 * 24 * 16,
            "unet": 256 * 256, "cyclegan": 16 * 24, "ppon": 16 * 24 * 16, "wbc": 32 * 48,
            "pan": 32 * 48 * 16, "esrgan_e2e": 2 * 32 * 48 * 16,
            "pan_e2e": 2 * 32 * 48 * 16}[model] / 1e6


def test_fp32_line_holds_the_kernel_path_to_its_plain_versions(capsys):
    line = B.main(_argv("cyclegan", "--dtype", "fp32"))
    assert line["fidelity_bar_db"] == B.FP32_DB and line["fidelity_db"] == "inf"
    assert "ops.plain_path" in line["fidelity_against"]


@pytest.mark.parametrize("model", ["esrgan", "chain"])
def test_bf16_line_adds_the_kernel_bar_where_a_kernel_ran(model, monkeypatch, capsys):
    """On the card a kernel's launches count; here the count is faked, and
    the plain bf16 reference is the same computation as the timed one.  A
    chain is held model by model."""
    monkeypatch.setattr(B, "_per_step", lambda n: {"fused_rdb": 69})
    line = B.main(_argv(model))
    assert line["kernel_vs_plain_bar_db"] == B.KERNEL_DB == 40.0
    assert line["kernel_vs_plain_db"] == "inf" and line["fidelity_ok"]
    if model == "chain":
        assert line["kernel_vs_plain_stages_db"] == ["inf", "inf"]
        assert "each model of the chain" in line["kernel_vs_plain_against"]
    else:
        assert "kernel_vs_plain_stages_db" not in line


def _perturb_timed_step(monkeypatch, scale):
    """The first step built (the timed one) returns its output plus seeded
    noise; the references stay as they are."""
    built = []
    real = B.build_step

    def build(args, dtype, device):
        step = real(args, dtype, device)
        if not built:
            run, g = step.run, torch.Generator().manual_seed(0)

            def noisy():
                out = run()
                return out + scale * torch.randn(out.shape, generator=g).to(out.dtype)

            step.run = noisy
        built.append(step)
        return step

    monkeypatch.setattr(B, "build_step", build)


@pytest.mark.parametrize("dtype,scale", [("bf16", 0.2), ("fp32", 1e-3)])
def test_a_perturbed_output_exits_non_zero(dtype, scale, monkeypatch, capsys):
    _perturb_timed_step(monkeypatch, scale)
    with pytest.raises(SystemExit) as exc:
        B.main(_argv("esrgan", "--dtype", dtype))
    assert exc.value.code == 1
    out, err = capsys.readouterr()
    line = json.loads(out.strip().splitlines()[-1])
    assert not line["fidelity_ok"] and line["fidelity_db"] < line["fidelity_bar_db"]
    assert "missed its fidelity bar" in err and "fidelity:" in err


def test_a_changed_png_in_the_last_e2e_pass_exits_non_zero(monkeypatch, capsys):
    monkeypatch.setenv("INNFER_E2E_IMGS", "2")
    passes = []

    class Flipping(InferenceSession):
        def process(self, input_dir, output_dir, **kw):
            written = super().process(input_dir, output_dir, **kw)
            passes.append(output_dir)
            if len(passes) > 1:  # a timed pass: one byte of one PNG's pixels changes
                with open(written[0], "r+b") as f:
                    f.seek(-20, os.SEEK_END)
                    byte = f.read(1)
                    f.seek(-20, os.SEEK_END)
                    f.write(bytes([byte[0] ^ 1]))
            return written

    monkeypatch.setattr(B, "InferenceSession", Flipping)
    with pytest.raises(SystemExit) as exc:
        B.main(_argv("esrgan_e2e"))
    assert exc.value.code == 1 and len(passes) == 2
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert not line["fidelity_ok"] and len(line["fidelity_misses"]) == 1


def test_without_cpu_and_without_a_card_it_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        B.main(["--model", "esrgan"])


def test_session_configs_refuse_whole_image_mode():
    with pytest.raises(SystemExit):
        B.parse_args(["--model", "chain", "--tile-mode", "none"])


def test_a_session_makes_cudnn_deterministic(monkeypatch, tmp_path):
    """C4: on the H100, pix2pix's and CycleGAN's transposed convs gave u8
    outputs one level apart between passes until the session asked cuDNN
    for deterministic algorithms (reference run.py:337).  Its autotuner
    (run.py:336) stays off."""
    monkeypatch.setattr(torch.backends.cudnn, "benchmark", False)
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", False)
    ckpt = tmp_path / "4x_synth.pth"
    torch.save({k: torch.from_numpy(v) for k, v in SP.esrgan_state(nb=1, nf=8).items()}, ckpt)
    InferenceSession(str(ckpt), device="cpu", compute_dtype=torch.float32)
    assert torch.backends.cudnn.deterministic and not torch.backends.cudnn.benchmark


def test_transposed_convs_autotune_among_deterministic_algorithms(monkeypatch):
    """C4: cuDNN runs a transposed conv as a backward-data conv; the port
    asks it to time its deterministic algorithms for that call only, and
    restores both flags after it."""
    from innfer_tpu_torch.nn import functional as NF

    cudnn = torch.backends.cudnn
    monkeypatch.setattr(cudnn, "benchmark", False)
    monkeypatch.setattr(cudnn, "deterministic", False)
    seen = []
    real = torch.nn.functional.conv_transpose2d

    def spy(*a, **k):
        seen.append((cudnn.benchmark, cudnn.deterministic))
        return real(*a, **k)

    monkeypatch.setattr(torch.nn.functional, "conv_transpose2d", spy)
    x = torch.randn(1, 5, 6, 4)
    w = torch.randn(4, 3, 4, 4)
    out = NF.conv_transpose2d(x, w, torch.zeros(3))
    assert out.shape == (1, 10, 12, 3) and seen == [(True, True)]
    assert (cudnn.benchmark, cudnn.deterministic) == (False, False)
    NF.conv2d(x, torch.randn(3, 4, 3, 3), padding=1)  # a forward conv leaves them alone
    assert len(seen) == 1


@pytest.mark.parametrize("family", sorted(TS.STATES))
@pytest.mark.parametrize("seed", [0, 5])
def test_synth_states_equal_the_jax_package_s(family, seed):
    kw = {"scale": 4} if family in TS.SR_FAMILIES else {}
    if family in ("esrgan", "srresnet"):
        kw.update(nb=2, nf=16)
    ours = TS.state(family, seed=seed, **kw)
    theirs = getattr(SP, TS.STATES[family][0].__name__)(seed=seed, **kw)
    assert list(ours) == list(theirs)
    for k in ours:
        assert ours[k].dtype == theirs[k].dtype and np.array_equal(ours[k], theirs[k]), k


def test_build_needs_a_device():
    with pytest.raises(TypeError, match="device"):
        TS.build("wbc", nf=8)
    model, params = TS.build("wbc", nf=8, device="cpu", dtype=torch.bfloat16)
    assert params["conv.weight"].dtype == torch.bfloat16
    assert params["conv.bias"].dtype == torch.float32


# bench.py's model for each device-step config, on the JAX side
JAX_MODELS = {
    "esrgan": ("esrgan", dict(scale=4, nb=1, nf=8)),
    "srresnet": ("srresnet", dict(scale=4, nb=16, nf=64)),
    "cyclegan": ("cyclegan", dict(n_blocks=9, ngf=64)),
    "pan": ("pan", dict(scale=4, nb=16)),
    "ppon": ("ppon", dict(scale=4, nb=24)),
}


def _jax_step(model, x):
    """bench.py's step for ``model`` on the numpy input ``x``, in fp32."""
    f32 = jnp.float32
    if model in JAX_MODELS:
        family, kw = JAX_MODELS[model]
        jm, jp = SP.build(family, dtype=f32, **kw)
        if model == "srresnet":
            return np.asarray(jm.apply(jp, jnp.asarray(x)))
        runner = JaxRunner(jm.apply, jm.scale, mode="uniform", tile=16, overlap=4, tile_batch=2,
                           output_index=jm.output_index, compute_dtype=f32,
                           max_group_px=1_400_000, trunk_fn=jm.apply_trunk,
                           tail_fn=jm.apply_tail, tail_halo=jm.tail_halo)
        return np.asarray(runner(jp, jnp.asarray(x)))
    if model == "unet":
        jm, jp = SP.build("unet", dtype=f32, num_downs=8, ngf=64)
        return np.asarray(jax.jit(jm.apply)(jp, jnp.asarray(x)))
    if model == "wbc":
        jm, jp = SP.build("wbc", dtype=f32, nf=32)
        t = jnp.asarray(x)
        return np.asarray(jax_guided_filter(t, jm.apply(jp, t), r=1, eps=5e-3))
    raise ValueError(model)


def _jax_chain(tmp_path, img):
    c1, c2 = str(tmp_path / "1x_denoise.pth"), str(tmp_path / "4x_up.pth")
    write_checkpoint(c1, SP.esrgan_state(scale=1, nb=1, nf=8))
    write_checkpoint(c2, SP.esrgan_state(scale=4, nb=1, nf=8, seed=1))
    sess = JaxSession(c1 + "+" + c2, compute_dtype=jnp.float32, tile=16, overlap=4,
                      tile_mode="uniform", tile_batch=2)
    t = jax_np2tensor(img, dtype=jnp.float32)
    out = t
    for st in sess.stages:
        out = st(out)
    return np.asarray(jax_color_fix(t * 255.0, out * 255.0))


def _psnr(a, b, peak):
    mse = float(np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2))
    return math.inf if mse == 0 else 10 * math.log10(peak ** 2 / mse)


@pytest.mark.parametrize("model", STEP_CONFIGS)
def test_fp32_step_equals_the_jax_package_s(model, tmp_path):
    args = B.parse_args(_argv(model, "--dtype", "fp32", "--tile-mode", "uniform"))
    with torch.no_grad():
        step = B.build_step(args, torch.float32, torch.device("cpu"))
        out = step.run().float().numpy()
    if model == "chain":
        # the same seeded u8 image bench.py draws, as the JAX session takes it
        img = (np.random.default_rng(0).random((16, 24, 3)) * 255).astype(np.uint8)
        ref = _jax_chain(tmp_path, img)
        assert out.shape == ref.shape == (1, 64, 96, 3)
        assert _psnr(out, ref, 255.0) >= 80
        return
    ref = _jax_step(model, step.x.numpy())
    assert out.shape == ref.shape
    peak = max(1.0, float(np.abs(ref).max()))
    assert _psnr(out, ref, peak) >= 80
    if model in ("srresnet", "pan", "ppon"):
        assert np.abs(out - ref).max() <= 1e-5 * peak
