"""Cross-image tile stacking and the reference tile mode of the port's
engine against the JAX package's, and the CLI's batched-path flags
(--batch, --timing, --profile, --metrics, --tile-mode reference,
--shard-index/--num-shards, --fused-chain).

Tolerances: the engine in fp32 on the CPU, port against JAX on the same
stack >= 80 dB (the JAX suite's bar), a stack against the port's own
per-image runs within 1e-5 of the peak (the same tiles, in other groups);
the reference mode against the chop_esrgan_x2 golden >= 80 dB; CLI
outputs u8 within one level of the JAX CLI's.
"""
import json
import logging
import os
import os.path as osp

import cv2
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from innfer_tpu.checkpoint.torch_pickle import load_checkpoint as jax_load
from innfer_tpu.cli import main as jax_cli
from innfer_tpu.config.defaults import get_network_config as jax_config
from innfer_tpu.loader import load_model_from_state as jax_load_from_state
from innfer_tpu.metrics import psnr_np as jax_psnr_np
from innfer_tpu.metrics import ssim_np as jax_ssim_np
from innfer_tpu.tiling import engine as JE
from innfer_tpu_torch import cli as torch_cli
from innfer_tpu_torch.checkpoint.detect import load_checkpoint
from innfer_tpu_torch.loader import load_model_from_state
from innfer_tpu_torch.models import get_network, params_from_jax
from innfer_tpu_torch.observability import TRACE_FILE
from innfer_tpu_torch.tiling import engine as TE
from tools import synth_params as SP

GOLDENS = osp.join(osp.dirname(__file__), "goldens")


def psnr(a, b, peak=None):
    peak = max(1.0, float(np.abs(b).max())) if peak is None else peak
    mse = np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2)
    return np.inf if mse == 0 else 10 * np.log10(peak ** 2 / mse)


def _models():
    spec = {"type": "esrgan", "nb": 1, "nf": 16, "gc": 8}
    state = SP.esrgan_state(nb=1, nf=16, gc=8, scale=2, seed=8)
    jm, jp = jax_load_from_state(state, jax_config(spec, 2))
    tm = get_network(jax_config(spec, 2))
    return jm, jp, tm, params_from_jax({k: np.asarray(v) for k, v in jp.items()})


def _spy(fn, sizes):
    def run(params, x):
        sizes.append(int(x.shape[0]))
        return fn(params, x)
    return run


@pytest.mark.parametrize("mode,kw,n_im,want_chunk", [
    ("uniform", dict(tile=16, overlap=8), 3, 72),          # 24 tiles per image, one group
    ("uniform", dict(tile=16, overlap=8, max_group_px=16 * 16 * 12), 3, 8),  # 12 -> 8
    ("uniform", dict(tile=16, overlap=8, max_group_px=16 * 16 * 6), 2, 6),   # under 8: kept
    ("auto", dict(overlap=8), 3, 3),                       # one tile per image
])
def test_tiled_stack_matches_per_image_and_jax(mode, kw, n_im, want_chunk):
    """Tiles of every image share dispatch groups grown toward
    max_group_px (cut to a multiple of 8 above 8), the JAX package's group
    composition: the same chunk, the same stacked output (>= 80 dB), and
    each image equal to its own solo run."""
    jm, jp, tm, tp = _models()
    x = np.random.default_rng(9).random((n_im, 40, 52, 3), np.float32)
    j_sizes, t_sizes = [], []
    jr = JE.TiledRunner(_spy(jm.apply, j_sizes), 2, mode=mode, tile_batch=4, **kw)
    tr = TE.TiledRunner(_spy(tm.apply, t_sizes), 2, mode=mode, tile_batch=4, **kw)
    ref = np.asarray(jr(jp, jnp.asarray(x)))
    with torch.no_grad():
        out = tr(tp, torch.from_numpy(x)).numpy()
        solo = [tr(tp, torch.from_numpy(x[i: i + 1])).numpy() for i in range(n_im)]
    plan = tr.plan_for(40, 52)
    n = plan.n_tiles * n_im
    assert t_sizes[0] == j_sizes[0] == want_chunk
    assert TE.group_chunk(plan, n_im, tile_batch=4,
                          max_group_px=kw.get("max_group_px", TE.MAX_GROUP_PX)) == want_chunk
    assert sum(t_sizes[: -(-n // want_chunk)]) == n  # the last group at its natural size
    assert out.shape == ref.shape == (n_im, 80, 104, 3)
    assert psnr(out, ref) >= 80
    peak = np.abs(out).max()
    for i in range(n_im):
        assert np.abs(out[i] - solo[i][0]).max() <= 1e-5 * peak


def test_hybrid_stack_runs_one_image_at_a_time():
    jm, jp, tm, tp = _models()
    x = torch.from_numpy(np.random.default_rng(10).random((2, 24, 30, 3), np.float32))
    trunk = []
    r = TE.TiledRunner(tm.apply, 2, mode="hybrid", tile=(48, 48),
                       trunk_fn=_spy(tm.apply_trunk, trunk), tail_fn=tm.apply_tail,
                       tail_halo=tm.tail_halo)
    with torch.no_grad():
        out = r(tp, x)
        solo = r(tp, x[1:])
    assert trunk == [1, 1, 1] and out.shape == (2, 48, 60, 3)
    assert torch.equal(out[1:], solo)


def _chop_golden():
    fx = np.load(osp.join(GOLDENS, "chop_esrgan_x2.npz"))
    meta = json.loads(str(fx["meta"]))
    return fx, meta, osp.join(GOLDENS, "chop_esrgan_x2.pth")


def test_reference_mode_matches_torch_chop_golden():
    """The reference chop grid (patch 16, step 0.5) against the original
    iNNfer's chop output: >= 80 dB, as the JAX package holds its own
    (tests/test_tiling.py::test_reference_mode_matches_torch_chop)."""
    fx, meta, path = _chop_golden()
    model, params = load_model_from_state(load_checkpoint(path), dict(meta["cfg"]),
                                          device="cpu")
    runner = TE.TiledRunner(model.apply, model.scale, mode="reference",
                            patch=meta["patch"], step=meta["step"], tile_batch=4)
    x = torch.from_numpy(np.transpose(fx["input"], (0, 2, 3, 1)))
    with torch.no_grad():
        out = runner(params, x).permute(0, 3, 1, 2).numpy()
    assert runner.last_mode == "reference"
    assert psnr(out, fx["output"]) >= 80
    jm, jp = jax_load_from_state(jax_load(path), dict(meta["cfg"]))
    jr = JE.TiledRunner(jm.apply, jm.scale, mode="reference", patch=meta["patch"],
                        step=meta["step"], tile_batch=4)
    ref = np.transpose(np.asarray(jr(jp, jnp.asarray(fx["input"].transpose(0, 2, 3, 1)))),
                       (0, 3, 1, 2))
    assert psnr(out, ref) >= 80


def test_reference_mode_stacks_images():
    fx, meta, path = _chop_golden()
    model, params = load_model_from_state(load_checkpoint(path), dict(meta["cfg"]),
                                          device="cpu")
    runner = TE.TiledRunner(model.apply, model.scale, mode="reference",
                            patch=meta["patch"], step=meta["step"], tile_batch=4)
    x = torch.from_numpy(np.transpose(fx["input"], (0, 2, 3, 1)))
    with torch.no_grad():
        stack = runner(params, torch.cat([x, x.flip(2)]))
        solo = runner(params, x.flip(2))
    assert psnr(stack[1].numpy(), solo[0].numpy()) >= 120


# ---------------------------------------------------------------------------
# The CLI
# ---------------------------------------------------------------------------

def _in_dir(tmp_path, shapes):
    d = tmp_path / "in"
    d.mkdir()
    for i, (name, (h, w)) in enumerate(shapes.items()):
        img = np.random.default_rng(20 + i).integers(0, 256, (h, w, 3), dtype=np.uint8)
        cv2.imwrite(str(d / f"{name}.png"), img)
    return str(d)


def _same_dirs(a, b, names):
    for n in names:
        x = cv2.imread(osp.join(a, f"{n}.png"))
        y = cv2.imread(osp.join(b, f"{n}.png"))
        assert x is not None and y is not None and x.shape == y.shape
        assert np.abs(x.astype(int) - y.astype(int)).max() <= 1


@pytest.mark.parametrize("flags", [
    ["--tile-mode", "none", "--batch", "2"],
    ["--tile-mode", "reference"],
    ["--tile", "16", "--overlap", "8", "--batch", "3"],
])
def test_cli_matches_jax_cli(tmp_path, flags):
    inp = _in_dir(tmp_path, {"x": (20, 28), "y": (20, 28), "z": (24, 32)})
    common = ["-m", osp.join(GOLDENS, "esrgan_x2.pth"), "-i", inp, *flags]
    assert jax_cli(common + ["-o", str(tmp_path / "jax"), "-no_fp16", "-cpu"]) == 0
    assert torch_cli.main(common + ["-o", str(tmp_path / "port"), "-cpu"]) == 0
    _same_dirs(str(tmp_path / "jax"), str(tmp_path / "port"), "xyz")
    assert cv2.imread(str(tmp_path / "port" / "z.png")).shape == (48, 64, 3)


def test_cli_timing_profile_and_shards(tmp_path, caplog):
    inp = _in_dir(tmp_path, {f"i{k}": (20, 28) for k in range(3)})
    base = ["-m", osp.join(GOLDENS, "unet128.pth"), "-a", "unet_128", "-i", inp, "-cpu"]
    with caplog.at_level(logging.INFO, logger="innfer_tpu_torch"):
        assert torch_cli.main(base + ["-o", str(tmp_path / "o"), "--timing",
                                      "--profile", str(tmp_path / "prof")]) == 0
    stages = {r.getMessage().split()[1] for r in caplog.records
              if r.getMessage().startswith("stage ")}
    # pix2pix auto-batches by default: one group, no per-image stage
    assert stages == {"read", "batch", "fetch", "encode"}
    assert json.loads((tmp_path / "prof" / TRACE_FILE).read_text())["traceEvents"]
    for k in range(3):
        assert cv2.imread(str(tmp_path / "o" / f"i{k}.png")).shape == (128, 128, 3)
    for shard in (0, 1):
        out = tmp_path / f"s{shard}"
        assert torch_cli.main(base + ["-o", str(out), "--batch", "1", "--shard-index",
                                      str(shard), "--num-shards", "2"]) == 0
        assert sorted(os.listdir(out)) == [f"i{k}.png" for k in range(shard, 3, 2)]
        _same_dirs(str(tmp_path / "o"), str(out), [f"i{k}" for k in range(shard, 3, 2)])


def test_cli_metrics_rows_equal_jax_metrics(tmp_path, capsys):
    inp = _in_dir(tmp_path, {"m0": (20, 28), "m1": (20, 28)})
    model = osp.join(GOLDENS, "esrgan_x2.pth")
    assert jax_cli(["-m", model, "-i", inp, "-o", str(tmp_path / "gt"), "--tile-mode",
                    "none", "-no_fp16", "-cpu"]) == 0
    capsys.readouterr()
    assert torch_cli.main(["-m", model, "-i", inp, "-o", str(tmp_path / "o"), "--tile", "16",
                           "--overlap", "8", "--metrics", str(tmp_path / "gt"), "-cpu"]) == 0
    lines = [ln.split() for ln in capsys.readouterr().out.splitlines()
             if ln.strip().startswith("metrics m") and "mean" not in ln]
    assert len(lines) == 2
    for ln in lines:
        name = ln[1].rstrip(":")
        out = cv2.imread(str(tmp_path / "o" / f"{name}.png"))
        gt = cv2.imread(str(tmp_path / "gt" / f"{name}.png"))
        assert float(ln[3]) == round(jax_psnr_np(out, gt), 3)
        assert float(ln[6]) == round(jax_ssim_np(out.astype(np.float32) / 255,
                                                 gt.astype(np.float32) / 255), 4)
        assert 30 < float(ln[3]) < np.inf  # tiled vs whole image: seams differ a little


def test_cli_fused_chain(tmp_path):
    inp = _in_dir(tmp_path, {"f": (16, 20)})
    model = osp.join(GOLDENS, "esrgan_x2.pth")
    common = ["-m", f"{model}+{model}", "-i", inp, "--fused-chain", "--tile", "16",
              "--overlap", "8"]
    assert jax_cli(common + ["-o", str(tmp_path / "jax"), "-no_fp16", "-cpu"]) == 0
    assert torch_cli.main(common + ["-o", str(tmp_path / "port"), "--no-fused-chain",
                                    "-cpu"]) == 0
    _same_dirs(str(tmp_path / "jax"), str(tmp_path / "port"), ["f"])
