"""Each plain reference at a tiny width against the program's plain path on
the CPU, in fp32, through the program's own session and tiling: the
reference imports nothing of the program, so agreement here means it cuts
the image as the program does.  Every configuration of BENCHMARK.json runs
the cases of its architecture's tiny cut (``tests/tiny/arch/<arch>.json``)."""
import os.path as osp

import numpy as np
import pytest
import torch

from innbench import harness, traffic as T
from innbench.reference import plan as P, resnet_generator as G

from .conftest import BENCH, ROOT, config, reference_cases, tiny

CASES = reference_cases(BENCH)


def _cfg(name):
    cfg = config(ROOT, BENCH, name)
    cfg["model"].update(tiny(ROOT, "arch", cfg["arch"])["model"])
    return cfg


def _ref(cfg):
    arch = cfg["arch"]
    return harness.load_module(osp.join(ROOT, "innbench", "reference", arch + ".py"),
                               "innbench_reference_" + arch)


def _session(tmp_path, cfg, ref_mod, seed=3):
    from innfer_tpu_torch.pipeline import InferenceSession, select_presets

    state = ref_mod.make_state(cfg["model"], seed, "cpu")
    path = str(tmp_path / cfg["checkpoint"])
    torch.save(state, path)
    s = cfg["session"]
    sess = InferenceSession(path, arch=s["arch"], presets=select_presets(s["arch"], path),
                            compute_dtype=torch.float32, tile=s["tile"], overlap=s["overlap"],
                            tile_mode=s["tile_mode"], tile_batch=s["tile_batch"], device="cpu")
    return sess, state


def _img(h, w, i=0):
    return T.images(h, w, [i], 12, T.generator(11, "cpu"), "cpu")[0]


def _close(a, b):
    d = np.abs(a.astype(int) - b.astype(int))
    assert a.shape == b.shape
    assert d.max() <= 1 and (d > 0).mean() < 1e-3, (d.max(), (d > 0).mean())


@pytest.mark.parametrize("name,h,w,card", CASES,
                         ids=[f"{c}-{h}x{w}" + ("-card" if card else "") for c, h, w, card in CASES])
def test_reference_matches_the_program(tmp_path, monkeypatch, name, h, w, card):
    """``card``: the runner's mode forced as on the card (for ESRGAN the
    whole-image trunk on the padded canvas and the tiled tail)."""
    from innfer_tpu_torch.tiling.engine import TiledRunner

    cfg = _cfg(name)
    ref = _ref(cfg)
    sess, state = _session(tmp_path, cfg, ref)
    if card:
        orig = TiledRunner.mode_for
        monkeypatch.setattr(TiledRunner, "mode_for",
                            lambda self, h, w, on_cuda: orig(self, h, w, True))
    rgb = _img(h, w)
    with torch.no_grad():
        got = sess.run_image(np.ascontiguousarray(rgb[..., ::-1]))[..., ::-1]
    mode, cpu_mode = (ref.modes(cfg["model"], cfg["session"], [(h, w)], on_cuda=c,
                                budget=None)[0] for c in (card, False))
    assert sess.stages[0].runner.last_mode == mode
    assert card is (mode != cpu_mode)   # a card case runs a mode the CPU does not take
    _close(got, ref.infer(state, rgb, model=cfg["model"], session=cfg["session"], mode=mode))


def test_resnet_generator_tile_grid():
    """Instance norm takes its statistics per tile: the whole image differs
    from the tile grid's, so the reference has to cut as the program does."""
    cfg = _cfg("cyclegan_r9")
    state = G.make_state(cfg["model"], 3, "cpu")
    rgb = _img(90, 300)
    tiled, whole = (G.infer(state, rgb, model=cfg["model"], session=cfg["session"], mode=m)
                    for m in ("auto", "whole"))
    assert np.abs(whole.astype(int) - tiled.astype(int)).max() > 1


def test_resnet_generator_directory_groups(tmp_path):
    """process() with batch=0 and a budget: same-shape groups that fit run
    whole-image stacks, a lone image runs on the tile grid."""
    from innfer_tpu_torch import pipeline
    from innfer_tpu_torch.io import images as iio

    cfg = _cfg("cyclegan_r9")
    sess, state = _session(tmp_path, cfg, G)
    shapes = [(40, 72), (40, 72), (72, 40), (40, 72)]
    ind, outd = tmp_path / "in", tmp_path / "out"
    ind.mkdir()
    imgs = [_img(h, w, i) for i, (h, w) in enumerate(shapes)]
    for i, im in enumerate(imgs):
        iio.save_img(np.ascontiguousarray(im[..., ::-1]), str(ind / f"{i}.png"))
    budget = 4 * 40 * 72 * G.whole_bytes_per_px(cfg["model"])   # a stack of 4 fits
    orig = pipeline.whole_image_budget
    pipeline.whole_image_budget = lambda device: budget
    try:
        with torch.no_grad():
            sess.process(str(ind), str(outd), verbose=False, batch=0)
    finally:
        pipeline.whole_image_budget = orig
    modes = G.modes(cfg["model"], cfg["session"], shapes, on_cuda=False, budget=budget)
    assert modes == ["whole", "whole", "auto", "whole"]
    for i, (im, mode) in enumerate(zip(imgs, modes)):
        got = iio.read_img(str(outd / f"{i}.png"))[..., ::-1]
        _close(got, G.infer(state, im, model=cfg["model"], session=cfg["session"], mode=mode))


def test_plan_copy_matches_the_program():
    from innfer_tpu_torch.tiling import engine, plan

    for h, w in [(540, 960), (1080, 1920), (1920, 1080), (720, 1280), (37, 300)]:
        a = plan.make_auto_plan(h, w, 1, overlap=16, tile_batch=8)
        b = P.auto_plan(h, w, overlap=16, tile_batch=8)
        assert (a.pad_h, a.pad_w, a.tile_h, a.tile_w, a.starts_h, a.starts_w) == \
            (b.pad_h, b.pad_w, b.tile_h, b.tile_w, b.starts_h, b.starts_w)
        np.testing.assert_allclose(a.blend, P.blend(b, 1), rtol=1e-6)
        assert engine.hybrid_dims(h, w) == P.hybrid_dims(h, w)
        r = engine.TiledRunner(lambda p, x: x, 4, mode="auto", tail_halo=4,
                               trunk_fn=lambda p, x: x, tail_fn=lambda p, x: x)
        c, d = r._hybrid_plan(h, w), P.hybrid_tail_plan(h, w, tile=256, tail_halo=4)
        assert (c.tile_h, c.tile_w, c.starts_h, c.starts_w) == \
            (d.tile_h, d.tile_w, d.starts_h, d.starts_w)
        np.testing.assert_allclose(c.blend, P.blend(d, 4), rtol=1e-6)
