"""The port's batched directory path against the JAX package's: run_batch's
three paths (whole-image stack, cross-image tile stack, per image), the
memory gates and auto_batch, the fused chain, process(batch=) and
resolve_batch.  Cases mirror tests/test_pipeline.py's batched-mode tests.

Everything runs fp32 on the CPU on the reference goldens.  Tolerances: u8
outputs within one level of the JAX package's run_batch on the same
images, and within one level of the port's own one-image-at-a-time
outputs (convs and norms act per image; train-mode batch norm takes
per-image statistics; only summation order may differ).
"""
import os
import os.path as osp
import shutil

import cv2
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import innfer_tpu.pipeline as JP
from innfer_tpu.cli import resolve_batch as jax_resolve_batch
from innfer_tpu.pipeline import InferenceSession as JaxSession
from innfer_tpu.pipeline import select_presets as jax_presets
from innfer_tpu_torch import pipeline as P
from innfer_tpu_torch.cli import resolve_batch
from innfer_tpu_torch.pipeline import InferenceSession, select_presets

GOLDENS = osp.join(osp.dirname(__file__), "goldens")


def _imgs(shapes, seeds=None):
    return [np.random.default_rng(s).integers(0, 256, (h, w, 3), dtype=np.uint8)
            for s, (h, w) in zip(seeds or range(len(shapes)), shapes)]


def _close(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype == np.uint8
    assert np.abs(a.astype(int) - b.astype(int)).max() <= 1


def _sessions(name, arch="infer", chop=None, **kw):
    """The port's and the JAX package's fp32 sessions of one golden."""
    out = []
    for make, Session, dt, extra in ((select_presets, InferenceSession, torch.float32,
                                      {"device": "cpu"}),
                                     (jax_presets, JaxSession, jnp.float32, {})):
        presets = make(arch)
        if chop is not None:
            presets.chop = chop
        out.append(Session(osp.join(GOLDENS, name), arch=arch, presets=presets,
                           compute_dtype=dt, **kw, **extra))
    return out


def _check_batch(sess, jsess, imgs, **kw):
    """run_batch: port vs JAX, and port batched vs port per image."""
    outs = sess.run_batch(imgs, **kw)
    for o, j in zip(outs, jsess.run_batch(imgs, **kw)):
        _close(o, j)
    ref = kw.get("use_color_fix", False)
    for o, im in zip(outs, imgs):
        _close(o, sess.run_image(im, color_ref=sess.prepare(im) if ref else None))
    return outs


def _force_tiled(monkeypatch, *sessions):
    for s in sessions:
        monkeypatch.setattr(s, "batchable", lambda shape, n: False)


def _whole_calls(monkeypatch):
    calls = []
    orig = P.Stage.__call__

    def spy(self, x, **kw):
        calls.append((x.shape[0], kw.get("force_whole", False)))
        return orig(self, x, **kw)

    monkeypatch.setattr(P.Stage, "__call__", spy)
    return calls


# ---------------------------------------------------------------------------
# run_batch
# ---------------------------------------------------------------------------

def test_unet_batch_matches_per_image_and_jax(monkeypatch):
    """pix2pix train-mode batch norm over a whole-image stack: per-image
    statistics make each image equal its solo forward."""
    sess, jsess = _sessions("unet128.pth", arch="unet_128")
    calls = _whole_calls(monkeypatch)
    outs = _check_batch(sess, jsess, _imgs([(40, 56), (33, 20)]))  # both -> 128x128
    assert calls[0] == (2, True) and outs[0].shape == (128, 128, 3)


def test_esrgan_batch_matches_per_image_and_jax():
    sess, jsess = _sessions("esrgan_x2.pth", chop=False)
    outs = _check_batch(sess, jsess, _imgs([(24, 20), (24, 20)], seeds=[3, 4]))
    assert outs[0].shape == (48, 40, 3)


def test_wbc_batch_guided_filter_matches_per_image_and_jax():
    sess, jsess = (S(osp.join(GOLDENS, "wbc_pt.pth"), presets=make("infer", "wbc_pt.pth"),
                     compute_dtype=dt, **extra)
                   for make, S, dt, extra in ((select_presets, InferenceSession, torch.float32,
                                               {"device": "cpu"}),
                                              (jax_presets, JaxSession, jnp.float32, {})))
    assert sess.presets.use_guided_filter
    outs = _check_batch(sess, jsess, _imgs([(36, 36), (36, 36)], seeds=[5, 6]))
    assert outs[0].shape == (36, 36, 3)


def test_mixed_shapes_fall_back_per_image(monkeypatch):
    sess, jsess = _sessions("esrgan_x2.pth", tile=16, overlap=8)
    calls = _whole_calls(monkeypatch)
    outs = _check_batch(sess, jsess, _imgs([(24, 20), (16, 16)]))
    assert [o.shape for o in outs] == [(48, 40, 3), (32, 32, 3)]
    assert all(n == 1 and not whole for n, whole in calls)


def test_color_fix_batched_matches_per_image_and_jax():
    sess, jsess = _sessions("esrgan_x2.pth", chop=False)
    _check_batch(sess, jsess, _imgs([(24, 20), (24, 20)], seeds=[8, 9]), use_color_fix=True)


def test_tiled_cyclegan_stack_matches_per_image_and_jax(monkeypatch):
    sess, jsess = _sessions("cyclegan9.pth", arch="resnet_net", tile=24, overlap=8,
                            tile_batch=4)
    assert sess.presets.chop
    _force_tiled(monkeypatch, sess, jsess)
    calls = _whole_calls(monkeypatch)
    _check_batch(sess, jsess, _imgs([(40, 40)] * 3, seeds=[1, 2, 3]))
    assert calls[0] == (3, False)  # the stack went to the tiled runner


def test_tiled_ppon_stack_matches_per_image_and_jax(monkeypatch):
    sess, jsess = _sessions("ppon_x4.pth", tile=16, overlap=8, tile_batch=4)
    _force_tiled(monkeypatch, sess, jsess)
    outs = _check_batch(sess, jsess, _imgs([(24, 24)] * 2, seeds=[4, 5]))
    assert outs[0].shape == (96, 96, 3)


def test_whole_image_stacking_preferred_when_it_fits(monkeypatch):
    """A chopped preset's stack that fits the budget runs whole-image, not
    tiled: one stacked untiled forward (so CycleGAN's instance norm takes
    whole-image statistics, as in the JAX package)."""
    sess, jsess = _sessions("cyclegan9.pth", arch="resnet_net", tile=24, overlap=8,
                            tile_batch=4)
    calls = _whole_calls(monkeypatch)
    imgs = _imgs([(40, 40)] * 2, seeds=[8, 9])
    for o, j in zip(sess.run_batch(imgs), jsess.run_batch(imgs)):
        _close(o, j)
    assert calls == [(2, True)]
    p = select_presets("resnet_net")
    p.chop = False
    whole = InferenceSession(osp.join(GOLDENS, "cyclegan9.pth"), arch="resnet_net",
                             presets=p, compute_dtype=torch.float32, device="cpu")
    for o, im in zip(sess.run_batch(imgs), imgs):
        _close(o, whole.run_image(im))


def test_budget_gates_batchable_as_jax(monkeypatch):
    """batchable / batchable_tiled / auto_batch under the same budget as the
    JAX package's (its TPU budget patched in, its CPU waiver off)."""
    sess, jsess = _sessions("esrgan_x2.pth", tile=16, overlap=8)
    monkeypatch.setattr(JP.jax, "default_backend", lambda: "tpu")
    model = sess.stages[0].model
    for budget in (1024, P._whole_forward_bytes(model, (3, 24, 20, 3)),
                   P._whole_forward_bytes(model, (9, 24, 20, 3)), 2 * 1024 ** 3 + 24 * 48 * 40 * 5,
                   8 * 1024 ** 3):
        monkeypatch.setattr(P, "whole_image_budget", lambda dev, b=budget: b)
        monkeypatch.setattr(JP, "_WHOLE_IMAGE_HBM_BUDGET", budget)
        for n in (1, 2, 3, 4, 8):
            assert sess.batchable((24, 20, 3), n) == jsess.batchable((24, 20, 3), n)
            assert (sess.batchable_tiled((24, 20, 3), n)
                    == jsess.batchable_tiled((24, 20, 3), n))
        assert sess.auto_batch((24, 20, 3)) == jsess.auto_batch((24, 20, 3))
    monkeypatch.setattr(P, "whole_image_budget", lambda dev: 1024)
    assert not sess.batchable((24, 20, 3), 4)
    monkeypatch.setattr(P, "whole_image_budget", lambda dev: None)  # the CPU: no limit
    assert sess.batchable((24, 20, 3), 4) and not sess.batchable((24, 20, 3), 1)


def test_auto_batch_power_of_two_within_budget(monkeypatch):
    sess, jsess = _sessions("unet128.pth", arch="unet_128")
    assert sess.auto_batch((128, 128, 3)) == 32  # the CPU waives the budget
    model = sess.stages[0].model
    monkeypatch.setattr(P, "whole_image_budget",
                        lambda dev: P._whole_forward_bytes(model, (9, 128, 128, 3)))
    monkeypatch.setattr(JP.jax, "default_backend", lambda: "tpu")
    monkeypatch.setattr(JP, "_WHOLE_IMAGE_HBM_BUDGET",
                        P._whole_forward_bytes(model, (9, 128, 128, 3)))
    assert sess.auto_batch((128, 128, 3)) == jsess.auto_batch((128, 128, 3)) == 8
    monkeypatch.setenv("INNFER_MAX_BATCH", "4")
    assert sess.auto_batch((128, 128, 3)) == jsess.auto_batch((128, 128, 3)) == 4


def test_fused_chain_batch_matches_per_image_and_jax(tmp_path, monkeypatch):
    c1 = str(tmp_path / "a_1.pth")
    shutil.copy(osp.join(GOLDENS, "esrgan_x2.pth"), c1)
    models = c1 + "+" + osp.join(GOLDENS, "esrgan_x2.pth")
    kw = dict(tile=16, overlap=8, tile_batch=4, scale=2, fused_chain=True)
    sess = InferenceSession(models, compute_dtype=torch.float32, device="cpu", **kw)
    jsess = JaxSession(models, compute_dtype=jnp.float32, **kw)
    fr, jfr = sess._fused_runner, jsess._fused_runner
    assert (fr.tile, fr.overlap, fr.scale, fr.mode) == (jfr.tile, jfr.overlap, jfr.scale, jfr.mode)
    _force_tiled(monkeypatch, sess, jsess)
    outs = _check_batch(sess, jsess, _imgs([(20, 24)] * 2, seeds=[6, 7]))
    assert outs[0].shape == (80, 96, 3)


def test_fused_chain_refusals_and_tf32(tmp_path, monkeypatch):
    """The JAX package's errors for a guided-filter preset and a
    TorchScript stage; the fused chain's fp32 convs request no TF32."""
    wbc = osp.join(GOLDENS, "wbc_pt.pth")
    with pytest.raises(ValueError, match="guided filter"):
        InferenceSession(wbc + "+" + wbc, arch="wbcunet", compute_dtype=torch.float32,
                         device="cpu", fused_chain=True)
    one = InferenceSession(wbc, arch="wbcunet", device="cpu", fused_chain=True)
    assert one._fused_runner is None  # one model: nothing to fuse
    ts = tmp_path / "2x_ts.pt"
    conv = torch.nn.Sequential(torch.nn.Conv2d(3, 12, 3, padding=1), torch.nn.PixelShuffle(2))
    torch.jit.trace(conv.eval(), torch.rand(1, 3, 8, 8)).save(str(ts))
    esr = osp.join(GOLDENS, "esrgan_x2.pth")
    with pytest.raises(ValueError, match="TorchScript"):
        InferenceSession(f"{esr}+{ts}", device="cpu", fused_chain=True)
    seen = []
    real = torch.nn.functional.conv2d

    def spy(*a, **k):
        seen.append((torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32))
        return real(*a, **k)

    sess = InferenceSession(f"{esr}+{esr}", compute_dtype=torch.float32, device="cpu",
                            tile=16, overlap=8, fused_chain=True)
    monkeypatch.setattr(torch.nn.functional, "conv2d", spy)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    assert sess.run_image(_imgs([(12, 12)])[0]).shape == (48, 48, 3)
    assert seen and all(s == (False, False) for s in seen)


# ---------------------------------------------------------------------------
# process(batch=) and resolve_batch
# ---------------------------------------------------------------------------

def _write_dir(path, shapes):
    path.mkdir()
    for i, (name, (h, w)) in enumerate(shapes.items()):
        img = np.random.default_rng(i).integers(0, 256, (h, w, 3), dtype=np.uint8)
        cv2.imwrite(str(path / f"{name}.png"), img)
    return str(path)


def test_process_batched_directory_with_partial_groups(tmp_path, monkeypatch):
    """Five images in two shape buckets at batch=2: two full groups and a
    leftover of each shape, which run at their natural size (no padding);
    every output within one level of batch=1 and of the JAX package's
    batched run."""
    inp = _write_dir(tmp_path / "in", {"a": (24, 20), "b": (24, 20), "c": (16, 16),
                                       "d": (24, 20), "e": (16, 16)})
    sess, jsess = _sessions("esrgan_x2.pth", chop=False)
    groups = []
    real = sess.run_batch

    def spy(imgs, **kw):
        groups.append(len(imgs))
        return real(imgs, **kw)

    monkeypatch.setattr(sess, "run_batch", spy)
    w2 = sess.process(inp, str(tmp_path / "o2"), verbose=False, batch=2)
    assert sorted(groups) == [1, 2, 2]
    w1 = sess.process(inp, str(tmp_path / "o1"), verbose=False, batch=1)
    jsess.process(inp, str(tmp_path / "oj"), verbose=False, batch=2)
    assert len(w1) == len(w2) == 5 and sorted(groups) == [1, 2, 2]
    for n in "abcde":
        b2 = cv2.imread(str(tmp_path / "o2" / f"{n}.png"))
        _close(b2, cv2.imread(str(tmp_path / "o1" / f"{n}.png")))
        _close(b2, cv2.imread(str(tmp_path / "oj" / f"{n}.png")))


def test_process_auto_batch_tiled_cyclegan_directory(tmp_path, monkeypatch):
    """batch=0 on a CycleGAN directory, the tiled tier forced: one group of
    three, tile-stacked, within one level of batch=1's tiled runs."""
    inp = _write_dir(tmp_path / "in", {f"t{i}": (40, 40) for i in range(3)})
    sess, jsess = _sessions("cyclegan9.pth", arch="resnet_net", tile=24, overlap=8,
                            tile_batch=4)
    _force_tiled(monkeypatch, sess, jsess)
    sess.process(inp, str(tmp_path / "o0"), verbose=False, batch=0)
    sess.process(inp, str(tmp_path / "o1"), verbose=False, batch=1)
    jsess.process(inp, str(tmp_path / "oj"), verbose=False, batch=0)
    for i in range(3):
        b0 = cv2.imread(str(tmp_path / "o0" / f"t{i}.png"))
        _close(b0, cv2.imread(str(tmp_path / "o1" / f"t{i}.png")))
        _close(b0, cv2.imread(str(tmp_path / "oj" / f"t{i}.png")))


_FAMILIES = [("infer", ""), ("esrgan", ""), ("ppon", ""), ("ts", ""), ("unet_128", ""),
             ("unet_256", ""), ("p2p_512", ""), ("resnet_9blocks", ""), ("cg_foo", ""),
             ("wbcunet", ""), ("wbcunet_tf", ""), ("infer", "wbc_x.pth"),
             ("infer", "4x_a.pth+wbc_b.pth")]


@pytest.mark.parametrize("arch,models", _FAMILIES)
def test_resolve_batch_equals_jax(arch, models):
    p, jp = select_presets(arch, models), jax_presets(arch, models)
    assert p.family == jp.family
    for batch in (0, 1, 3, 32):
        assert resolve_batch(batch, p) == jax_resolve_batch(batch, jp)
    assert resolve_batch(0, p) == (0 if p.family in ("pix2pix", "cyclegan", "wbc") else 1)


def test_encode_threads_inline_and_pooled_identical(tmp_path, monkeypatch):
    inp = _write_dir(tmp_path / "in", {f"p{i}": (20, 24) for i in range(3)})
    sess = InferenceSession(osp.join(GOLDENS, "esrgan_x2.pth"), compute_dtype=torch.float32,
                            device="cpu", tile=16, overlap=8)
    pools = []
    real = P.ThreadPoolExecutor

    def spy(*a, **kw):
        pools.append(kw.get("thread_name_prefix"))
        return real(*a, **kw)

    monkeypatch.setattr(P, "ThreadPoolExecutor", spy)
    monkeypatch.setenv("INNFER_ENCODE_THREADS", "0")
    w0 = sess.process(inp, str(tmp_path / "o0"), verbose=False)
    # 0: no encode pool, encodes inline (decodes run on runtime/native's
    # prefetch loader, which the session does not build from this pool)
    assert pools == []
    monkeypatch.setenv("INNFER_ENCODE_THREADS", "2")
    w2 = sess.process(inp, str(tmp_path / "o2"), verbose=False)
    assert pools == ["innfer-encode"]
    assert len(w0) == len(w2) == 3
    for i in range(3):
        np.testing.assert_array_equal(cv2.imread(str(tmp_path / "o0" / f"p{i}.png")),
                                      cv2.imread(str(tmp_path / "o2" / f"p{i}.png")))
    assert os.path.basename(w0[0]) == "p0.png"
