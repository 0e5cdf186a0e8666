"""The port's stage timers, profiler trace, metrics, image sharding and the
image reader's DNG branch, against the JAX package's.

Tolerances: psnr/ssim/psnr_np/ssim_np against ``innfer_tpu.metrics`` on the
same seeded inputs within 1e-5 (absolute; PSNR in dB relative to its
value); ``shard_paths`` equal; timer counts exact.
"""
import json
import logging
import os
import sys
import threading
import types

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from innfer_tpu import metrics as JM
from innfer_tpu.io import images as jio
from innfer_tpu.observability import StageTimers as JaxTimers
from innfer_tpu.parallel.multihost import shard_paths as jax_shard_paths
from innfer_tpu_torch import metrics as TM
from innfer_tpu_torch.io import images as iio
from innfer_tpu_torch.observability import TRACE_FILE, StageTimers, profile_trace
from innfer_tpu_torch.parallel.multihost import shard_paths


def _pair(seed, shape=(37, 45, 3), noise=9):
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 256, shape, dtype=np.uint8)
    b = np.clip(a.astype(int) + rng.integers(-noise, noise + 1, shape), 0, 255).astype(np.uint8)
    return a, b


@pytest.mark.parametrize("seed,shape", [(0, (37, 45, 3)), (1, (20, 33)), (2, (64, 48, 3))])
def test_host_metrics_match_jax(seed, shape):
    a, b = _pair(seed, shape)
    assert TM.psnr_np(a, b) == pytest.approx(JM.psnr_np(a, b), rel=1e-5)
    assert TM.psnr_np(a, a) == JM.psnr_np(a, a) == float("inf")
    af, bf = a.astype(np.float32) / 255, b.astype(np.float32) / 255
    assert abs(TM.ssim_np(af, bf) - JM.ssim_np(af, bf)) <= 1e-5
    assert TM.ssim_np(af, af) == pytest.approx(1.0, abs=1e-9)


@pytest.mark.parametrize("seed", [3, 4])
def test_device_metrics_match_jax(seed):
    a, b = (x.astype(np.float32) / 255 for x in _pair(seed, (2, 30, 26, 3), noise=20))
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    assert float(TM.psnr(ta, tb)) == pytest.approx(float(JM.psnr(ja, jb)), rel=1e-5)
    assert abs(float(TM.ssim(ta, tb)) - float(JM.ssim(ja, jb))) <= 1e-5
    # an HWC image is one image
    assert abs(float(TM.ssim(ta[0], tb[0])) - float(JM.ssim(ja[0], jb[0]))) <= 1e-5


def test_ssim_np_needs_no_opencv(monkeypatch):
    """The JAX package's ssim_np imports cv2; the port's runs without it."""
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(ImportError):
        import cv2  # noqa: F401
    a, b = (x.astype(np.float32) / 255 for x in _pair(5))
    assert 0.5 < TM.ssim_np(a, b) < 1.0


def test_device_ssim_requests_no_tf32(monkeypatch):
    seen = []
    real = torch.nn.functional.conv2d

    def spy(*a, **kw):
        seen.append((torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32))
        return real(*a, **kw)

    monkeypatch.setattr(torch.nn.functional, "conv2d", spy)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    a, b = (torch.from_numpy(x.astype(np.float32) / 255) for x in _pair(6))
    TM.ssim(a, b)
    assert len(seen) == 5 and all(s == (False, False) for s in seen)


@pytest.mark.parametrize("n,shards", [(0, 3), (1, 1), (7, 1), (7, 3), (10, 4), (5, 5)])
def test_shard_paths_equal_jax(n, shards):
    paths = [f"img_{i:03d}.png" for i in range(n)]
    parts = [shard_paths(paths, i, shards) for i in range(shards)]
    assert parts == [jax_shard_paths(paths, i, shards) for i in range(shards)]
    assert sorted(sum(parts, [])) == paths


def test_shard_paths_rejects_a_bad_index():
    for bad in (-1, 3):
        with pytest.raises(ValueError, match="shard_index"):
            shard_paths(["a", "b"], bad, 3)
        with pytest.raises(ValueError, match="shard_index"):
            jax_shard_paths(["a", "b"], bad, 3)


def test_stage_timers_count_under_threads():
    """Eight threads time 200 stages each, with a short switch interval:
    no count or total is lost (the lock), and the report's fields are the
    JAX package's."""
    timers = StageTimers()
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work(k):
            for _ in range(200):
                with timers.stage(f"s{k % 2}"):
                    pass
        threads = [threading.Thread(target=work, args=(k,)) for k in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    rep = timers.report()
    assert {k: v["count"] for k, v in rep.items()} == {"s0": 800, "s1": 800}
    jt = JaxTimers()
    with jt.stage("s0"):
        pass
    assert set(rep["s0"]) == set(jt.report()["s0"]) == {"total_s", "count", "mean_ms"}


def test_stage_timers_log_report_format(caplog):
    timers = StageTimers()
    with timers.stage("encode"):
        pass
    with pytest.raises(RuntimeError):
        with timers.stage("encode"):
            raise RuntimeError("a failed stage is timed too")
    with caplog.at_level(logging.INFO, logger="innfer_tpu_torch"):
        timers.log_report()
    msgs = [r.getMessage() for r in caplog.records]
    assert len(msgs) == 1 and msgs[0].startswith("stage encode")
    assert "n=2" in msgs[0] and "total=" in msgs[0] and "mean=" in msgs[0]


def test_profile_trace_writes_a_chrome_trace(tmp_path):
    with profile_trace(""):
        pass  # falsy: a no-op
    d = tmp_path / "prof"
    with profile_trace(str(d)):
        torch.ones(8).sum()
    trace = json.loads((d / TRACE_FILE).read_text())
    assert trace["traceEvents"]


@pytest.mark.parametrize("name,want", [("int64", 9223372036854775807),
                                       ("uint64", 18446744073709551615)])
def test_max_values_by_dtype_equal_jax(name, want):
    assert iio.MAX_VALUES_BY_DTYPE[np.dtype(name)] == want
    assert iio.MAX_VALUES_BY_DTYPE == jio.MAX_VALUES_BY_DTYPE


def test_dng_reads_through_rawpy(monkeypatch, tmp_path):
    """With rawpy installed a .dng decodes through ``postprocess()``, as the
    reference and the JAX package read it; other files do not touch it."""
    raw = np.random.default_rng(7).integers(0, 65535, (6, 8, 3), dtype=np.uint16)
    opened = []

    class Raw:
        def __init__(self, path):
            opened.append(path)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

        def postprocess(self):
            return raw

    stand_in = types.SimpleNamespace(imread=Raw)
    monkeypatch.setattr(iio, "rawpy", stand_in)
    path = str(tmp_path / "shot.DNG")
    assert iio.read_img(path) is raw
    monkeypatch.setattr(jio, "_RAWPY", True)
    monkeypatch.setattr(jio, "rawpy", stand_in, raising=False)
    assert jio.read_img(path) is raw
    assert opened == [path, path]
    png = str(tmp_path / "x.png")
    img = raw[..., 0].astype(np.uint8)
    iio.save_img(img, png)
    assert np.array_equal(iio.read_img(png), img) and len(opened) == 2
    # without rawpy a DNG goes to the codec, as in the JAX package
    monkeypatch.setattr(iio, "rawpy", None)
    monkeypatch.setattr(iio, "cv2", None)
    with pytest.raises(ValueError, match="PNG only"):
        iio.read_img(path)
    assert os.path.basename(path) not in os.listdir(tmp_path)
