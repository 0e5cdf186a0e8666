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


# -- the tracer: spans and counters inside the program ----------------------

GOLDENS = os.path.join(os.path.dirname(__file__), "goldens")
# the tabled span tree of one frame: span -> its parent (the frame is a root)
FRAME_TREE = {"innfer.frame": None, "innfer.upload": "innfer.frame",
              "innfer.tiling": "innfer.frame", "innfer.trunk": "innfer.tiling",
              "innfer.tile_group": "innfer.tiling", "innfer.postprocess": "innfer.frame",
              "innfer.fetch": "innfer.frame"}


@pytest.fixture
def tracer():
    from innfer_tpu_torch import observability as obs
    obs.reset()
    yield obs
    obs.reset()


def _session(kind):
    from innfer_tpu_torch.pipeline import InferenceSession
    if kind == "rrdb_hybrid":
        return InferenceSession(os.path.join(GOLDENS, "esrgan_x2.pth"), device="cpu",
                                compute_dtype=torch.float32, tile_mode="hybrid", tile=24,
                                overlap=8), (30, 44)
    return InferenceSession(os.path.join(GOLDENS, "cyclegan9.pth"), arch="resnet_net",
                            device="cpu", compute_dtype=torch.float32, tile_mode="auto",
                            tile=24, overlap=8), (40, 56)


def _image(hw, seed=0):
    return np.random.default_rng(seed).integers(0, 256, hw + (3,), dtype=np.uint8)


def test_tracing_is_off_outside_a_profiler(tracer):
    sess, hw = _session("rrdb_hybrid")
    sess.run_image(_image(hw))
    with tracer.span("innfer.frame", torch.device("cpu"), root=True):
        tracer.count("tile_px", 5)
    assert tracer.TRACER.records == [] and dict(tracer.TRACER.counters) == {}
    assert tracer.summary() == {"spans": {}, "counters": {}}


@pytest.mark.parametrize("kind", ["rrdb_hybrid", "resnet_auto"])
def test_frame_spans_form_the_tabled_tree(tracer, kind):
    """Under a CPU profiler: each frame's spans form the tabled tree (no
    download: a CPU output needs no copy), share the frame's request id, lie
    on the profiler's timeline, and the counters equal the plan's pixels,
    the tail's convs and the generator's norms; the output is bitwise the
    untraced one."""
    sess, hw = _session(kind)
    imgs = [_image(hw, s) for s in (1, 2)]
    plain = [sess.run_image(im) for im in imgs]
    with torch.profiler.profile() as prof:
        traced = [sess.run_image(im) for im in imgs]
    for a, b in zip(plain, traced):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    runner = sess.stages[0].runner
    assert runner.last_mode == ("hybrid" if kind == "rrdb_hybrid" else "auto")
    plan = runner.plan_for(*hw)
    want = dict(FRAME_TREE)
    if kind != "rrdb_hybrid":
        del want["innfer.trunk"]
    recs = tracer.TRACER.records
    frames = [r for r in recs if r.name == "innfer.frame"]
    assert len(frames) == 2 and len({f.request for f in frames}) == 2
    groups = -(-plan.n_tiles // (plan.chunk or min(8, plan.n_tiles)))
    for f in frames:
        mine = [r for r in recs if r.request == f.request]
        assert {r.name for r in mine} == set(want)
        assert all((r.parent.name if r.parent else None) == want[r.name] for r in mine)
        assert all(r.t0 <= r.t1 and (r.parent is None or r.parent.t0 <= r.t0 <= r.t1
                                     <= r.parent.t1) for r in mine)
        assert sum(r.name == "innfer.tile_group" for r in mine) == groups
        assert all(r.events is None for r in mine)
    names = {e.name() for e in prof.profiler.kineto_results.events()}
    assert set(want) <= names
    s = tracer.summary()
    counters = {"tile_px": 2 * plan.n_tiles * plan.tile_h * plan.tile_w,
                "tiled_px": 2 * hw[0] * hw[1]}
    if kind == "rrdb_hybrid":  # the x2 phase tail's three convs a group, none fused on the CPU
        counters["tail_convs"] = 2 * groups * 3
    else:  # the generator's five instance norms a group, none fused on the CPU
        counters["norms"] = 2 * groups * 5
    assert s["counters"] == counters
    assert s["spans"]["innfer.frame"]["count"] == 2
    assert all(row["device_ms"] is None and row["host_ms"] >= 0 for row in s["spans"].values())


class _Event:
    """A stand-in timing event at device time ``t`` (ms)."""

    def __init__(self, t):
        self.t = t

    def synchronize(self):
        pass

    def elapsed_time(self, other):
        return other.t - self.t


def test_summary_self_time_arithmetic():
    from innfer_tpu_torch.observability import SpanRecord, span_table

    def rec(name, parent, t0, t1, dev=None):
        r = SpanRecord(name, 1, parent, t0 * 1_000_000,
                       None if dev is None else (_Event(dev[0]), _Event(dev[1])))
        r.t1 = t1 * 1_000_000
        return r

    out = []
    for k in range(2):
        o = 1000 * k
        frame = rec("frame", None, o, o + 100, (o, o + 100))
        tiling = rec("tiling", frame, o + 5, o + 90, (o + 10, o + 90))
        out += [frame, rec("upload", frame, o, o + 5), tiling,
                rec("trunk", tiling, o + 20, o + 60, (o + 20, o + 60)),
                rec("group", tiling, o + 60, o + 85, (o + 60, o + 85))]
    out.append(SpanRecord("frame", 2, None, 0, (_Event(0), _Event(9))))   # still open
    t = span_table(out)
    assert t["frame"] == {"count": 2, "host_ms": 200.0, "device_ms": 200.0,
                          "device_self_ms": 40.0}
    assert t["tiling"] == {"count": 2, "host_ms": 170.0, "device_ms": 160.0,
                           "device_self_ms": 30.0}
    assert t["trunk"]["device_self_ms"] == t["trunk"]["device_ms"] == 80.0
    assert t["upload"] == {"count": 2, "host_ms": 10.0, "device_ms": None,
                           "device_self_ms": None}


READERS = ("trunk_ms.frames", "tile_groups_ms.frames", "tiling_self_ms.frames",
           "frame_io_ms.frames", "enqueue_ms.frames", "tile_px_ratio.frames",
           "tail_fused_share.frames")


def _reader(name):
    from innbench.harness import load_module
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    return load_module(os.path.join(root, "innbench", "metrics", name + ".py"),
                       "test_reader_" + name.replace(".", "_"))


@pytest.mark.parametrize("name", READERS)
def test_span_readers(tracer, monkeypatch, name):
    """None without the tracer (an older program) and before any frame;
    on the CPU a counter ratio but no ms; on device timings the tabled
    arithmetic per frame."""
    read = _reader(name).read
    ctx = types.SimpleNamespace()
    assert read(ctx) is None
    with monkeypatch.context() as m:
        m.delattr(tracer, "summary")
        assert read(ctx) is None
    sess, hw = _session("rrdb_hybrid")
    with torch.profiler.profile():
        sess.run_image(_image(hw))
    got = read(ctx)
    if name == "tile_px_ratio.frames":
        plan = sess.stages[0].runner.plan_for(*hw)
        assert got == pytest.approx(plan.n_tiles * plan.tile_h * plan.tile_w / (hw[0] * hw[1]),
                                    rel=1e-12)
    elif name == "tail_fused_share.frames":
        assert got == 0.0  # the CPU counts the tail's convs and fuses none
    else:
        assert got is None

    def row(host, dev, self_dev):
        return {"count": 4, "host_ms": host, "device_ms": dev, "device_self_ms": self_dev}

    fake = {"spans": {"innfer.frame": row(400.0, 360.0, 8.0),
                      "innfer.upload": row(20.0, 12.0, 12.0),
                      "innfer.tiling": row(300.0, 320.0, 16.0),
                      "innfer.trunk": row(100.0, 240.0, 240.0),
                      "innfer.tile_group": row(80.0, 64.0, 64.0),
                      "innfer.postprocess": row(4.0, 8.0, 8.0),
                      "innfer.download": row(2.0, 4.0, 4.0),
                      "innfer.fetch": row(60.0, None, None)},
            "counters": {"tile_px": 9, "tiled_px": 6, "tail_convs": 8, "tail_convs_fused": 6}}
    monkeypatch.setattr(tracer, "summary", lambda: fake)
    assert read(ctx) == {"trunk_ms.frames": 60.0, "tile_groups_ms.frames": 16.0,
                         "tiling_self_ms.frames": 4.0, "frame_io_ms.frames": 6.0,
                         "enqueue_ms.frames": 85.0, "tile_px_ratio.frames": 1.5,
                         "tail_fused_share.frames": 0.75}[name]


def test_directory_spans_carry_each_images_request(tracer, tmp_path, monkeypatch):
    """process() under a profiler, two encode threads, six images (so the
    in-flight bound waits): every stage is a span; each image's ``image``,
    ``fetch`` and ``encode`` spans share its request id, the frame inside
    ``image`` too; a group's ``batch`` span lists its images' ids."""
    import cv2
    monkeypatch.setenv("INNFER_ENCODE_THREADS", "2")
    d = tmp_path / "in"
    d.mkdir()
    for i in range(6):
        cv2.imwrite(str(d / f"im{i}.png"), _image((30, 44), i))
    sess, _ = _session("rrdb_hybrid")
    timers = StageTimers()
    with torch.profiler.profile():
        sess.process(str(d), str(tmp_path / "out"), verbose=False, timers=timers)
    recs = tracer.TRACER.records
    by = {}
    for r in recs:
        by.setdefault(r.name, []).append(r)
    assert {k: len(v) for k, v in by.items() if k in (
        "innfer.read", "innfer.image", "innfer.frame", "innfer.fetch", "innfer.encode")} == {
        "innfer.read": 6, "innfer.image": 6, "innfer.frame": 6, "innfer.fetch": 6,
        "innfer.encode": 6}
    assert by["innfer.encode_wait"] and timers.report()["encode_wait"]["count"] == len(
        by["innfer.encode_wait"])
    assert {r.name for r in recs} <= set(FRAME_TREE) | {
        "innfer.read", "innfer.image", "innfer.encode_wait", "innfer.encode"}
    ids = [r.request for r in by["innfer.image"]]
    assert len(set(ids)) == 6 and all(isinstance(i, int) for i in ids)
    for rid in ids:
        names = sorted(r.name for r in recs if r.request == rid and r.parent is None)
        assert names == ["innfer.encode", "innfer.fetch", "innfer.image"] or names == [
            "innfer.encode", "innfer.encode_wait", "innfer.fetch", "innfer.image"]
        frame = [r for r in recs if r.name == "innfer.frame" and r.request == rid]
        assert len(frame) == 1 and frame[0].parent.name == "innfer.image"
    # the report keeps its fields; fetch is timed once, by its own span
    assert set(timers.report()["fetch"]) == {"total_s", "count", "mean_ms"}
    assert timers.report()["fetch"]["count"] == 6
    tracer.reset()
    with torch.profiler.profile():
        sess.process(str(d), str(tmp_path / "out2"), verbose=False, batch=3)
    batches = [r for r in tracer.TRACER.records if r.name == "innfer.batch"]
    assert len(batches) == 2 and all(len(b.request) == 3 for b in batches)
    ids = [r.request for r in tracer.TRACER.records if r.name == "innfer.encode"]
    assert sorted(ids) == sorted(i for b in batches for i in b.request)


def test_spans_keep_their_threads_parents_and_requests(tracer):
    """Eight threads nest stage spans under a profiler with a short switch
    interval: no record is lost, and each span's parent is its own
    thread's, with that thread's request id."""
    timers = StageTimers()
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work(k):
            for _ in range(50):
                with timers.stage("outer", request=k):
                    with tracer.span("inner"):
                        tracer.count("n", 1)
        with torch.profiler.profile():
            threads = [threading.Thread(target=work, args=(k,)) for k in range(8)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    inner = [r for r in tracer.TRACER.records if r.name == "inner"]
    assert len(inner) == 400 and tracer.summary()["counters"] == {"n": 400}
    assert all(r.parent.name == "innfer.outer" and r.parent.request == r.request
               for r in inner)
    assert timers.report()["outer"]["count"] == 400


def test_cli_profile_logs_the_summary(tmp_path, caplog):
    import cv2
    from innfer_tpu_torch import cli
    d = tmp_path / "in"
    d.mkdir()
    cv2.imwrite(str(d / "a.png"), _image((30, 44)))
    with caplog.at_level(logging.INFO, logger="innfer_tpu_torch"):
        assert cli.main(["-m", os.path.join(GOLDENS, "esrgan_x2.pth"), "-i", str(d),
                         "-o", str(tmp_path / "out"), "-cpu", "--tile-mode", "hybrid",
                         "--tile", "24", "--overlap", "8",
                         "--profile", str(tmp_path / "prof")]) == 0
    msg = [r.getMessage() for r in caplog.records if "trace summary" in r.getMessage()]
    assert len(msg) == 1
    lines = msg[0].splitlines()
    assert lines[1].split() == ["span", "count", "host", "ms", "device", "ms", "self", "ms"]
    assert any(ln.split()[:2] == ["innfer.frame", "1"] for ln in lines)
    assert any(ln.startswith("counter tile_px") for ln in lines)
    trace = json.loads((tmp_path / "prof" / TRACE_FILE).read_text())
    assert any(e.get("name") == "innfer.trunk" for e in trace["traceEvents"])
