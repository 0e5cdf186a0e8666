"""The statistics on synthetic data: the tail over every sample, the
device's busy union and idle gaps, and the rates over whole windows."""
import numpy as np
import pytest

from innbench import harness, trace


def test_p95_takes_every_sample():
    vals = [float(v) for v in range(1, 201)]
    # linear between order statistics: 1 + 0.95 * 199
    assert harness.p95(vals) == pytest.approx(190.05)
    assert harness.p95(vals) == pytest.approx(np.percentile(vals, 95))
    # one slow frame in twenty moves it; a median would not
    assert harness.p95([10.0] * 18 + [100.0, 100.0]) > 50


def test_busy_is_the_union():
    assert trace.busy([(0, 2), (1, 3), (5, 6), (5.5, 5.7)]) == pytest.approx(4.0)
    assert trace.busy([]) == 0


def test_gaps_and_their_host_ops():
    dev = [(1, 2), (4, 5), (4.5, 7)]
    g = trace.gaps(dev, 0, 10)
    assert g == [(0, 1), (2, 4), (7, 10)]
    host = [(0, 10, "outer"), (2, 4.2, "aten::copy_"), (7.5, 9, "cudaStreamSynchronize")]
    labels = trace.innermost(host, [(a + b) / 2 for a, b in g])
    assert labels == ["outer", "aten::copy_", "cudaStreamSynchronize"]


def test_trace_breakdown_orders_and_caps():
    tr = trace.Trace(window_s=2.0, busy_s=1.5, by_kernel={f"k{i}": float(i) for i in range(15)},
                     idle_by_host_op={"a": 0.1, "b": 0.4}, device_events=15)
    b = tr.breakdown()
    assert len(b["device_ops"]) == 10 and b["device_ops"][0] == ["k14", 14.0]
    assert b["idle_gaps"] == [["b", 0.4], ["a", 0.1]]
    assert tr.kernel_seconds(("k1",)) == pytest.approx(1 + 10 + 11 + 12 + 13 + 14)


def test_frame_rate_and_tail_over_the_window():
    win = harness.Window(wall_s=2.0, latencies_s=[0.1] * 19 + [0.3], out_px=20 * 8_294_400)
    got = harness.end_to_end("frames", win, setup_s=7.5)
    assert got["frames_mp_s"] == pytest.approx(20 * 8.2944 / 2.0)
    assert got["frame_p95_ms"] == pytest.approx(110.0)
    assert got["setup_s"] == 7.5


def test_dir_rate_over_whole_passes():
    # three passes of 24 images, 170.6 MP each, over the passes' own wall time
    win = harness.Window(wall_s=21.3, out_px=3 * 170_590_208, passes=3)
    got = harness.end_to_end("dir", win, setup_s=9.0)
    assert got == {"setup_s": 9.0, "dir_mp_s": pytest.approx(3 * 170.590208 / 21.3)}
