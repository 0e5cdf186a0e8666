"""The port's multi-process run: init_distributed's wiring (CLI flags ->
torch.distributed.init_process_group -> shard defaults) through a
monkeypatched init, as tests/test_multihost.py does for jax.distributed,
and one real two-process CLI run over gloo on localhost whose stripes
together equal a single-process run.  Everything is fp32 on the CPU.
"""
import os
import os.path as osp
import socket
import subprocess
import sys

import cv2
import numpy as np
import pytest
import torch.distributed as dist

from innfer_tpu.parallel import multihost as jax_multihost
from innfer_tpu_torch import cli
from innfer_tpu_torch.parallel import multihost

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))
GOLDENS = osp.join(ROOT, "tests", "goldens")


def _record(monkeypatch):
    calls = {}

    def fake_init(backend=None, init_method=None, world_size=-1, rank=-1, **kw):
        calls.update(backend=backend, init_method=init_method, world=world_size, rank=rank)

    monkeypatch.setattr(dist, "init_process_group", fake_init)
    return calls


def test_initialize_called_with_args(monkeypatch):
    calls = _record(monkeypatch)
    rank, world = multihost.init_distributed("10.0.0.1:1234", 2, 1)
    assert calls == {"backend": "gloo", "init_method": "tcp://10.0.0.1:1234",
                     "world": 2, "rank": 1}
    # the recorded init leaves this a single-process run
    assert (rank, world) == (0, 1)


def test_single_process_skips_initialize(monkeypatch):
    def boom(*a, **kw):
        raise AssertionError("init_process_group must not be called")

    monkeypatch.setattr(dist, "init_process_group", boom)
    assert multihost.init_distributed(None, None, None) == (0, 1)
    assert multihost.init_distributed(None, 1, 0) == (0, 1)


def test_initialised_group_gives_rank_and_world(monkeypatch):
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_rank", lambda: 3)
    monkeypatch.setattr(dist, "get_world_size", lambda: 4)
    assert multihost.init_distributed(None, None, None) == (3, 4)


def _write_inputs(d, names, h=16, w=16, seed=0):
    d.mkdir()
    for i, name in enumerate(names):
        cv2.imwrite(str(d / name), np.random.default_rng(seed + i).integers(
            0, 255, (h, w, 3)).astype(np.uint8))


def test_cli_flags_reach_initialize(monkeypatch, tmp_path):
    calls = _record(monkeypatch)
    inp, out = tmp_path / "in", tmp_path / "out"
    _write_inputs(inp, ("a.png", "b.png", "c.png"))
    rc = cli.main([
        "-m", osp.join(GOLDENS, "esrgan_x2.pth"), "-i", str(inp), "-o", str(out), "-cpu",
        "--tile-mode", "none", "--coordinator", "host0:9999", "--num-processes", "2",
        "--process-id", "1", "--num-shards", "2", "--shard-index", "1",
    ])
    assert rc == 0
    assert calls == {"backend": "gloo", "init_method": "tcp://host0:9999", "world": 2, "rank": 1}
    # shard 1 of 2 over a sorted 3-image list -> exactly one output
    assert sorted(os.listdir(out)) == ["b.png"]


def test_cli_shards_default_to_rank_and_world(monkeypatch, tmp_path):
    monkeypatch.setattr(multihost, "init_distributed", lambda *a: (1, 3))
    inp, out = tmp_path / "in", tmp_path / "out"
    _write_inputs(inp, ("a.png", "b.png", "c.png", "d.png", "e.png"))
    assert cli.main(["-m", osp.join(GOLDENS, "esrgan_x2.pth"), "-i", str(inp), "-o", str(out),
                     "-cpu", "--tile-mode", "none"]) == 0
    assert sorted(os.listdir(out)) == ["b.png", "e.png"]


def test_cli_leaves_the_group_on_every_exit(monkeypatch, tmp_path):
    left = []
    monkeypatch.setattr(multihost, "init_distributed", lambda *a: (0, 2))
    monkeypatch.setattr(multihost, "shutdown_distributed", lambda: left.append(1))
    with pytest.raises(ValueError, match="not found"):
        cli.main(["-m", str(tmp_path / "missing.pth"), "-i", str(tmp_path), "-cpu"])
    inp = tmp_path / "in"
    _write_inputs(inp, ("a.png",))
    assert cli.main(["-m", osp.join(GOLDENS, "esrgan_x2.pth"), "-i", str(inp), "-o",
                     str(tmp_path / "out"), "-cpu", "--tile-mode", "none"]) == 0
    assert left == [1, 1]


def test_shard_paths_equal_jax():
    paths = [f"{i:03d}.png" for i in range(10)]
    for n in (1, 2, 3, 4):
        for i in range(n):
            assert multihost.shard_paths(paths, i, n) == jax_multihost.shard_paths(paths, i, n)
    with pytest.raises(ValueError):
        multihost.shard_paths(["a"], 2, 2)


SCRIPT = """
import sys
sys.path.insert(0, {root!r})
import torch
torch.set_num_threads(1)
import torch.distributed as dist
from innfer_tpu_torch import cli
from innfer_tpu_torch.parallel import multihost
seen = {{}}
real = multihost.shutdown_distributed
def shutdown():
    seen["world"] = dist.get_world_size()
    seen["rank"] = dist.get_rank()
    real()
multihost.shutdown_distributed = shutdown
rank = int(sys.argv[1])
rc = cli.main(["-m", {model!r}, "-i", {inp!r}, "-o", sys.argv[2], "-cpu",
               "--tile", "16", "--overlap", "8",
               "--coordinator", "127.0.0.1:{port}", "--num-processes", "2",
               "--process-id", str(rank)])
assert rc == 0
assert seen == {{"world": 2, "rank": rank}}, seen
assert not dist.is_initialized()
print("DIST_OK", rank)
"""


def test_two_process_cli_run(tmp_path):
    """Two real processes, rendezvous on localhost over gloo, each
    through the CLI: each writes its stripe, and the stripes together are
    the single-process run's outputs."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    inp = tmp_path / "in"
    _write_inputs(inp, ("a.png", "b.png", "c.png"), h=20, w=28, seed=1)
    model = osp.join(GOLDENS, "esrgan_x2.pth")
    script = SCRIPT.format(root=ROOT, model=model, inp=str(inp), port=port)
    env = dict(os.environ, OMP_NUM_THREADS="1")
    outs = [tmp_path / f"out{r}" for r in (0, 1)]
    procs = [subprocess.Popen([sys.executable, "-c", script, str(r), str(outs[r])], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in (0, 1)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=120)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)
    assert "DIST_OK 0" in logs[0] and "DIST_OK 1" in logs[1]
    # sorted [a, b, c] striped i % 2: rank 0 -> a, c; rank 1 -> b
    assert sorted(os.listdir(outs[0])) == ["a.png", "c.png"]
    assert sorted(os.listdir(outs[1])) == ["b.png"]
    single = tmp_path / "single"
    assert cli.main(["-m", model, "-i", str(inp), "-o", str(single), "-cpu",
                     "--tile", "16", "--overlap", "8"]) == 0
    for name in ("a.png", "b.png", "c.png"):
        got = cv2.imread(str(outs[0 if name != "b.png" else 1] / name))
        want = cv2.imread(str(single / name))
        assert got.shape == want.shape == (40, 56, 3)
        assert np.array_equal(got, want), name
