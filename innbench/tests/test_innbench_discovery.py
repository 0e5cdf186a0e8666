"""A configuration, a traffic mix and a per-layer metric added as new files,
with their entries in BENCHMARK.json, are found by name: no file of the
harness is edited.  So is a configuration of a new architecture, with its
tiny cut: the benchmark's CPU tests take its cell into their cases."""
import json
import os
import os.path as osp
import shutil

import torch

from innbench import harness

from .conftest import (ROOT, control_cases, frame_cells, make_root, reference_cases,
                       tiny_frame_cells)
from .test_innbench_faults import _run


def _snapshot(root):
    out = {}
    for d, _, files in os.walk(osp.join(root, "innbench")):
        for f in files:
            if "__pycache__" not in d:
                p = osp.join(d, f)
                out[p] = open(p, "rb").read()
    return out


def test_new_config_traffic_and_metric_are_found(tiny_root):
    root = tiny_root
    before = _snapshot(root)
    b = osp.join(root, "innbench")
    cfg = json.load(open(osp.join(b, "configs", "esrgan_x4.json")))
    cfg["name"] = "esrgan_x2"
    cfg["model"]["scale"] = 2
    cfg["checkpoint"] = "2x_esrgan_x2.pth"
    json.dump(cfg, open(osp.join(b, "configs", "esrgan_x2.json"), "w"))
    json.dump({"kind": "frames", "height": 20, "width": 36, "ring": 2, "noise_std": 4, "sample": 2},
              open(osp.join(b, "traffic", "tiny_pan.json"), "w"))
    json.dump({"rmse_ratio": 3.0},
              open(osp.join(b, "limits", "esrgan_x2.tiny_pan.json"), "w"))
    with open(osp.join(b, "metrics", "frames_done.py"), "w") as f:
        f.write("def read(ctx):\n    return float(len(ctx.window.images)) or None\n")
    bench = json.load(open(osp.join(root, "BENCHMARK.json")))
    bench["configs"].append({"name": "esrgan_x2", "source": "https://example.org/esrgan",
                             "file": "innbench/configs/esrgan_x2.json", "reduced": [],
                             "why": "a new configuration"})
    bench["workloads"].append({"name": "esrgan_x2.tiny_pan", "config": "esrgan_x2",
                               "traffic": "tiny_pan", "chips": 1, "why": "a new mix"})
    for m in bench["end_to_end"]:
        if "frames_mp_s" == m["name"] or "frame_p95_ms" == m["name"]:
            m["workloads"].append("esrgan_x2.tiny_pan")
    bench["per_layer"].append({"name": "frames_done", "unit": "frames", "better": "higher",
                               "source": "host_clock", "layer": "harness",
                               "moves": "frames_mp_s", "workloads": ["esrgan_x2.tiny_pan"]})
    json.dump(bench, open(osp.join(root, "BENCHMARK.json"), "w"))
    added = set(_snapshot(root)) - set(before)
    assert all(_snapshot(root)[p] == before[p] for p in before)   # nothing edited
    assert len(added) == 4

    cell = harness.load_cell(root, "esrgan_x2.tiny_pan")
    assert cell.model["scale"] == 2 and cell.traffic["ring"] == 2
    assert list(cell.readers) == ["frames_done"]
    with torch.no_grad():
        plain = harness.Run(cell, 5, 0.2, False, device="cpu", log=lambda m: None).run()
        traced = harness.Run(cell, 5, 0.2, True, device="cpu", log=lambda m: None).run()
    assert plain["correct"] and traced["correct"]
    assert set(plain["metrics"]) == {"frames_mp_s", "frame_p95_ms", "setup_s"}
    assert traced["metrics"]["frames_done"]["value"] == traced["attempted"]


def test_new_architecture_joins_as_new_files(tmp_path, monkeypatch):
    """``newnet``, a copy of ``rrdbnet`` under a name the benchmark does not
    know, added to a copy of the checkout as new files and list entries;
    the copy is then cut to tiny sizes as the tests cut the real one."""
    src = str(tmp_path / "src")
    shutil.copytree(osp.join(ROOT, "innbench"), osp.join(src, "innbench"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(osp.join(ROOT, "BENCHMARK.json"), src)
    before = _snapshot(src)
    b = osp.join(src, "innbench")
    for part in ("reference", "flops"):
        shutil.copy(osp.join(b, part, "rrdbnet.py"), osp.join(b, part, "newnet.py"))
    shutil.copy(osp.join(b, "tests", "tiny", "arch", "rrdbnet.json"),
                osp.join(b, "tests", "tiny", "arch", "newnet.json"))
    cfg = json.load(open(osp.join(b, "configs", "esrgan_x4.json")))
    cfg.update(name="newnet_x4", arch="newnet", checkpoint="4x_newnet_x4.pth")
    json.dump(cfg, open(osp.join(b, "configs", "newnet_x4.json"), "w"))
    cell = "newnet_x4.frames540"
    json.dump({"rmse_ratio": 7.0}, open(osp.join(b, "limits", cell + ".json"), "w"))
    bench = json.load(open(osp.join(src, "BENCHMARK.json")))
    bench["configs"].append({"name": "newnet_x4", "source": "https://example.org/newnet",
                             "file": "innbench/configs/newnet_x4.json", "reduced": [],
                             "why": "a configuration of a new architecture"})
    bench["workloads"].append({"name": cell, "config": "newnet_x4", "traffic": "frames540",
                               "chips": 1, "why": "a new architecture's cell"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "esrgan_x4.frames540" in m.get("workloads", []):
            m["workloads"].append(cell)
    json.dump(bench, open(osp.join(src, "BENCHMARK.json"), "w"))
    after = _snapshot(src)
    assert all(after[p] == before[p] for p in before)   # nothing edited
    assert len(set(after) - set(before)) == 5

    assert cell in frame_cells(bench, src) and cell in tiny_frame_cells(bench, src)
    assert (cell, 40, 64) in control_cases(bench, src)
    assert [c[1:] for c in reference_cases(bench, src) if c[0] == "newnet_x4"] == \
        [c[1:] for c in reference_cases(bench, src) if c[0] == "esrgan_x4"]

    root = make_root(tmp_path / "tiny", src=src)
    c = harness.load_cell(root, cell)
    assert c.model["nf"] == 8 and c.traffic["height"] == 24   # the tiny cuts, by name
    assert c.ref.__name__ == "innbench_reference_newnet"
    with torch.no_grad():
        plain = harness.Run(c, 7, 0.2, False, device="cpu", log=lambda m: None).run()
        traced = harness.Run(c, 7, 0.2, True, device="cpu", log=lambda m: None).run()
    assert plain["correct"] and traced["correct"], (plain["checks"], traced["checks"])
    assert set(plain["metrics"]) == {"frames_mp_s", "frame_p95_ms", "setup_s"}
    broken = _run(root, cell, "unchanged", monkeypatch, 2**31 + 99, 0.3, "cpu")
    assert broken["correct"] is False, broken["checks"]
