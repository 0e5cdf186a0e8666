"""A configuration, a traffic mix and a per-layer metric added as new files,
with their entries in BENCHMARK.json, are found by name: no file of the
harness is edited."""
import json
import os
import os.path as osp

import torch

from innbench import harness


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
