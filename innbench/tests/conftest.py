"""The benchmark's CPU tests.  ``gpu`` marks a test that needs the card;
such a test decides inside itself, never at import, and skips here."""
import json
import os.path as osp
import shutil
import sys

import pytest

ROOT = osp.dirname(osp.dirname(osp.dirname(osp.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line("markers", "gpu: needs an NVIDIA GPU (skips without one)")


# tiny widths and images for runs on the CPU: the harness and the
# references as they are, the model and the traffic cut down
TINY_MODEL = {"rrdbnet": {"nf": 8, "nb": 1, "gc": 4}, "resnet_generator": {"ngf": 8}}
TINY_TRAFFIC = {"frames540": {"height": 24, "width": 40, "ring": 3},
                "frames1080": {"height": 36, "width": 52, "ring": 3},
                "dir_photos": {"sizes": [[20, 28, 2], [24, 24, 1]]},
                "dir_camera": {"sizes": [[36, 52, 3], [52, 36, 2]]}}


# The directory cells' entries as a benchmark PR that adds them would write
# them: the harness keeps the ``dir`` kind of traffic (``traffic/dir_*.json``)
# so that such a PR adds files only.  Their limits are not read yet, so a run
# in these tests is held to TINY_LIMITS.
DIR_CELLS = {
    "workloads": [
        {"name": "esrgan_x4.dir_photos", "config": "esrgan_x4", "traffic": "dir_photos",
         "chips": 1, "why": "process() passes over PNG photos of 5 sizes, x4 PNG out"},
        {"name": "cyclegan_r9.dir_camera", "config": "cyclegan_r9", "traffic": "dir_camera",
         "chips": 1, "why": "process() passes over 1080p PNGs, batch=0 stacks same-shape images"},
    ],
    "end_to_end": [
        {"name": "dir_mp_s", "unit": "MP/s", "better": "higher", "bound": 0.25,
         "source": "host_clock", "workloads": ["esrgan_x4.dir_photos", "cyclegan_r9.dir_camera"]},
    ],
    "per_layer": [
        {"name": n, "unit": u, "better": "lower", "source": src, "layer": layer,
         "moves": "dir_mp_s", "workloads": ["esrgan_x4.dir_photos", "cyclegan_r9.dir_camera"]}
        for n, u, src, layer in (("device_idle_pct.dir", "%", "device_trace", "device"),
                                 ("encode_ms_per_img.dir", "ms", "program_span", "host stages"),
                                 ("read_wait_ms_per_img.dir", "ms", "program_span", "host stages"))
    ],
}
# the limit of every cell in tiny fp32 runs on the CPU, where the program
# agrees with the fp32 reference far inside the gap of bf16 rounding
TINY_LIMITS = {"rmse_ratio": 1.0}


def with_dir_cells(bench: dict) -> dict:
    """BENCHMARK.json with DIR_CELLS added."""
    out = json.loads(json.dumps(bench))
    for key in ("workloads", "end_to_end", "per_layer"):
        out[key] += json.loads(json.dumps(DIR_CELLS[key]))
    setup = [m for m in out["end_to_end"] if m["name"] == "setup_s"]
    out["end_to_end"] = [m for m in out["end_to_end"] if m["name"] != "setup_s"] + setup
    return out


def make_root(dst, *, dtype="fp32") -> str:
    """A checkout at ``dst`` holding BENCHMARK.json, with DIR_CELLS added,
    and a copy of innbench/ whose configurations and traffic are cut to
    tiny sizes and whose cells are held to TINY_LIMITS."""
    shutil.copytree(osp.join(ROOT, "innbench"), osp.join(dst, "innbench"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = with_dir_cells(json.load(open(osp.join(ROOT, "BENCHMARK.json"))))
    json.dump(bench, open(osp.join(dst, "BENCHMARK.json"), "w"))
    for w in bench["workloads"]:
        json.dump(TINY_LIMITS, open(osp.join(dst, "innbench", "limits", w["name"] + ".json"), "w"))
    for c in bench["configs"]:
        path = osp.join(dst, c["file"])
        cfg = json.load(open(path))
        cfg["model"].update(TINY_MODEL[cfg["arch"]])
        cfg["session"]["dtype"] = dtype
        json.dump(cfg, open(path, "w"))
    for name, cut in TINY_TRAFFIC.items():
        path = osp.join(dst, "innbench", "traffic", name + ".json")
        mix = json.load(open(path))
        mix.update(cut)
        json.dump(mix, open(path, "w"))
    return str(dst)


@pytest.fixture
def tiny_root(tmp_path):
    return make_root(tmp_path)
