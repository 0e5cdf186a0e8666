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
with open(osp.join(ROOT, "BENCHMARK.json")) as _f:
    BENCH = json.load(_f)


def pytest_configure(config):
    config.addinivalue_line("markers", "gpu: needs an NVIDIA GPU (skips without one)")


# Tiny widths and images for runs on the CPU: the harness and the references
# as they are, the model and the traffic cut down.  Each architecture's cut
# is ``tests/tiny/arch/<arch>.json`` ("model": the widths that replace the
# published ones; "control": the image size of the control test, run at
# published widths; "reference": the reference test's cases, each an image
# size and whether the card's mode is forced), each traffic mix's
# ``tests/tiny/traffic/<traffic>.json`` (the keys that replace its own), so
# a configuration or a mix joins the tests as new files.  One that has none
# stays as published here and in no derived case: test_every_named_file_is_there
# names it.


def tiny(root: str, kind: str, name: str):
    """The tiny cut ``innbench/tests/tiny/<kind>/<name>.json`` of the
    checkout at ``root`` (``kind`` is ``arch`` or ``traffic``), or None."""
    path = osp.join(root, "innbench", "tests", "tiny", kind, name + ".json")
    if not osp.isfile(path):
        return None
    with open(path) as f:
        return json.load(f)


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


def config(root: str, bench: dict, name: str) -> dict:
    """The configuration ``name`` of ``bench`` (a BENCHMARK.json), from its file under ``root``."""
    entry = [c for c in bench["configs"] if c["name"] == name][0]
    with open(osp.join(root, entry["file"])) as f:
        return json.load(f)


def _traffic_kind(root: str, name: str) -> str:
    with open(osp.join(root, "innbench", "traffic", name + ".json")) as f:
        return json.load(f)["kind"]


def _arch_cut(root: str, bench: dict, name: str):
    """The tiny cut of the architecture of configuration ``name``, or None."""
    return tiny(root, "arch", config(root, bench, name)["arch"])


def frame_cells(bench: dict, root: str = ROOT) -> list:
    """Every cell of ``bench`` whose traffic is of the ``frames`` kind: the
    card's fault cases, at each cell's own size."""
    return [w["name"] for w in bench["workloads"]
            if _traffic_kind(root, w["traffic"]) == "frames"]


def tiny_frame_cells(bench: dict, root: str = ROOT) -> list:
    """Those of frame_cells whose architecture and traffic have tiny cuts:
    the CPU's fault cases."""
    return [w["name"] for w in bench["workloads"]
            if _traffic_kind(root, w["traffic"]) == "frames"
            and _arch_cut(root, bench, w["config"]) is not None
            and tiny(root, "traffic", w["traffic"]) is not None]


def control_cases(bench: dict, root: str = ROOT) -> list:
    """(cell, height, width): every cell of ``bench`` at its architecture's
    control size."""
    cuts = ((w["name"], _arch_cut(root, bench, w["config"]) or {}) for w in bench["workloads"])
    return [(name, *cut["control"]) for name, cut in cuts if "control" in cut]


def reference_cases(bench: dict, root: str = ROOT) -> list:
    """(configuration, height, width, card): every configuration of
    ``bench`` with each reference case of its architecture's tiny cut."""
    return [(c["name"], *case["size"], case["card"]) for c in bench["configs"]
            for case in (_arch_cut(root, bench, c["name"]) or {}).get("reference", [])]


def make_root(dst, *, dtype="fp32", src: str = ROOT) -> str:
    """A checkout at ``dst`` holding the BENCHMARK.json of the checkout at
    ``src``, with DIR_CELLS added, and a copy of its innbench/ whose
    configurations and traffic are cut to their tiny sizes and whose cells
    are held to TINY_LIMITS."""
    shutil.copytree(osp.join(src, "innbench"), osp.join(dst, "innbench"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = with_dir_cells(json.load(open(osp.join(src, "BENCHMARK.json"))))
    json.dump(bench, open(osp.join(dst, "BENCHMARK.json"), "w"))
    for w in bench["workloads"]:
        json.dump(TINY_LIMITS, open(osp.join(dst, "innbench", "limits", w["name"] + ".json"), "w"))
    for c in bench["configs"]:
        path = osp.join(dst, c["file"])
        cfg = json.load(open(path))
        cut = tiny(dst, "arch", cfg["arch"])
        if cut is not None:
            cfg["model"].update(cut.get("model", {}))
        cfg["session"]["dtype"] = dtype
        json.dump(cfg, open(path, "w"))
    for name in {w["traffic"] for w in bench["workloads"]}:
        cut = tiny(dst, "traffic", name)
        if cut is not None:
            path = osp.join(dst, "innbench", "traffic", name + ".json")
            mix = json.load(open(path))
            mix.update(cut)
            json.dump(mix, open(path, "w"))
    return str(dst)


@pytest.fixture
def tiny_root(tmp_path):
    return make_root(tmp_path)
