"""BENCHMARK.json against the contract's rules, and every file it names."""
import json
import os.path as osp
import re

import pytest

from .conftest import BENCH, DIR_CELLS, ROOT, tiny, with_dir_cells

# the rules hold for the file as it is and with the directory cells added
BOTH = pytest.mark.parametrize("B", [BENCH, with_dir_cells(BENCH)], ids=["as_is", "dir_cells_added"])
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
METRIC_KEYS = {"name", "unit", "better", "source", "bound", "layer", "moves", "workloads"}


def _metrics(B):
    return B["end_to_end"] + B["per_layer"]


def test_top_level_keys():
    B = BENCH
    assert set(B) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert B["paths"] == ["innbench"] and B["command"][1].startswith("innbench/")
    assert isinstance(B["run_seconds"], int) and 1 <= B["run_seconds"] <= 51
    assert len(json.dumps(B)) < 64 * 1024


@BOTH
def test_names_and_units(B):
    names = ([m["name"] for m in _metrics(B)] + [w["name"] for w in B["workloads"]]
             + [c["name"] for c in B["configs"]] + [w["traffic"] for w in B["workloads"]]
             + [w["config"] for w in B["workloads"]] + [k for c in B["configs"] for k in c["reduced"]])
    assert all(NAME.match(n) for n in names), [n for n in names if not NAME.match(n)]
    for group in (_metrics(B), B["workloads"], B["configs"]):
        assert len({x["name"] for x in group}) == len(group)
    assert all(UNIT.match(m["unit"]) for m in _metrics(B))
    assert all(m["better"] in ("lower", "higher") for m in _metrics(B))
    texts = ([c["why"] for c in B["configs"]] + [c["source"] for c in B["configs"]]
             + [w["why"] for w in B["workloads"]] + [m["layer"] for m in B["per_layer"]])
    assert all(1 <= len(t) <= 200 and "\n" not in t and "\t" not in t for t in texts)


@BOTH
def test_metric_entries(B):
    for m in B["end_to_end"]:
        assert set(m) <= METRIC_KEYS - {"layer", "moves"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" and "workloads" not in m for m in B["end_to_end"])
    layers = {}
    for m in B["per_layer"]:
        assert set(m) <= METRIC_KEYS - {"bound"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        layers.setdefault(m["layer"], m["layer"])
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"


def _reports(B, metric_name, cell):
    m = [x for x in B["end_to_end"] if x["name"] == metric_name][0]
    return cell in m.get("workloads", [cell])


@BOTH
def test_every_per_layer_metric_moves_a_metric_its_cells_report(B):
    cells = {w["name"] for w in B["workloads"]}
    for m in B["per_layer"]:
        assert m["workloads"] and set(m["workloads"]) <= cells
        for c in m["workloads"]:
            assert _reports(B, m["moves"], c), (m["name"], c)


@BOTH
def test_cells(B):
    configs = {c["name"] for c in B["configs"]}
    pairs = [(w["config"], w["traffic"]) for w in B["workloads"]]
    assert len(set(pairs)) == len(pairs)
    assert all(w["chips"] == 1 for w in B["workloads"])
    assert {w["config"] for w in B["workloads"]} == configs   # each keeps a cell
    for w in B["workloads"]:
        e2e = [m["name"] for m in B["end_to_end"] if w["name"] in m.get("workloads", [w["name"]])]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert any(w["name"] in m["workloads"] for m in B["per_layer"])


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_every_named_file_is_there(w):
    B = BENCH
    cfg_entry = [c for c in B["configs"] if c["name"] == w["config"]][0]
    assert cfg_entry["file"].startswith("innbench/")
    cfg = json.load(open(osp.join(ROOT, cfg_entry["file"])))
    b = osp.join(ROOT, "innbench")
    for path in (f"traffic/{w['traffic']}.json", f"limits/{w['name']}.json",
                 f"reference/{cfg['arch']}.py", f"flops/{cfg['arch']}.py",
                 f"tests/tiny/arch/{cfg['arch']}.json", f"tests/tiny/traffic/{w['traffic']}.json"):
        assert osp.isfile(osp.join(b, path)), path
    assert set(tiny(ROOT, "arch", cfg["arch"])) == {"model", "control", "reference"}
    for m in B["per_layer"]:
        if w["name"] in m["workloads"]:
            assert osp.isfile(osp.join(b, "metrics", m["name"] + ".py"))


@pytest.mark.parametrize("w", DIR_CELLS["workloads"], ids=lambda w: w["name"])
def test_the_files_of_the_directory_cells_are_there(w):
    """Their traffic and readers are in place; their limits are not, until
    they have been read on the card."""
    b = osp.join(ROOT, "innbench")
    assert osp.isfile(osp.join(b, "traffic", w["traffic"] + ".json"))
    assert osp.isfile(osp.join(b, "tests", "tiny", "traffic", w["traffic"] + ".json"))
    for m in DIR_CELLS["per_layer"]:
        if w["name"] in m["workloads"]:
            assert osp.isfile(osp.join(b, "metrics", m["name"] + ".py"))
