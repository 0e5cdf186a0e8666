"""The import audit: no module of the benchmark imports JAX or the JAX
package (top-level names compared whole: innfer_tpu_torch is the port, not
innfer_tpu), the references import nothing of the program, and a run that
finds them loaded refuses to print a result."""
import ast
import os
import os.path as osp
import sys
import types

import pytest

from innbench import harness

from .conftest import ROOT

BENCH = osp.join(ROOT, "innbench")
FORBIDDEN = {"jax", "jaxlib", "flax", "innfer_tpu"}


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module.split(".")[0]


def _sources(sub=""):
    for d, _, files in os.walk(osp.join(BENCH, sub)):
        for f in files:
            if f.endswith(".py"):
                yield osp.join(d, f)


@pytest.mark.parametrize("path", sorted(_sources()), ids=lambda p: osp.relpath(p, BENCH))
def test_no_module_imports_jax_or_the_jax_package(path):
    assert not set(_imports(path)) & FORBIDDEN


@pytest.mark.parametrize("path", sorted(_sources("reference")), ids=lambda p: osp.relpath(p, BENCH))
def test_reference_imports_nothing_of_the_program(path):
    assert "innfer_tpu_torch" not in set(_imports(path))
    assert "innfer_tpu" not in set(_imports(path))


@pytest.fixture
def clean_modules(monkeypatch):
    """sys.modules without JAX, as a benchmark run's would be."""
    for m in list(sys.modules):
        if m.split(".")[0] in FORBIDDEN:
            monkeypatch.delitem(sys.modules, m)


def test_whole_name_compare(monkeypatch, clean_modules):
    monkeypatch.setitem(sys.modules, "innfer_tpu_torch_fake", types.ModuleType("x"))
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "innfer_tpu.pipeline", types.ModuleType("y"))
    assert harness.forbidden_modules() == ["innfer_tpu"]


def test_run_refuses_when_jax_is_loaded(monkeypatch, capsys, clean_modules):
    """run.py's end-of-run check, with the card and the run itself faked."""
    from innbench import run

    line = {"correct": True, "attempted": 1, "failed": 0, "metrics": {}, "device": {},
            "checks": {"rmse_u8": {"value": 0.5, "limit": 1.0}}}
    monkeypatch.setattr("torch.cuda.is_available", lambda: True)
    monkeypatch.setattr("torch.cuda.device_count", lambda: 1)
    monkeypatch.setattr(harness, "init_card", lambda: None)
    monkeypatch.setattr(harness.Run, "run", lambda self: line)
    monkeypatch.setattr(harness.Run, "__init__", lambda self, *a, **k: None)
    assert run.main(["--workload", "esrgan_x4.frames540", "--seed", "1", "--seconds", "1"]) == 0
    assert '"correct": true' in capsys.readouterr().out
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    assert run.main(["--workload", "esrgan_x4.frames540", "--seed", "1", "--seconds", "1"]) == 1
    out = capsys.readouterr()
    assert out.out == "" and "jax" in out.err


def test_run_refuses_without_a_card(monkeypatch, capsys):
    from innbench import run

    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    assert run.main(["--workload", "esrgan_x4.frames540", "--seed", "1", "--seconds", "1"]) == 1
    out = capsys.readouterr()
    assert out.out == "" and "no CUDA device" in out.err
