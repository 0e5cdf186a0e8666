"""The kernel build's naming (innfer_tpu_torch/ops/_build.py), on the CPU:
a library is named by a digest of its source, the csrc/ headers that
source includes and the flags, so an edit of the shared header rebuilds
both libraries.  Needs no nvcc."""
import os
import shutil

import pytest

from innfer_tpu_torch.ops import _build


@pytest.mark.parametrize("name", ["rdb", "resnet_block"])
def test_both_libraries_include_the_shared_conv_header(name):
    deps = _build.local_includes(os.path.join(_build.CSRC, f"{name}.cu"))
    assert [os.path.basename(d) for d in deps] == ["conv3x3_tc.cuh"]


@pytest.fixture
def csrc_copy(tmp_path, monkeypatch):
    d = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, d)
    monkeypatch.setattr(_build, "CSRC", str(d))
    return d


@pytest.mark.parametrize("edited,changes", [
    ("conv3x3_tc.cuh", {"rdb", "resnet_block"}),
    ("rdb.cu", {"rdb"}),
    ("resnet_block.cu", {"resnet_block"}),
])
def test_digest_follows_every_source_it_builds_from(csrc_copy, edited, changes):
    before = {n: _build.source_digest(n) for n in ("rdb", "resnet_block")}
    assert before["rdb"] != before["resnet_block"]
    assert before == {n: _build.source_digest(n) for n in before}  # stable
    with open(csrc_copy / edited, "a") as f:
        f.write("\n// edited\n")
    after = {n: _build.source_digest(n) for n in before}
    assert {n for n in before if before[n] != after[n]} == changes


def test_nested_local_includes_are_followed_once(csrc_copy):
    (csrc_copy / "inner.cuh").write_text("#pragma once\n")
    (csrc_copy / "outer.cuh").write_text('#include "inner.cuh"\n#include <cuda.h>\n')
    (csrc_copy / "k.cu").write_text('#include "outer.cuh"\n  #include "inner.cuh"\n')
    deps = _build.local_includes(str(csrc_copy / "k.cu"))
    assert [os.path.basename(d) for d in deps] == ["outer.cuh", "inner.cuh"]
    before = _build.source_digest("k")
    (csrc_copy / "inner.cuh").write_text("#pragma once\n// edited\n")
    assert _build.source_digest("k") != before
