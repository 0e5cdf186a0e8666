"""PPON's operation counts against counts made by hand."""
import json
import os.path as osp

import pytest

from innbench.flops import ppon as P

from .conftest import ROOT


def _model():
    return json.load(open(osp.join(ROOT, "innbench", "configs", "ppon_x4.json")))["model"]


def test_block_macs_per_pixel():
    # c1 3x3 64->64, eight dilated 3x3 64->32, c2 1x1 256->64
    assert P.block_macs_per_px(_model()) == 9 * 64 * 64 + 8 * 9 * 64 * 32 + 256 * 64 == 200_704


def test_ppon_x4_macs_per_lr_pixel():
    m = _model()
    branch = 9 * 64 * 64 * (4 + 16) + 16 * 9 * 64 * 64 + 16 * 9 * 64 * 3   # ESRGAN's x4 tail
    hand = 9 * 3 * 64 + 84 * 200_704 + 9 * 64 * 64 + 3 * branch
    assert P.n_blocks(m) == 84
    assert P.macs_per_lr_px(m) == hand == 20_961_984
    assert P.image_flops(m, 540, 960) == pytest.approx(21.734e12, rel=1e-4)


def test_kernel_work_counts_each_block_once():
    flops, nbytes = P.kernel_work(_model(), "fused_dilated_block", 540, 960, 2)
    assert flops == 84 * 2 * 200_704 * 540 * 960
    # x in and out once, the weights once: bound by the operations at 989
    # TFLOP/s (0.210 ms a block), not the bytes at 3.35 TB/s (0.040 ms)
    assert flops / 84 / 989e12 == pytest.approx(0.2104e-3, rel=1e-3)
    assert nbytes / 84 / 3.35e12 == pytest.approx(0.0397e-3, rel=1e-2)
    assert P.kernel_work(_model(), "fused_rdb", 540, 960, 2) is None
