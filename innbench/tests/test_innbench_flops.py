"""The operation counts against counts made by hand."""
import json
import os.path as osp

import pytest

from innbench.flops import resnet_generator as G, rrdbnet as R

from .conftest import ROOT


def _model(name):
    return json.load(open(osp.join(ROOT, "innbench", "configs", name + ".json")))["model"]


def test_rdb_macs_per_pixel():
    # 9 taps x (64*32 + 96*32 + 128*32 + 160*32 + 192*64)
    assert R.rdb_macs_per_px(_model("esrgan_x4")) == 239_616


def test_esrgan_x4_macs_per_lr_pixel():
    m = _model("esrgan_x4")
    hand = (9 * 3 * 64 + 69 * 239_616 + 9 * 64 * 64          # first conv, 69 blocks, trunk conv
            + 9 * 64 * 64 * (4 + 16)                         # the two upsampling convs
            + 16 * 9 * 64 * 64 + 16 * 9 * 64 * 3)            # the HR convs
    assert R.macs_per_lr_px(m) == hand == 17_926_848
    assert R.image_flops(m, 540, 960) == pytest.approx(18.5866e12, rel=1e-4)


def test_cyclegan_r9_macs_per_pixel():
    m = _model("cyclegan_r9")
    hand = (49 * 3 * 64 + 9 * 64 * 128 / 4 + 9 * 128 * 256 / 16    # 7x7 in, two strided convs
            + 9 * 2 * 9 * 256 * 256 / 16                           # 9 blocks of two convs
            + 9 * 256 * 128 / 16 + 9 * 128 * 64 / 4                 # two transposed convs
            + 49 * 64 * 3)                                          # 7x7 out
    assert G.macs_per_px(m) == hand == 756_096
    assert G.image_flops(m, 1080, 1920) == pytest.approx(3.1357e12, rel=1e-4)


@pytest.mark.parametrize("arch,config,kernel,h,w,calls,flops", [
    ("rrdbnet", "esrgan_x4", "fused_rdb", 540, 960, 69, 2 * 239_616 * 540 * 960),
    ("resnet_generator", "cyclegan_r9", "fused_resnet_block", 1080, 1920, 9,
     2 * 2 * 9 * 256 * 256 * 270 * 480),
])
def test_kernel_work_counts_each_call_once(arch, config, kernel, h, w, calls, flops):
    mod = {"rrdbnet": R, "resnet_generator": G}[arch]
    got_flops, got_bytes = mod.kernel_work(_model(config), kernel, h, w, 2)
    assert got_flops == calls * flops
    # input read and output written once, plus the weights: bound by the
    # operations at 989 TFLOP/s, not the bytes at 3.35 TB/s
    assert got_flops / 989e12 > got_bytes / 3.35e12
    assert mod.kernel_work(_model(config), "no_such_kernel", h, w, 2) is None
