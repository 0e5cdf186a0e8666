"""Tests of the port that need an NVIDIA GPU (marked ``gpu``).

They skip where no card is present.  The file imports neither JAX nor the
JAX package, so it also runs on the machine with the card, which has no
JAX, without the suite's conftest:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py

Tolerances: fp32 max-abs 1e-4 (true fp32 on both sides, different
summation order); bf16 max-abs 0.05 (both sides round at the same points;
a one-ulp flip of an intermediate is the largest expected difference).
For the ResnetBlock in bf16, every value within 2^-7 (|ref| + |ref - x| +
1): one bf16 ulp of the sum, of h2 and of instance norm's unit scale (see
tests/test_torch_resnet.py).  The chain-mode trunk equals the per-RDB
kernel path exactly: the same conv code and the same rounding steps.
"""
import math

import numpy as np
import pytest
import torch

from innfer_tpu_torch.config.defaults import get_network_config
from innfer_tpu_torch.models import convert_state, get_network
from innfer_tpu_torch.ops.rdb import (fused_rdb, fused_rrdb_trunk, rdb_reference,
                                      res_scale, rrdb_trunk_reference)
from innfer_tpu_torch.ops.resnet_block import fused_resnet_block, resnet_block_reference


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _rdb(dev, dtype, nf, gc, plus, seed):
    g = torch.Generator().manual_seed(seed)
    ws = [(torch.randn(gc if c < 4 else nf, nf + c * gc, 3, 3, generator=g)
           / math.sqrt(9 * (nf + c * gc))).to(dev, dtype) for c in range(5)]
    bs = [(torch.randn(gc if c < 4 else nf, generator=g) * 0.02).to(dev) for c in range(5)]
    w1 = (torch.randn(gc, nf, 1, 1, generator=g) / 8).to(dev, dtype) if plus else None
    return ws, bs, w1


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 0.05)])
@pytest.mark.parametrize("nf,gc,plus", [(64, 32, False), (64, 32, True),
                                        (32, 16, True), (24, 8, False)])
def test_kernel_matches_plain_on_card(cuda_device, dtype, tol, nf, gc, plus):
    ws, bs, w1 = _rdb(cuda_device, dtype, nf, gc, plus, seed=1)
    g = torch.Generator().manual_seed(2)
    x = torch.randn(2, 37, 70, nf, generator=g).to(cuda_device, dtype)
    before = fused_rdb.launches
    out = fused_rdb(x, ws, bs, plus=plus, conv1x1_w=w1)
    torch.cuda.synchronize()
    assert fused_rdb.launches == before + 1
    ref = rdb_reference(x, ws, bs, plus=plus, conv1x1_w=w1)
    assert (out.float() - ref.float()).abs().max().item() < tol


@pytest.mark.gpu
def test_model_kernel_path_matches_torch_path_fp32(cuda_device):
    """A small ESRGAN through backend auto (the kernel on CUDA) and torch,
    in true fp32: >= 80 dB, the golden bar."""
    g = np.random.default_rng(3)
    state = {}
    nb, nf, gc = 2, 32, 16

    def conv(key, o, i):
        std = math.sqrt(3.0 / (9 * i))
        state[f"{key}.weight"] = g.uniform(-std, std, (o, i, 3, 3)).astype(np.float32)
        state[f"{key}.bias"] = g.uniform(-0.01, 0.01, o).astype(np.float32)

    conv("model.0", nf, 3)
    for i in range(nb):
        for j in (1, 2, 3):
            for c in range(1, 6):
                conv(f"model.1.sub.{i}.RDB{j}.conv{c}.0", gc if c < 5 else nf, nf + (c - 1) * gc)
    for k in (f"model.1.sub.{nb}", "model.3", "model.6", "model.8"):
        conv(k, nf, nf)
    conv("model.10", 3, nf)
    x = torch.from_numpy(g.random((1, 40, 56, 3), np.float32)).to(cuda_device)
    outs = {}
    for backend in ("auto", "torch"):
        cfg = get_network_config({"type": "esrgan", "nb": nb, "nf": nf, "gc": gc,
                                  "backend": backend}, 4)
        model = get_network(cfg)
        params = convert_state(model, state, device=cuda_device)
        before = fused_rdb.launches
        with torch.no_grad():
            outs[backend] = model.apply(params, x).cpu().numpy()
        assert fused_rdb.launches - before == (nb * 3 if backend == "auto" else 0)
    mse = np.mean((outs["auto"].astype(np.float64) - outs["torch"]) ** 2)
    assert 10 * np.log10(1.0 / mse) >= 80


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("nb,nr,plus", [(2, 3, False), (1, 3, True), (2, 1, False)])
def test_trunk_matches_plain_and_per_rdb_path_on_card(cuda_device, dtype, nb, nr, plus):
    from innfer_tpu_torch.ops.rdb import fused_rdb_padded

    nf, gc = 32, 16
    rdbs = [[_rdb(cuda_device, dtype, nf, gc, plus, seed=10 * r + c) for c in range(nr)]
            for r in range(nb)]
    ws = [[p[0] for p in row] for row in rdbs]
    bs = [[p[1] for p in row] for row in rdbs]
    w1 = [[p[2] for p in row] for row in rdbs] if plus else None
    x = torch.randn(1, 33, 45, nf, generator=torch.Generator().manual_seed(3)).to(cuda_device, dtype)
    before = fused_rdb_padded.launches, fused_rrdb_trunk.launches
    out = fused_rrdb_trunk(x, ws, bs, nb=nb, nr=nr, gc=gc, plus=plus, conv1x1_ws=w1)
    torch.cuda.synchronize()
    assert (fused_rdb_padded.launches, fused_rrdb_trunk.launches) == (before[0] + nb * nr,
                                                                      before[1] + 1)
    ref = rrdb_trunk_reference(x, ws, bs, nb=nb, nr=nr, plus=plus, conv1x1_ws=w1)
    tol = 1e-4 if dtype == torch.float32 else 0.05
    assert (out.float() - ref.float()).abs().max().item() < tol
    z0 = x
    for r in range(nb):
        z = z0
        for c in range(nr):
            z = fused_rdb(z, ws[r][c], bs[r][c], plus=plus, conv1x1_w=w1[r][c] if plus else None)
        z0 = z * res_scale(dtype) + z0
    assert torch.equal(out, z0)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,bias", [((2, 24, 40, 256), True), ((3, 2, 5, 32), False),
                                        ((1, 19, 23, 64), True)])
def test_resnet_block_matches_plain_on_card(cuda_device, dtype, shape, bias):
    c = shape[-1]
    g = torch.Generator().manual_seed(4)
    w1, w2 = ((torch.randn(c, c, 3, 3, generator=g) * 0.02).to(cuda_device, dtype)
              for _ in range(2))
    b1, b2 = ((torch.randn(c, generator=g) * 0.1).to(cuda_device) if bias else None
              for _ in range(2))
    x = torch.randn(*shape, generator=g).to(cuda_device, dtype)
    before = fused_resnet_block.launches
    out = fused_resnet_block(x, w1, b1, w2, b2)
    torch.cuda.synchronize()
    assert fused_resnet_block.launches == before + 1
    ref = resnet_block_reference(x, w1, b1, w2, b2).float()
    d = (out.float() - ref).abs()
    if dtype == torch.float32:
        assert d.max().item() < 1e-4
    else:
        assert (d <= 2.0 ** -7 * (ref.abs() + (ref - x.float()).abs() + 1)).all()


def _cyclegan_state(g, n_blocks=2, ngf=8):
    state = {}

    def conv(key, o, i, k=3, transposed=False):
        std = 1.0 / math.sqrt(i * k * k)
        shape = (i, o, k, k) if transposed else (o, i, k, k)
        state[f"{key}.weight"] = g.uniform(-std, std, shape).astype(np.float32)
        state[f"{key}.bias"] = g.uniform(-0.01, 0.01, o).astype(np.float32)

    conv("model.1", ngf, 3, k=7)
    conv("model.4", ngf * 2, ngf)
    conv("model.7", ngf * 4, ngf * 2)
    for i in range(n_blocks):
        conv(f"model.{10 + i}.conv_block.1", ngf * 4, ngf * 4)
        conv(f"model.{10 + i}.conv_block.5", ngf * 4, ngf * 4)
    conv(f"model.{10 + n_blocks}", ngf * 2, ngf * 4, transposed=True)
    conv(f"model.{13 + n_blocks}", ngf, ngf * 2, transposed=True)
    conv(f"model.{17 + n_blocks}", 3, ngf, k=7)
    return state


@pytest.mark.gpu
def test_cyclegan_kernel_path_matches_torch_path_fp32(cuda_device):
    """A small CycleGAN through backend auto (the kernel on CUDA) and torch,
    in true fp32: >= 80 dB, the golden bar; one launch per block."""
    g = np.random.default_rng(5)
    state = _cyclegan_state(g)
    x = torch.from_numpy(g.random((1, 44, 60, 3), np.float32) * 2 - 1).to(cuda_device)
    outs = {}
    for backend in ("auto", "torch"):
        model = get_network(get_network_config(
            {"type": "resnet_6blocks", "n_blocks": 2, "backend": backend}, 1))
        params = convert_state(model, state, device=cuda_device)
        before = fused_resnet_block.launches
        with torch.no_grad():
            outs[backend] = model.apply(params, x).cpu().numpy()
        assert fused_resnet_block.launches - before == (2 if backend == "auto" else 0)
    mse = np.mean((outs["auto"].astype(np.float64) - outs["torch"]) ** 2)
    assert 10 * np.log10(1.0 / mse) >= 80


@pytest.mark.gpu
def test_kernel_backend_raises_where_the_kernels_do_not_reach(cuda_device):
    cfg = get_network_config({"type": "resnet_9blocks", "backend": "kernel",
                              "norm_type": "batch"}, 1)
    with pytest.raises(ValueError, match="backend='kernel' requires"):
        get_network(cfg)
    from innfer_tpu_torch.models.rrdb import _rrdb

    params = {"model.1.sub.0.RDB1.conv1.0.bias": torch.zeros(8, device=cuda_device)}
    with pytest.raises(ValueError, match="backend='kernel' requires"):
        _rrdb(params, torch.zeros(1, 8, 8, 16, device=cuda_device), "model.1.sub.0", nr=3,
              act_type="relu", plus=False, backend="kernel")
    x = torch.zeros(1, 8, 8, 48, device=cuda_device)  # C not a multiple of 32
    w = torch.zeros(48, 48, 3, 3, device=cuda_device)
    with pytest.raises(ValueError, match="C % 32"):
        fused_resnet_block(x, w, None, w, None)
