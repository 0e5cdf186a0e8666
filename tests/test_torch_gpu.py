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
The bf16 kernels run on the tensor cores (wgmma); the cases cut ragged
tiles (W, H not multiples of the 64-column tile and of fused_rdb's 16- and
8-row ones or fused_resnet_block's 2..8-row ones), cin and cout not
multiples of the 16-channel chunk or of a wgmma width, and give
fused_rdb's persistent grid fewer tiles than SMs and many more.
"""
import contextlib
import math
import time

import numpy as np
import pytest
import torch

from innfer_tpu_torch.config.defaults import get_network_config
from innfer_tpu_torch.models import common as C
from innfer_tpu_torch.models import convert_state, get_network
from innfer_tpu_torch.nn import functional as F
from innfer_tpu_torch.nn.functional import true_fp32
from innfer_tpu_torch.ops import plain_path
from innfer_tpu_torch.ops import rdb as RDB
from innfer_tpu_torch.ops import resnet_block as RB
from innfer_tpu_torch.ops.rdb import (fused_rdb, fused_rdb_padded, fused_rrdb_trunk,
                                      rdb_padded_reference, rdb_reference, res_scale,
                                      rrdb_trunk_reference)
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
@pytest.mark.parametrize("nf,gc,plus,hw", [(64, 32, False, (37, 70)), (64, 32, True, (37, 70)),
                                           (32, 16, True, (37, 70)), (24, 8, False, (37, 70)),
                                           (64, 32, False, (9, 129)), (24, 8, True, (3, 65)),
                                           (64, 32, False, (181, 1000)), (64, 32, True, (17, 63))])
def test_kernel_matches_plain_on_card(cuda_device, dtype, tol, nf, gc, plus, hw):
    ws, bs, w1 = _rdb(cuda_device, dtype, nf, gc, plus, seed=1)
    g = torch.Generator().manual_seed(2)
    x = torch.randn(2, *hw, nf, generator=g).to(cuda_device, dtype)
    before = fused_rdb.launches
    out = fused_rdb(x, ws, bs, plus=plus, conv1x1_w=w1)
    torch.cuda.synchronize()
    assert fused_rdb.launches == before + 1
    ref = rdb_reference(x, ws, bs, plus=plus, conv1x1_w=w1)
    assert (out.float() - ref.float()).abs().max().item() < tol


@pytest.mark.gpu
def test_model_kernel_path_matches_torch_path_fp32(cuda_device):
    """A small ESRGAN on the kernel (as the model chooses on CUDA) and
    inside ``ops.plain_path``, in true fp32: >= 80 dB, the golden bar."""
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
    model = get_network(get_network_config({"type": "esrgan", "nb": nb, "nf": nf, "gc": gc}, 4))
    params = convert_state(model, state, device=cuda_device)
    for path in ("kernel", "plain"):
        before = fused_rdb.launches
        with torch.no_grad(), plain_path() if path == "plain" else contextlib.nullcontext():
            outs[path] = model.apply(params, x).cpu().numpy()
        assert fused_rdb.launches - before == (nb * 3 if path == "kernel" else 0)
    mse = np.mean((outs["kernel"].astype(np.float64) - outs["plain"]) ** 2)
    assert 10 * np.log10(1.0 / mse) >= 80


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("nb,nr,plus,shape,nf,gc", [(2, 3, False, (1, 33, 45), 32, 16),
                                                   (1, 3, True, (1, 33, 45), 32, 16),
                                                   (2, 1, False, (1, 33, 45), 32, 16),
                                                   (1, 3, True, (2, 181, 300), 64, 32)])
def test_trunk_matches_plain_and_per_rdb_path_on_card(cuda_device, dtype, nb, nr, plus, shape,
                                                      nf, gc):
    from innfer_tpu_torch.ops.rdb import fused_rdb_padded

    rdbs = [[_rdb(cuda_device, dtype, nf, gc, plus, seed=10 * r + c) for c in range(nr)]
            for r in range(nb)]
    ws = [[p[0] for p in row] for row in rdbs]
    bs = [[p[1] for p in row] for row in rdbs]
    w1 = [[p[2] for p in row] for row in rdbs] if plus else None
    x = torch.randn(*shape, nf, generator=torch.Generator().manual_seed(3)).to(cuda_device, dtype)
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
def test_stack_equals_its_images_one_by_one_on_card(cuda_device, dtype):
    """fused_rdb on a stack of 8 images equals 8 single-image launches bit
    for bit: the persistent grid spreads the stack's tiles over the blocks
    in another way than one image's, and no output may depend on which."""
    ws, bs, _ = _rdb(cuda_device, dtype, 64, 32, False, seed=11)
    x = torch.randn(8, 75, 150, 64, generator=torch.Generator().manual_seed(12)).to(cuda_device,
                                                                                     dtype)
    stack = fused_rdb(x, ws, bs)
    single = torch.cat([fused_rdb(x[i: i + 1], ws, bs) for i in range(8)])
    torch.cuda.synchronize()
    assert torch.equal(stack, single)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,bias", [((2, 24, 40, 256), True), ((3, 2, 5, 32), False),
                                        ((1, 19, 23, 64), True), ((1, 11, 130, 32), True),
                                        ((2, 5, 65, 256), False), ((1, 7, 70, 128), True)])
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


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_in_place_residual_on_card(cuda_device, dtype):
    """fused_rdb_padded with res the output workspace itself: the output
    replaces the RRDB input in place, as fused_rrdb_trunk uses it."""
    nf, gc = 64, 32
    ws, bs, _ = _rdb(cuda_device, dtype, nf, gc, False, seed=6)
    g = torch.Generator().manual_seed(7)
    src = torch.randn(1, 21, 75, nf + 4 * gc, generator=g).to(cuda_device, dtype)
    out_ws = torch.randn(1, 21, 75, nf + 4 * gc, generator=g).to(cuda_device, dtype)
    ref = rdb_padded_reference(src.clone(), ws, bs, out_ws.clone(), res=out_ws.clone())
    fused_rdb_padded(src, ws, bs, out_ws, res=out_ws)
    torch.cuda.synchronize()
    tol = 1e-4 if dtype == torch.float32 else 0.05
    assert (out_ws[..., :nf].float() - ref[..., :nf].float()).abs().max().item() < tol


@pytest.mark.gpu
@pytest.mark.parametrize("shape,cin,cout", [((1, 548, 256), 64, 64), ((1, 548, 256), 64, 3),
                                            ((2, 137, 64), 64, 64), ((1, 64, 96), 3, 64)])
def test_bf16_conv_bias_route_matches_true_fp32_on_card(cuda_device, shape, cin, cout):
    """nn/functional's bf16 conv runs cuDNN in fp32 with TF32 allowed on
    bf16-valued operands (exact products), adds the fp32 bias, rounds once.
    It must give the true-fp32 route's bf16 values in >= 99.9% of outputs
    at the ESRGAN tail's shapes (4x tiles 548x256, 2x 137x64): a Winograd
    or FFT algorithm would not."""
    g = torch.Generator().manual_seed(8)
    x = torch.randn(*shape, cin, generator=g).to(cuda_device, torch.bfloat16)
    w = (torch.randn(cout, cin, 3, 3, generator=g) / math.sqrt(9 * cin)).to(cuda_device)
    b = (torch.randn(cout, generator=g) * 0.5).to(cuda_device)
    out = F.conv2d(x, w, b, padding=1)
    with true_fp32(torch.float32):
        ref = torch.nn.functional.conv2d(x.permute(0, 3, 1, 2).float(),
                                         w.to(torch.bfloat16).float(), b, padding=1)
    ref = ref.to(torch.bfloat16).permute(0, 2, 3, 1)
    assert out.dtype == torch.bfloat16
    assert (out == ref).float().mean().item() >= 0.999


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
    """A small CycleGAN on the kernel (as the model chooses on CUDA) and
    inside ``ops.plain_path``, in true fp32: >= 80 dB, the golden bar; one
    launch per block."""
    g = np.random.default_rng(5)
    state = _cyclegan_state(g)
    x = torch.from_numpy(g.random((1, 44, 60, 3), np.float32) * 2 - 1).to(cuda_device)
    outs = {}
    model = get_network(get_network_config({"type": "resnet_6blocks", "n_blocks": 2}, 1))
    params = convert_state(model, state, device=cuda_device)
    for path in ("kernel", "plain"):
        before = fused_resnet_block.launches
        with torch.no_grad(), plain_path() if path == "plain" else contextlib.nullcontext():
            outs[path] = model.apply(params, x).cpu().numpy()
        assert fused_resnet_block.launches - before == (2 if path == "kernel" else 0)
    mse = np.mean((outs["kernel"].astype(np.float64) - outs["plain"]) ** 2)
    assert 10 * np.log10(1.0 / mse) >= 80


@pytest.mark.gpu
def test_fusable_refuses_on_the_card_what_the_kernels_do_not_reach(cuda_device):
    """On real CUDA tensors the gates refuse what the kernels do not
    compute, and a wrapper called past its gate raises."""
    w = torch.zeros(32, 32, 3, 3, device=cuda_device)
    x = torch.zeros(1, 8, 8, 32, device=cuda_device)
    assert RB.fusable(x, w, w, norm_type="instance", pad_type="reflect")
    assert not RB.fusable(x, w, w, norm_type="batch", pad_type="reflect")
    ws = [torch.zeros(8 if c < 5 else 16, 16 + (c - 1) * 8, 3, 3, device=cuda_device)
          for c in range(1, 6)]
    bs = [torch.zeros(w_.shape[0], device=cuda_device) for w_ in ws]
    x = torch.zeros(1, 8, 8, 16, device=cuda_device)
    assert RDB.fusable(x, ws, bs, act_type="leakyrelu", norm_type=None)
    assert not RDB.fusable(x, ws, bs, act_type="relu", norm_type=None)
    x = torch.zeros(1, 8, 8, 48, device=cuda_device)  # C not a multiple of 32
    w = torch.zeros(48, 48, 3, 3, device=cuda_device)
    assert not RB.fusable(x, w, w, norm_type="instance", pad_type="reflect")
    with pytest.raises(ValueError, match="C % 32"):
        fused_resnet_block(x, w, None, w, None)


# ---------------------------------------------------------------------------
# The SR zoo on the card: plain ops, fp32 card vs CPU at the golden bar
# ---------------------------------------------------------------------------

def _zoo_state(family, g):
    """Tiny seeded state dicts in the reference layouts (nf=16)."""
    from tools import synth_params as SP

    seed = int(g.integers(1 << 30))
    if family == "srresnet":
        return SP.srresnet_state(nb=2, nf=16, scale=4, seed=seed), {"type": "srgan", "nb": 2,
                                                                    "nf": 16}
    if family == "pan":
        return (SP.pan_state(nb=2, nf=16, unf=8, scale=4, seed=seed),
                {"type": "pan", "nb": 2, "nf": 16, "unf": 8})
    return SP.ppon_state(nb=1, nf=16, scale=4, seed=seed), {"type": "ppon", "nb": 1, "nf": 16}


def _variant_state(g, norm, mode, act, nb=1, nf=16, gc=8):
    """A 2x ESRGAN conv_block variant, keys laid out by conv_block_layout."""
    from innfer_tpu_torch.models.common import conv_block_layout

    state = {}

    def conv(key, o, i):
        # variance 1/(3 fan_in), as tools/synth_params.py: the in-place
        # swish squares its input, and wider weights overflow fp32
        std = math.sqrt(1.0 / (9 * i))
        state[f"{key}.weight"] = g.uniform(-std, std, (o, i, 3, 3)).astype(np.float32)
        state[f"{key}.bias"] = g.uniform(-0.01, 0.01, o).astype(np.float32)

    def act_params(key):
        if act == "prelu":
            state[f"{key}.weight"] = np.full(1, 0.25, np.float32)
        elif act == "swish":
            state[f"{key}.beta"] = np.asarray(1.0, np.float32)

    def block(key_of, o, i, block_mode, block_act):
        for j, kind in enumerate(conv_block_layout(block_mode, norm, block_act)):
            c = i if block_mode == "NAC" else o
            if kind == "conv":
                conv(key_of(j), o, i)
            elif kind == "norm" and norm == "batch":
                for leaf, v in (("weight", 1), ("bias", 0), ("running_mean", 0),
                                ("running_var", 1)):
                    state[f"{key_of(j)}.{leaf}"] = (v + g.uniform(-0.1, 0.1, c)).astype(np.float32)
            elif kind == "act":
                act_params(key_of(j))

    conv("model.0", nf, 3)
    for i in range(nb):
        for j in (1, 2, 3):
            for c in range(1, 6):
                block(lambda k, i=i, j=j, c=c: f"model.1.sub.{i}.RDB{j}.conv{c}.{k}",
                      gc if c < 5 else nf, nf + (c - 1) * gc, "CNA", act if c < 5 else None)
    block(lambda k: f"model.1.sub.{nb + k}", nf, nf, mode, None)
    for ci in (3, 5):  # 2x: the upconv conv and the first HR conv, each with its act
        conv(f"model.{ci}", nf, nf)
        act_params(f"model.{ci + 1}")
    conv("model.7", 3, nf)
    return state, {"type": "esrgan", "nb": nb, "nf": nf, "gc": gc, "norm_type": norm,
                   "mode": mode, "act_type": act}


_VARIANTS = {"bn": ("batch", "CNA", "leakyrelu"), "nac_bn": ("batch", "NAC", "leakyrelu"),
             "in": ("instance", "CNA", "leakyrelu"), "prelu": (None, "CNA", "prelu"),
             "swish": (None, "CNA", "swish")}


@pytest.mark.gpu
@pytest.mark.parametrize("family", ["srresnet", "pan", "ppon", *[f"esrgan_{v}" for v in _VARIANTS]])
def test_zoo_fp32_on_card_matches_cpu(cuda_device, family):
    """True fp32 on the card against the CPU: >= 80 dB (a TF32 leak in a new
    op would give about 60); no kernel launches (none lies on these paths)."""
    g = np.random.default_rng(11)
    if family.startswith("esrgan_"):
        state, spec = _variant_state(g, *_VARIANTS[family[7:]])
        scale = 2
    else:
        (state, spec), scale = _zoo_state(family, g), 4
    model = get_network(get_network_config(spec, scale))
    x = torch.from_numpy(g.random((1, 36, 44, 3), np.float32))
    outs = []
    before = fused_rdb.launches
    for dev in (cuda_device, torch.device("cpu")):
        params = convert_state(model, state, device=dev)
        with torch.no_grad():
            out = model.apply(params, x.to(dev))
        out = out if model.output_index is None else out[model.output_index]
        outs.append(out.cpu().numpy())
    assert fused_rdb.launches == before
    peak = max(1.0, float(np.abs(outs[1]).max()))
    mse = np.mean((outs[0].astype(np.float64) - outs[1]) ** 2)
    assert mse == 0 or 10 * np.log10(peak ** 2 / mse) >= 80


@pytest.mark.gpu
def test_pan_attention_keeps_fp32_scores_in_bf16_on_card(cuda_device):
    """PAN's FSA in bf16: the scores are the fp32 products of the bf16
    projections (TF32 on bf16 values is exact), not a bf16 matmul's."""
    from innfer_tpu_torch.models import pan
    from innfer_tpu_torch.models.base import cast_params

    g = np.random.default_rng(12)
    state, spec = _zoo_state("pan", g)
    model = get_network(get_network_config(spec, 4))
    params = cast_params(convert_state(model, state, device=cuda_device), torch.bfloat16)
    x = torch.from_numpy(g.standard_normal((2, 64, 48, 16)).astype(np.float32)).to(
        cuda_device, torch.bfloat16)
    flat = F.max_pool2d(x, 4).reshape(2, -1, 16)
    f, gg, h = (F.dense(flat, params[f"FSA.conv_{n}.weight"], params[f"FSA.conv_{n}.bias"])
                for n in "fgh")
    s = F.matmul(f, gg.transpose(1, 2), out_dtype=torch.float32)
    with true_fp32(torch.float32):
        ref = torch.matmul(f.float(), gg.float().transpose(1, 2))
    assert s.dtype == torch.float32
    assert (s - ref).abs().max().item() <= 1e-5 * max(1.0, ref.abs().max().item())
    att = F.softmax(s, dim=-1).to(torch.bfloat16)
    with true_fp32(torch.float32):
        ref_out = torch.matmul(att.float(), h.float()).to(torch.bfloat16)
    out = F.matmul(att, h)
    assert (out == ref_out).float().mean().item() >= 0.999
    y = pan._fsa(params, x, "FSA")
    assert y.dtype == torch.bfloat16 and y.shape == x.shape and torch.isfinite(y.float()).all()


@pytest.mark.gpu
def test_torchscript_stage_runs_true_fp32_on_card(cuda_device, tmp_path):
    from innfer_tpu_torch.compat.torchscript import load_torchscript

    module = torch.nn.Sequential(torch.nn.Conv2d(3, 12, 3, padding=1), torch.nn.PixelShuffle(2))
    path = str(tmp_path / "m.pt")
    torch.jit.script(module).save(path)
    model, params = load_torchscript(path, device=cuda_device)
    assert model.scale == 2
    x = torch.rand(1, 40, 56, 3, device=cuda_device)
    prev = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    try:
        out = model.apply(params, x)
        seen = []

        class Spy(torch.nn.Module):
            def forward(self, t):
                seen.append((torch.backends.cudnn.allow_tf32,
                             torch.backends.cuda.matmul.allow_tf32))
                return t

        real, params["module"] = params["module"], Spy()
        model.apply(params, x)
        params["module"] = real
        assert seen == [(False, False)]
        assert torch.backends.cudnn.allow_tf32 and torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = prev
    module = module.to(cuda_device)
    with torch.no_grad(), true_fp32(torch.float32):
        ref = module(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert (out - ref).abs().max().item() <= 1e-6


@pytest.mark.gpu
@pytest.mark.parametrize("variant,mode,launches", [
    ("leakyrelu", "hybrid", 3), ("in", "auto", 0), ("prelu", "auto", 0), ("srresnet", "auto", 0)])
def test_auto_gate_on_card(cuda_device, variant, mode, launches):
    """TiledRunner in auto mode on CUDA tensors, built as the session builds
    it: hybrid only where the trunk runs the fused RDB."""
    from innfer_tpu_torch.tiling.engine import TiledRunner

    g = np.random.default_rng(13)
    if variant == "srresnet":
        state, spec = _zoo_state("srresnet", g)
        scale = 4
    else:
        norm, act = {"leakyrelu": (None, "leakyrelu"), "in": ("instance", "leakyrelu"),
                     "prelu": (None, "prelu")}[variant]
        state, spec = _variant_state(g, norm, "CNA", act)
        scale = 2
    model = get_network(get_network_config(spec, scale))
    params = convert_state(model, state, device=cuda_device)
    runner = TiledRunner(model.apply, model.scale, mode="auto", trunk_fn=model.apply_trunk,
                         tail_fn=model.apply_tail, tail_halo=model.tail_halo,
                         trunk_kernel=model.trunk_kernel)
    before = fused_rdb.launches
    with torch.no_grad():
        out = runner(params, torch.rand(1, 40, 56, 3, device=cuda_device))
    torch.cuda.synchronize()
    assert runner.last_mode == mode
    assert fused_rdb.launches - before == launches
    assert out.shape == (1, 40 * scale, 56 * scale, 3)


@pytest.mark.gpu
@pytest.mark.parametrize("family", ["unet_bn", "wbc_pt", "wbc_tf"])
def test_i2i_fp32_on_card_matches_cpu(cuda_device, family):
    """The pix2pix UNet (train-mode batch norm) and WBC in true fp32 on the
    card against the CPU: >= 80 dB, no kernel launches."""
    from tools import synth_params as SP

    g = np.random.default_rng(14)
    if family == "unet_bn":
        state = SP.unet_state(num_downs=6, ngf=16, seed=1)
        cfg = get_network_config({"type": "unet_net", "num_downs": 6, "ngf": 16}, 1)
        cfg["meval"] = False
        x = g.uniform(-1, 1, (1, 64, 128, 3))
    else:
        state = SP.wbc_state(nf=32, seed=2)
        cfg = get_network_config({"type": "wbcunet", "mode": family[4:]}, 1)
        x = g.uniform(-1, 1, (1, 36, 44, 3))
    model = get_network(cfg)
    x = torch.from_numpy(x.astype(np.float32))
    outs = []
    before = fused_rdb.launches, fused_resnet_block.launches
    for dev in (cuda_device, torch.device("cpu")):
        with torch.no_grad():
            outs.append(model.apply(convert_state(model, state, device=dev), x.to(dev)).cpu().numpy())
    assert (fused_rdb.launches, fused_resnet_block.launches) == before
    peak = max(1.0, float(np.abs(outs[1]).max()))
    mse = np.mean((outs[0].astype(np.float64) - outs[1]) ** 2)
    assert mse == 0 or 10 * np.log10(peak ** 2 / mse) >= 80


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_guided_filter_and_color_fix_on_card_match_cpu(cuda_device, dtype):
    """The WBC guided filter (r=1, eps=5e-3) and color_fix on the card
    against the CPU on the same inputs: the fp32 guided filter >= 80 dB
    (TF32 in its box filters would show in cov_xy), the u8 results within
    one level in >= 99.9% of values."""
    from innfer_tpu_torch.ops.filters import color_fix, guided_filter

    g = np.random.default_rng(15)
    x = torch.from_numpy(g.uniform(-1, 1, (1, 96, 128, 3)).astype(np.float32)).to(dtype)
    y = torch.from_numpy(g.uniform(-1, 1, (1, 96, 128, 3)).astype(np.float32)).to(dtype)
    gf = [guided_filter(x.to(d), y.to(d), r=1, eps=5e-3).float().cpu().numpy()
          for d in (cuda_device, torch.device("cpu"))]
    if dtype == torch.float32:
        mse = np.mean((gf[0].astype(np.float64) - gf[1]) ** 2)
        assert mse == 0 or 10 * np.log10(max(1.0, np.abs(gf[1]).max()) ** 2 / mse) >= 80
    else:
        assert (np.abs(gf[0] - gf[1]) <= 2 ** -7 * (np.abs(gf[1]) + 1)).all()
    ref = torch.from_numpy(g.integers(0, 256, (48, 64, 3), dtype=np.uint8))
    for out in (torch.from_numpy(g.integers(0, 256, (192, 256, 3), dtype=np.uint8)),
                torch.from_numpy(g.integers(0, 256, (48, 64, 3), dtype=np.uint8))):
        a = color_fix(ref.to(cuda_device), out.to(cuda_device)).cpu().numpy().astype(int)
        b = color_fix(ref, out).numpy().astype(int)
        assert (np.abs(a - b) <= 1).mean() >= 0.999


# ---------------------------------------------------------------------------
# The batched directory path on the card
# ---------------------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_resnet_block_stack_of_32_equals_single_launches_on_card(cuda_device, dtype):
    """One launch over a stack of 32 images equals 32 one-image launches to
    the last bit: instance norm's statistics are per image, and nothing
    the kernel sums may depend on B (whole-image CycleGAN stacks and
    cross-image tile groups reach it at B up to 32)."""
    g = torch.Generator().manual_seed(16)
    c = 256
    w1, w2 = ((torch.randn(c, c, 3, 3, generator=g) * 0.02).to(cuda_device, dtype)
              for _ in range(2))
    b1, b2 = ((torch.randn(c, generator=g) * 0.1).to(cuda_device) for _ in range(2))
    x = torch.randn(32, 20, 36, c, generator=g).to(cuda_device, dtype)
    before = fused_resnet_block.launches
    stack = fused_resnet_block(x, w1, b1, w2, b2)
    singles = torch.cat([fused_resnet_block(x[i: i + 1].contiguous(), w1, b1, w2, b2)
                         for i in range(32)])
    torch.cuda.synchronize()
    assert fused_resnet_block.launches - before == 33
    assert torch.equal(stack, singles)


def _golden(name):
    import os.path as osp

    return osp.join(osp.dirname(__file__), "goldens", name)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("family", ["pix2pix", "cyclegan"])
def test_run_batch_on_card_matches_per_image(cuda_device, monkeypatch, family, dtype):
    """run_batch on the card against the same images one at a time, u8
    within one level (bf16: in 99.9%): pix2pix's whole-image stack (train-mode batch norm
    per image), CycleGAN's whole-image stack against whole-image solo
    runs and its cross-image tile stack against tiled solo runs, with the
    kernel's launches (9 per forward or tile group)."""
    from innfer_tpu_torch.pipeline import InferenceSession, select_presets

    arch, ckpt = (("unet_128", "unet128.pth") if family == "pix2pix"
                  else ("resnet_9blocks", "cyclegan9.pth"))
    imgs = [np.random.default_rng(s).integers(0, 256, (40, 48, 3), dtype=np.uint8)
            for s in range(4)]

    def session(chop):
        p = select_presets(arch)
        p.chop = p.chop and chop
        return InferenceSession(_golden(ckpt), arch=arch, presets=p, compute_dtype=dtype,
                                tile=32, overlap=8, tile_batch=2)

    def close(a, b):
        # fp32: every value within one level; bf16: a conv of another batch
        # size may sum in another order, and a one-ulp flip of a bf16
        # intermediate can carry past one level at a few pixels
        d = np.abs(a.astype(int) - b.astype(int))
        assert a.shape == b.shape
        assert d.max() <= 1 if dtype == torch.float32 else (d <= 1).mean() >= 0.999

    sess, whole = session(True), session(False)
    before = fused_resnet_block.launches
    with torch.no_grad():
        outs = sess.run_batch(imgs)
        stacked = fused_resnet_block.launches - before
        for o, im in zip(outs, imgs):
            close(o, whole.run_image(im))
        if family == "cyclegan":
            assert stacked == 9  # one whole-image forward of the stack
            monkeypatch.setattr(sess, "batchable", lambda shape, n: False)
            plan = sess.stages[0].runner.plan_for(40, 48, on_cuda=True)
            from innfer_tpu_torch.tiling.engine import group_chunk

            chunk = group_chunk(plan, len(imgs), tile_batch=2)
            before = fused_resnet_block.launches
            tiled = sess.run_batch(imgs)
            assert fused_resnet_block.launches - before == 9 * -(-plan.n_tiles * 4 // chunk)
            for o, im in zip(tiled, imgs):
                close(o, sess.run_image(im))
        else:
            assert stacked == 0


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_conv3d_card_matches_cpu(cuda_device, dtype):
    """evsrgan's Conv3d on the card against the CPU: fp32 within 1e-4 (true
    fp32 both sides), bf16 the same rounding point (fp32 accumulator and
    bias, one rounding) in >= 99% of values."""
    g = torch.Generator().manual_seed(5)
    x = torch.randn(1, 3, 17, 23, 24, generator=g)
    w = torch.randn(16, 24, 3, 3, 3, generator=g) * 0.1
    b = torch.randn(16, generator=g)
    ref = F.conv3d(x.to(dtype), w.to(dtype), b, padding=1).float()
    out = F.conv3d(x.to(cuda_device, dtype), w.to(cuda_device, dtype), b.to(cuda_device),
                   padding=1).float().cpu()
    assert out.shape == ref.shape
    if dtype == torch.float32:
        assert (out - ref).abs().max().item() < 1e-4
    else:
        assert (out == ref).float().mean().item() >= 0.99


def _force_tail(monkeypatch, form):
    from innfer_tpu_torch.models import common as C
    from innfer_tpu_torch.nn import phase as PH

    if form == "a":
        monkeypatch.setattr(C, "upconv_collapse_ok", lambda *a, **k: False)
    if form in "ab":
        monkeypatch.setattr(C, "phase_tail_ok", lambda *a, **k: False)
    if form == "d":
        monkeypatch.setattr(C, "phase_hr_conv", lambda params, p, key, r=2, act=None: F.act(
            act, PH.phase_conv3x3_dense(p, params[f"{key}.weight"], params.get(f"{key}.bias"), r)))


@pytest.mark.gpu
@pytest.mark.parametrize("form", ["a", "b", "c", "d"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_tail_forms_card_match_cpu(cuda_device, monkeypatch, form, dtype):
    """Each tail form (a plain, b collapsed upconv, c phase tail, d dense
    phase conv) of a 4x ESRGAN tail on the card against the same form on
    the CPU: fp32 >= 80 dB (a TF32 leak gives about 60), bf16 >= 40 dB.
    In bf16 the card runs the tail's 2x convs on the tail conv kernel: both
    collapsed upsample blocks in form b, the upsample block, the phase
    tail's first conv, its HR conv and conv_last in form c, the first two in
    form d (the dense HR convs stay plain); fp32 never."""
    from innfer_tpu_torch.ops.tail_conv import tail_conv
    g = np.random.default_rng(6)
    nf = 32
    state = {}
    for key, o in (("model.3", nf), ("model.6", nf), ("model.8", nf), ("model.10", 3)):
        std = math.sqrt(3.0 / (9 * nf))
        state[f"{key}.weight"] = torch.from_numpy(g.uniform(-std, std, (o, nf, 3, 3)).astype(np.float32))
        state[f"{key}.bias"] = torch.from_numpy(g.uniform(-0.01, 0.01, o).astype(np.float32))
    model = get_network(get_network_config({"type": "esrgan", "nb": 1, "nf": nf}, 4))
    h = torch.from_numpy(g.standard_normal((2, 30, 44, nf)).astype(np.float32) * 0.5)
    _force_tail(monkeypatch, form)
    outs = []
    before = tail_conv.launches
    for dev in (cuda_device, torch.device("cpu")):
        params = convert_state(model, state, param_dtype=dtype, device=dev)
        with torch.no_grad():
            outs.append(model.apply_tail(params, h.to(dev, dtype)).float().cpu())
    fused = {"a": 0, "b": 2, "c": 4, "d": 2}[form] if dtype == torch.bfloat16 else 0
    assert tail_conv.launches - before == fused
    mse = (outs[0] - outs[1]).double().square().mean().item()
    peak = max(1.0, outs[1].abs().max().item())
    db = math.inf if mse == 0 else 10 * math.log10(peak ** 2 / mse)
    assert outs[0].shape == (2, 120, 176, 3)
    assert db >= (80 if dtype == torch.float32 else 40)


def _within_one_ulp(out, ref):
    """Every value within one bf16 ulp of the plain version's, plus 1e-3 of
    its peak for values near 0 (the fp32 sums differ in order only, so a
    rounding may flip), and nearly all equal."""
    out, ref = out.float(), ref.float()
    assert out.shape == ref.shape
    tol = 2 ** -7 * ref.abs() + 1e-3 * max(1.0, ref.abs().max().item())
    assert ((out - ref).abs() <= tol).all().item()
    assert (out == ref).float().mean().item() >= 0.97


@pytest.mark.gpu
@pytest.mark.parametrize("mode,b,hg,wg,nf,cp,act", [
    ("phase", 1, 9, 70, 64, 64, "leakyrelu"), ("phase", 4, 5, 33, 64, 3, None),
    ("phase", 1, 17, 130, 32, 32, "relu"), ("phase", 4, 3, 7, 16, 3, None),
    ("upconv", 4, 11, 67, 64, 64, "leakyrelu"), ("upconv", 1, 6, 5, 32, 32, None),
    ("pixelshuffle", 1, 7, 9, 64, 3, "lrelu"), ("pixelshuffle", 4, 13, 65, 16, 16, None)])
def test_tail_conv_matches_plain_on_card(cuda_device, mode, b, hg, wg, nf, cp, act):
    """The tail conv kernel against the plain composition on the card at
    ragged sizes (odd grids, several 64-column tiles or part of one, B of 1
    and 4), in every mode and layout it has: the HR conv on the phase-major
    grid, the collapsed upconv and the pixelshuffle conv written phase-major
    and pixel-shuffled, cout 3 to 64 a phase, act None, LeakyReLU, ReLU."""
    from innfer_tpu_torch.nn import phase as PH
    from innfer_tpu_torch.ops import tail_conv as TC

    g = torch.Generator().manual_seed(hg * wg + nf + cp)
    b_ = torch.randn(cp if mode != "pixelshuffle" else 4 * cp, generator=g) * 0.1
    if mode == "phase":
        x = torch.randn(b, hg, wg, 4 * nf, generator=g).to(cuda_device, torch.bfloat16)
        w = (torch.randn(cp, nf, 3, 3, generator=g) / (3 * nf ** 0.5)).to(cuda_device,
                                                                         torch.bfloat16)
        packed = TC.pack_phase(w, b_.to(cuda_device))
        before = TC.tail_conv.launches
        out = TC.tail_conv(x, packed, act=act, layout="phase")
        ref = F.act(act, PH.phase_conv3x3(x, w, b_.to(cuda_device)))
        _within_one_ulp(out, ref)
        _within_one_ulp(TC.tail_conv(x, packed, act=act, layout="shuffle"),
                        PH.phase_shuffle_out(ref))
        assert TC.tail_conv.launches - before == 2
        return
    x = torch.randn(b, hg, wg, nf, generator=g).to(cuda_device, torch.bfloat16)
    if mode == "upconv":
        w = (torch.randn(cp, nf, 3, 3, generator=g) / (3 * nf ** 0.5)).to(torch.bfloat16)
        w2 = C.collapse_upconv_weight(w, None, 2)[0]
        wpm, bpm = PH.cmajor_to_phase_major(w2), PH.phase_bias(b_)
        bc = b_.repeat_interleave(4)
    else:
        w2 = (torch.randn(4 * cp, nf, 3, 3, generator=g) / (3 * nf ** 0.5)).to(torch.bfloat16)
        wpm, bpm, bc = PH.cmajor_to_phase_major(w2), PH.cmajor_bias_to_phase_major(b_), b_
    packed = TC.pack_plain(wpm.to(cuda_device), bpm.to(cuda_device))
    w2, bc = w2.to(cuda_device), bc.to(cuda_device)
    _within_one_ulp(TC.tail_conv(x, packed, act=act, layout="shuffle"),
                    F.act(act, F.pixel_shuffle(F.conv2d(x, w2, bc, padding=1), 2)))
    _within_one_ulp(TC.tail_conv(x, packed, act=act, layout="phase"),
                    F.act(act, F.conv2d(x, wpm.to(cuda_device), bpm.to(cuda_device),
                                        padding=1)))


@pytest.mark.gpu
def test_esrgan_x4_tail_runs_only_the_tail_conv_on_card(cuda_device):
    """The bf16 4x ESRGAN tail (nf 64) on the card under the profiler: the
    tracer counts every conv of the tail as fused, and the device runs the
    tail conv kernel four times and the final 3-channel shuffle, with no
    cuDNN conv, no concatenation, no pixel-shuffle copy and no separate bias
    or activation pass."""
    from innfer_tpu_torch import observability as obs
    from innfer_tpu_torch.ops.tail_conv import tail_conv

    g = np.random.default_rng(8)
    nf = 64
    state = {}
    for key, o in (("model.3", nf), ("model.6", nf), ("model.8", nf), ("model.10", 3)):
        std = math.sqrt(3.0 / (9 * nf))
        state[f"{key}.weight"] = torch.from_numpy(g.uniform(-std, std, (o, nf, 3, 3)).astype(np.float32))
        state[f"{key}.bias"] = torch.from_numpy(g.uniform(-0.01, 0.01, o).astype(np.float32))
    model = get_network(get_network_config({"type": "esrgan", "nb": 1, "nf": nf}, 4))
    params = convert_state(model, state, param_dtype=torch.bfloat16, device=cuda_device)
    h = torch.from_numpy(g.standard_normal((2, 36, 70, nf)).astype(np.float32)).to(
        cuda_device, torch.bfloat16)
    with torch.no_grad():
        model.apply_tail(params, h)  # packs the weights
        torch.cuda.synchronize()
        obs.reset()
        before = tail_conv.launches
        try:
            with torch.profiler.profile(activities=[
                    torch.profiler.ProfilerActivity.CPU,
                    torch.profiler.ProfilerActivity.CUDA]) as prof:
                out = model.apply_tail(params, h)
                torch.cuda.synchronize()
            counters = obs.summary()["counters"]
        finally:
            obs.reset()
    assert out.shape == (2, 144, 280, 3)
    assert counters["tail_convs"] == counters["tail_convs_fused"] == 4
    assert tail_conv.launches - before == 4
    kernels = [e.name for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA and "Memcpy" not in e.name
               and "Memset" not in e.name]
    assert sum("conv_tail" in k for k in kernels) == 4, kernels
    others = [k for k in kernels if "conv_tail" not in k]
    assert len(others) <= 1, others


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 0.05)])
def test_halo_conv_on_a_virtual_card_mesh(cuda_device, dtype, tol):
    """halo_conv2d over 4 shards of one card against the unsharded conv:
    the same accumulate route, only the conv's summation order may differ
    (fp32 true fp32, bf16 one rounding of the fp32 sum)."""
    from innfer_tpu_torch.parallel.mesh import make_mesh
    from innfer_tpu_torch.parallel.spatial import halo_conv2d

    g = torch.Generator().manual_seed(11)
    x = torch.randn(1, 68, 96, 64, generator=g).to(cuda_device, dtype)
    w = (torch.randn(64, 64, 3, 3, generator=g) / 24).to(cuda_device, dtype)
    b = (torch.randn(64, generator=g) * 0.02).to(cuda_device)
    mesh = make_mesh(4, devices=[cuda_device] * 4)
    out = halo_conv2d(x, w, b, mesh=mesh)
    ref = F.conv2d(x, w, b, padding=1)
    assert out.shape == ref.shape and out.device == x.device
    assert (out.float() - ref.float()).abs().max().item() <= tol * max(1.0, ref.abs().max().item())


def _small_esrgan(dev, nb):
    """A seeded 4x ESRGAN (nf=32, gc=16), its params and a 56x72 input on
    ``dev``."""
    g = np.random.default_rng(12)
    nf, gc = 32, 16
    state = {}

    def conv(key, o, i):
        std = math.sqrt(3.0 / (9 * i))
        state[f"{key}.weight"] = g.uniform(-std, std, (o, i, 3, 3)).astype(np.float32)
        state[f"{key}.bias"] = g.uniform(-0.01, 0.01, o).astype(np.float32)

    conv("model.0", nf, 3)
    for j in (1, 2, 3):
        for c in range(1, 6):
            conv(f"model.1.sub.0.RDB{j}.conv{c}.0", gc if c < 5 else nf, nf + (c - 1) * gc)
    for k in (f"model.1.sub.{nb}", "model.3", "model.6", "model.8"):
        conv(k, nf, nf)
    conv("model.10", 3, nf)
    model = get_network(get_network_config({"type": "esrgan", "nb": nb, "nf": nf, "gc": gc}, 4))
    params = convert_state(model, state, device=dev)
    x = torch.from_numpy(g.random((1, 56, 72, 3), np.float32)).to(dev)
    return model, params, x


@pytest.mark.gpu
def test_dp_tile_split_on_a_virtual_card_mesh(cuda_device):
    """A small ESRGAN's tile groups split over 4 data slices of one card:
    fp32 within 1e-5 of the mesh-free runner, and the kernel launches 3 nb
    times per slice run."""
    from innfer_tpu_torch.parallel.mesh import make_mesh, replicate_params
    from innfer_tpu_torch.tiling.engine import TiledRunner

    nb = 1
    model, params, x = _small_esrgan(cuda_device, nb)
    mesh = make_mesh(4, devices=[cuda_device] * 4)
    kw = dict(mode="uniform", tile=24, overlap=8, tile_batch=8)
    single = TiledRunner(model.apply, 4, **kw)
    sharded = TiledRunner(model.apply, 4, mesh=mesh, **kw)
    with torch.no_grad():
        ref = single(params, x)
        before = fused_rdb.launches
        out = sharded(replicate_params(params, mesh), x)
        torch.cuda.synchronize()
    n = single.plan_for(56, 72).n_tiles
    slices = sum(min(4, min(8, n - i)) for i in range(0, n, 8))
    assert fused_rdb.launches - before == 3 * nb * slices
    assert (out - ref).abs().max().item() <= 1e-5


@pytest.fixture
def two_cards():
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    return [torch.device("cuda", 0), torch.device("cuda", 1)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 0.05)])
def test_kernels_launch_on_a_card_that_is_not_current(two_cards, dtype, tol):
    """Both kernels on cuda:0, then on tensors of cuda:1 while cuda:0 is
    current: the wrapper makes the tensor's card current for the launch,
    and the conv core sets its shared-memory attribute on each card."""
    torch.cuda.set_device(two_cards[0])
    for dev in two_cards:
        ws, bs, w1 = _rdb(dev, dtype, 64, 32, True, 5)
        x = torch.randn(2, 19, 70, 64, generator=torch.Generator().manual_seed(6)).to(dev, dtype)
        out = fused_rdb(x, ws, bs, plus=True, conv1x1_w=w1)
        ref = rdb_reference(x, ws, bs, plus=True, conv1x1_w=w1)
        assert torch.cuda.current_device() == 0 and out.device == dev
        assert (out.float() - ref.float()).abs().max().item() <= tol
        g = torch.Generator().manual_seed(7)
        xb = torch.randn(2, 12, 20, 256, generator=g).to(dev, dtype)
        w = [(torch.randn(256, 256, 3, 3, generator=g) * 0.02).to(dev, dtype) for _ in range(2)]
        b = [(torch.randn(256, generator=g) * 0.1).to(dev) for _ in range(2)]
        out = fused_resnet_block(xb, w[0], b[0], w[1], b[1])
        ref = resnet_block_reference(xb, w[0], b[0], w[1], b[1]).float()
        d = (out.float() - ref).abs()
        if dtype == torch.float32:
            assert d.max().item() < 1e-4
        else:
            assert (d <= 2.0 ** -7 * (ref.abs() + (ref - xb.float()).abs() + 1)).all()


@pytest.mark.gpu
def test_dp_and_tp_across_two_cards(two_cards):
    """The tile groups split over a (cuda:0, cuda:1) data mesh, and the
    convs tp-sharded over a (1 x 2) mesh of the two cards, each against
    the mesh-free runner on cuda:0: fp32 within 1e-5, the kernel launched
    on both cards' slices."""
    from innfer_tpu_torch.parallel.mesh import make_mesh, replicate_params, tp_shard_params
    from innfer_tpu_torch.tiling.engine import TiledRunner

    nb = 1
    model, params, x = _small_esrgan(two_cards[0], nb)
    kw = dict(mode="uniform", tile=24, overlap=8, tile_batch=8)
    with torch.no_grad():
        ref = TiledRunner(model.apply, 4, **kw)(params, x)
        dp = make_mesh(2, devices=two_cards)
        runner = TiledRunner(model.apply, 4, mesh=dp, **kw)
        before = fused_rdb.launches
        out = runner(replicate_params(params, dp), x)
        torch.cuda.synchronize()
        n = runner.plan_for(56, 72).n_tiles
        slices = sum(min(2, min(8, n - i)) for i in range(0, n, 8))
        assert fused_rdb.launches - before == 3 * nb * slices
        assert out.device == x.device and (out - ref).abs().max().item() <= 1e-5
        tp = make_mesh(1, 2, devices=two_cards)
        out = TiledRunner(model.apply, 4, mesh=tp, **kw)(
            tp_shard_params(params, tp, transposed=model.transposed_keys), x)
        torch.cuda.synchronize()
    assert (out - ref).abs().max().item() <= 1e-5


@pytest.fixture
def native_codec(cuda_device):
    """The native host codec on the card's machine, built there at first use
    from the repo's sources on g++ and zlib: a failure where both are
    present, a skip only where one is missing."""
    import shutil

    from innfer_tpu_torch.runtime import native

    if not native.available():
        reason = native.unavailable_reason()
        print(f"native codec unavailable: {reason}")
        if shutil.which(native.CXX) and not set(native.REQUIRED) & set(native.missing_headers()):
            pytest.fail(f"g++ and zlib.h are here, yet the native codec is unavailable: {reason}")
        pytest.skip(f"native codec unavailable: {reason}")
    return native


@pytest.mark.gpu
def test_native_and_opencv_decode_the_same_png_on_the_cards_host(native_codec, tmp_path):
    cv2 = pytest.importorskip("cv2")
    from innfer_tpu_torch.io import images as iio

    rng = np.random.default_rng(9)
    for shape, dtype in (((61, 83, 3), np.uint8), ((61, 83, 4), np.uint8), ((61, 83), np.uint8),
                         ((17, 19, 3), np.uint16)):
        img = rng.integers(0, np.iinfo(dtype).max, shape, dtype=dtype)
        path = str(tmp_path / "x.png")
        assert cv2.imwrite(path, img)
        ours = native_codec.decode(path)
        assert ours is not None and ours.dtype == dtype
        np.testing.assert_array_equal(ours, cv2.imread(path, cv2.IMREAD_UNCHANGED))
        np.testing.assert_array_equal(ours, img)
        if dtype == np.uint8:  # and what the native encoder writes, OpenCV reads
            assert native_codec.encode_png(path, img)
            np.testing.assert_array_equal(cv2.imread(path, cv2.IMREAD_UNCHANGED), img)
    assert iio.codec_name().startswith(f"native ({native_codec.version()}) + ")


@pytest.mark.gpu
def test_bench_esrgan_goes_through_its_kernel_and_meets_its_bars(cuda_device, capsys):
    """bench_torch.py's headline config at 540x960: 69 fused_rdb launches per
    step (hybrid), bf16 against fp32 >= 30 dB and against the plain
    versions of the kernel in bf16 >= 40 dB."""
    import bench_torch

    line = bench_torch.main(["--model", "esrgan", "--height", "540", "--width", "960",
                             "--iters", "2"])
    assert line["device"]["platform"] == "gpu" and "W" in line["device"]["power_limit"]
    assert line["launches"]["fused_rdb"] == 69
    assert line["fidelity_ok"] and line["fidelity_db"] >= 30 and line["kernel_vs_plain_db"] >= 40
    assert line["n"] == 2 and line["value"] > 0


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_pix2pix_passes_are_bit_identical(cuda_device, tmp_path, monkeypatch, dtype):
    """C4: the pix2pix UNet's transposed convs run as cuDNN backward-data
    convs; with cuDNN free to pick a non-deterministic algorithm the H100
    gave fp32 u8 outputs one level apart between two passes.  The session
    must ask cuDNN for deterministic algorithms (reference run.py:337),
    whatever the flags were."""
    from innfer_tpu_torch.pipeline import InferenceSession
    from innfer_tpu_torch.tools import synth_params as SP

    monkeypatch.setattr(torch.backends.cudnn, "benchmark", False)
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", False)
    ckpt = str(tmp_path / "p2p_unet256.pth")
    torch.save({k: torch.from_numpy(v) for k, v in SP.unet_state(ngf=64).items()}, ckpt)
    sess = InferenceSession(ckpt, arch="unet_256", compute_dtype=dtype)
    rng = np.random.default_rng(3)
    imgs = [rng.integers(0, 256, (256, 256, 3), dtype=np.uint8) for _ in range(8)]
    first = np.stack(sess.run_batch(imgs))
    for _ in range(3):
        np.testing.assert_array_equal(np.stack(sess.run_batch(imgs)), first)


@pytest.mark.gpu
def test_frame_spans_on_card(cuda_device, tmp_path, monkeypatch):
    """The nb=23 4x ESRGAN at 540x960 in bf16, auto -> hybrid, two frames
    under the profiler: one ``innfer.frame`` per frame, every span's device
    ms within its parent's, and every ``fused_rdb`` call inside an
    ``innfer.trunk`` span (its host interval)."""
    from innfer_tpu_torch import observability as obs
    from innfer_tpu_torch.models import rrdb
    from innfer_tpu_torch.pipeline import InferenceSession
    from innfer_tpu_torch.tools import synth_params as SP

    ckpt = str(tmp_path / "4x_esrgan_synth.pth")
    torch.save({k: torch.from_numpy(v) for k, v in SP.esrgan_state().items()}, ckpt)
    sess = InferenceSession(ckpt, tile_mode="auto")
    img = np.random.default_rng(5).integers(0, 256, (540, 960, 3), dtype=np.uint8)
    with torch.no_grad():
        sess.run_image(img)
    calls, real = [], rrdb.fused_rdb

    def spy(*a, **kw):
        calls.append(time.perf_counter_ns())
        return real(*a, **kw)

    monkeypatch.setattr(rrdb, "fused_rdb", spy)
    obs.reset()
    before = fused_rdb.launches
    try:
        with torch.no_grad(), torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]):
            outs = [sess.run_image(img) for _ in range(2)]
        torch.cuda.synchronize()
        assert all(o.shape == (2160, 3840, 3) for o in outs)
        s = obs.summary()
        recs = [r for r in obs.TRACER.records if r.t1 is not None]
        assert s["spans"]["innfer.frame"]["count"] == 2
        assert s["spans"]["innfer.trunk"]["count"] == 2
        for r in recs:
            if r.parent is not None and r.events is not None and r.parent.events is not None:
                assert r.device_ms() <= r.parent.device_ms() + 1e-3, (r.name, r.parent.name)
        trunks = [r for r in recs if r.name == "innfer.trunk"]
        assert fused_rdb.launches - before == len(calls) == 138
        assert all(any(t.t0 <= c <= t.t1 for t in trunks) for c in calls)
        assert all(row["device_ms"] is not None for name, row in s["spans"].items()
                   if name != "innfer.fetch")
    finally:
        obs.reset()


def _ppon_block(dev, seed=5):
    """One nf-64 PPON block's (c1, d1..d8, c2) weights and fp32 biases, bf16
    on ``dev``, and the model's params and prefix for its plain path."""
    from innfer_tpu_torch.models import ppon as PP
    from innfer_tpu_torch.models.base import ParamDict, cast_params
    from innfer_tpu_torch.tools import synth_params as SP

    state = SP.ppon_state(nb=1, nf=64, scale=4, seed=seed)
    params = cast_params(ParamDict({k: torch.from_numpy(np.asarray(v)).to(dev)
                                    for k, v in state.items()}), torch.bfloat16)
    prefix = "CFEM.1.sub.0.RB1"
    return params, prefix, PP._block_params(params, prefix)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(1, 576, 960, 64), (2, 37, 101, 64), (1, 9, 70, 64),
                                   (1, 20, 12, 64), (1, 17, 70, 64), (3, 40, 52, 64)])
@pytest.mark.parametrize("with_res", [False, True])
def test_dilated_block_matches_plain_on_card(cuda_device, shape, with_res):
    """fused_dilated_block at the PPON cell's trunk shape and at ragged ones
    (c1's 8-row and 64-column tiles and the dilated convs' 16 x 24 tiles in
    part; an image narrower than the dilated convs' 40-column halo box, so
    its zero fill reaches both sides; a last tile row of one row, and a last
    tile column of 22 of 24; B of 2 and 3, tiles walking across images),
    plain and with the RRBlock's residual, against the
    model's plain bf16 path (cuDNN's TF32 tensor-core convs through the
    bias route) and against its plain composition with exact (float64)
    sums: every value within one bf16 ulp of both, >= 99.9% of values equal
    to the plain path, and at least as many equal to the exact sums as the
    plain path has.  Tensor-core MMAs add their products without rounding
    to nearest, so the kernel and cuDNN's tensor-core convs share an error
    that exact sums lack: on an H100 the plain path itself matches the
    exact composition in 99.77-99.99% of values, below 99.9% at the cell's
    shape."""
    from innfer_tpu_torch.models import ppon as PP
    from innfer_tpu_torch.ops import dilated_block as DB

    params, prefix, (w, b) = _ppon_block(cuda_device)
    g = torch.Generator().manual_seed(sum(shape))
    x = torch.randn(*shape, generator=g).to(cuda_device, torch.bfloat16)
    res = torch.randn(*shape, generator=g).to(cuda_device, torch.bfloat16) if with_res else None
    before = DB.fused_dilated_block.launches
    with torch.no_grad():
        out = DB.fused_dilated_block(x, w, b, res=res, packed=DB.pack_block(w, b))
        ref = DB.dilated_block_reference(x, w, b, res=res, acc=torch.float64)
        with plain_path():
            plain = PP._res_block_32(params, x, prefix, res=res)
    torch.cuda.synchronize()
    assert DB.fused_dilated_block.launches - before == 1
    share = lambda a, c: (a == c).float().mean().item()  # noqa: E731
    for want in (plain, ref):
        _within_one_ulp(out, want)
    assert share(out, plain) >= 0.999
    assert share(out, ref) >= share(plain, ref)


@pytest.mark.gpu
def test_ppon_runs_its_blocks_and_tails_on_the_kernels_on_card(cuda_device):
    """The bf16 nf-64 PPON through the runner's auto mode on the card: it goes
    hybrid, the tracer counts every block and every tail conv as fused,
    and the device runs the block kernel's launches and the tail conv's,
    with no cuDNN conv but the trunk's first and LR convs."""
    from innfer_tpu_torch import observability as obs
    from innfer_tpu_torch.ops import dilated_block as DB
    from innfer_tpu_torch.ops.tail_conv import tail_conv
    from innfer_tpu_torch.tiling.engine import TiledRunner
    from innfer_tpu_torch.tools import synth_params as SP

    model = get_network(get_network_config({"type": "ppon", "nb": 1, "nf": 64}, 4))
    params = convert_state(model, SP.ppon_state(nb=1, nf=64, scale=4, seed=9),
                           param_dtype=torch.bfloat16, device=cuda_device)
    runner = TiledRunner(model.apply, model.scale, mode="auto", trunk_fn=model.apply_trunk,
                         tail_fn=model.apply_tail, tail_halo=model.tail_halo,
                         trunk_kernel=model.trunk_kernel, output_index=model.output_index,
                         compute_dtype=torch.bfloat16)
    x = torch.rand(1, 40, 300, 3, device=cuda_device)
    with torch.no_grad():
        runner(params, x)
        torch.cuda.synchronize()
        obs.reset()
        blocks, tails = DB.fused_dilated_block.launches, tail_conv.launches
        try:
            with torch.profiler.profile(activities=[
                    torch.profiler.ProfilerActivity.CPU,
                    torch.profiler.ProfilerActivity.CUDA]) as prof:
                out = runner(params, x)
                torch.cuda.synchronize()
            counters = obs.summary()["counters"]
        finally:
            obs.reset()
    assert runner.last_mode == "hybrid"
    assert out.shape == (1, 160, 1200, 3) and torch.isfinite(out).all()
    assert counters["dilated_blocks"] == counters["dilated_blocks_fused"] == 15
    assert counters["tail_convs"] == counters["tail_convs_fused"] == 12
    assert DB.fused_dilated_block.launches - blocks == 15
    groups = tail_conv.launches - tails
    assert groups % 12 == 0 and groups > 0
    kernels = [e.name for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    assert sum("dilated_block_" in k for k in kernels) == 15 * 3   # c1, the rates, c2
    convs = [k for k in kernels if "conv" in k.lower() and "dilated_block_" not in k
             and "conv_tail" not in k]
    assert len(convs) <= 4, convs


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(8, 552, 256, 64), (8, 276, 128, 128), (8, 138, 64, 256),
                                   (1, 67, 45, 32)])
def test_instance_norm_matches_plain_on_card(cuda_device, shape):
    """fused_instance_norm at the CycleGAN cell's three norm shapes (a group
    of 8 tiles of 552x256: the head and the last up, the downs' and ups'
    128 channels, the trunk's 256) and a ragged one, on an accumulator
    shifted by a bias (per-channel means about 40, spread 1): >= 99.9% of
    values equal to the plain composition on the card, every value within
    one bf16 ulp of it (``_within_one_ulp``: the two take the statistics'
    fp32 sums in another order, which can flip a rounding, and near 0 moves
    a value by the means' difference), and the statistics within 1e-5 of a
    float64 two-pass over the rounded values.  Against the same composition
    with those float64 statistics (rounded to fp32): >= 99.9% equal, and at
    least as many values equal as the plain composition has, whose fp32
    mean over 141,312 pixels can stray by a few ulps."""
    from innfer_tpu_torch.ops import instance_norm as IN

    g = torch.Generator().manual_seed(sum(shape))
    shift = 40 + torch.randn(shape[-1], generator=g)
    acc = (torch.randn(*shape, generator=g) + shift).to(cuda_device)
    stats = torch.empty(shape[0], 2, shape[-1], device=cuda_device)
    before = IN.fused_instance_norm.launches
    out = IN.fused_instance_norm(acc, stats=stats)
    plain = IN.instance_norm_reference(acc)
    torch.cuda.synchronize()
    assert IN.fused_instance_norm.launches == before + 1
    assert out.dtype == torch.bfloat16 and out.shape == acc.shape
    share = lambda a, c: (a == c).float().mean().item()  # noqa: E731
    _within_one_ulp(out, plain)
    assert share(out, plain) >= 0.999
    x = acc.to(torch.bfloat16)
    x64 = x.double()
    mean = x64.mean(dim=(1, 2), keepdim=True)
    var = (x64 - mean).square().mean(dim=(1, 2), keepdim=True)
    exact = torch.relu(((x.float() - mean.float()) * torch.rsqrt(var.float() + IN.EPS))
                       .to(torch.bfloat16))
    assert share(out, exact) >= 0.999 and share(out, exact) >= share(plain, exact)
    mean, var = mean.reshape(shape[0], -1), var.reshape(shape[0], -1)
    assert ((stats[:, 0].double() - mean).abs() <= 1e-5 * mean.abs()).all().item()
    assert ((stats[:, 1].double() - var).abs() <= 1e-5 * var).all().item()


@pytest.mark.gpu
def test_cyclegan_1080p_frame_runs_its_norms_on_the_kernel_on_card(cuda_device, tmp_path):
    """A bf16 resnet_9blocks ngf=64 1080x1920 frame through the session as
    the benchmark's cell builds it (auto grid, tile_batch 8: two groups of
    8 tiles): 10 fused_instance_norm calls (5 a group) and 18
    fused_resnet_block launches, none inside ``ops.plain_path``, and the u8
    frame >= 40 dB against the plain path's (chip_smoke.py's [cyclegan]
    bar)."""
    from innfer_tpu_torch.ops import instance_norm as IN
    from innfer_tpu_torch.pipeline import InferenceSession, select_presets
    from innfer_tpu_torch.tools import synth_params as SP

    ckpt = str(tmp_path / "cyclegan9.pth")
    torch.save({k: torch.from_numpy(np.asarray(v))
                for k, v in SP.cyclegan_state(n_blocks=9, ngf=64, seed=21).items()}, ckpt)
    sess = InferenceSession(ckpt, arch="resnet_9blocks", presets=select_presets("resnet_9blocks"),
                            compute_dtype=torch.bfloat16, tile=256, overlap=16,
                            tile_mode="auto", tile_batch=8)
    frame = (np.random.default_rng(22).random((1080, 1920, 3)) * 255).astype(np.uint8)
    outs, launches = {}, {}
    for path in ("kernel", "plain"):
        norms, blocks = IN.fused_instance_norm.launches, fused_resnet_block.launches
        with torch.no_grad(), plain_path() if path == "plain" else contextlib.nullcontext():
            outs[path] = sess.run_image(frame)
        torch.cuda.synchronize()
        launches[path] = (IN.fused_instance_norm.launches - norms,
                          fused_resnet_block.launches - blocks)
    assert launches == {"kernel": (10, 18), "plain": (0, 0)}
    assert outs["kernel"].shape == (1080, 1920, 3) and outs["kernel"].std() > 1.0
    mse = np.mean((outs["kernel"].astype(np.float64) - outs["plain"]) ** 2)
    assert 10 * np.log10(255.0 ** 2 / max(mse, 1e-12)) >= 40


def _swinir_published(**kw):
    """The published SwinIR module (``tests/swinir_reference.py``), seeded."""
    import os.path as osp
    import sys

    sys.path.insert(0, osp.dirname(osp.abspath(__file__)))
    import swinir_reference as SR

    cfg = dict(img_size=64, embed_dim=180, depths=[2, 2], num_heads=[6, 6], window_size=8,
               mlp_ratio=2, upscale=4, upsampler="nearest+conv")
    return SR.seeded(SR.SwinIR(**{**cfg, **kw}), 11)


def _qkv_case(dev, shape, heads, hd, seed):
    """A (B, H, W, 3 heads 32) qkv as the packed GEMM writes it (zeros in
    each head's padding) and a relative-position bias of std 1."""
    from innfer_tpu_torch.ops import window_attn as WA

    g = torch.Generator().manual_seed(seed)
    c = heads * hd
    w, b = torch.randn(3 * c, c, generator=g) / c ** 0.5, torch.randn(3 * c, generator=g) * 0.1
    wp, bp = WA.pack_qkv(w, b, heads, WA.padded(c))
    x = torch.nn.functional.pad(torch.randn(*shape, c, generator=g) * 1.5, (0, WA.padded(c) - c))
    qkv = (x.to(dev) @ wp.to(dev).t() + bp.to(dev)).to(torch.bfloat16)
    return qkv, WA.gather_bias(torch.randn(225, heads, generator=g).to(dev), 8)


@pytest.mark.gpu
@pytest.mark.parametrize("shift", [0, 4])
@pytest.mark.parametrize("shape,heads,hd", [((1, 544, 960), 6, 30), ((2, 24, 40), 6, 30),
                                            ((3, 16, 24), 2, 12), ((1, 40, 8), 3, 32)])
def test_window_attn_matches_plain_on_card(cuda_device, shape, heads, hd, shift):
    """window_attn at the SwinIR cell's canvas (544 x 960, 6 heads of 30)
    and at ragged ones (images of one window column or row, B of 2 and 3,
    heads of 12 and 32), shifted and not, against its plain version
    (``window_attn_reference``, fp32 matmuls on the card) and that version
    with float64 sums: >= 99.9% of values equal to the plain version (so
    within one bf16 ulp), every value within two (P is rounded to bf16
    before P v, so one flipped rounding of a P value moves an output by up
    to 2^-9 |v|, near a rounding boundary a second ulp), >= 99.9% equal to
    the float64 version, the padded channels zero."""
    from innfer_tpu_torch.ops import window_attn as WA

    qkv, bias = _qkv_case(cuda_device, shape, heads, hd, sum(shape) + shift)
    kw = dict(heads=heads, head_dim=hd, window=8, shift=shift)
    before = WA.window_attn.launches
    out = WA.window_attn(qkv, bias, **kw)
    plain = WA.window_attn_reference(qkv, bias, **kw)
    exact = WA.window_attn_reference(qkv, bias, acc=torch.float64, **kw)
    torch.cuda.synchronize()
    assert WA.window_attn.launches - before == 1
    c = heads * hd
    assert out.shape == (*shape, WA.padded(c)) and not out[..., c:].any()
    share = lambda a, b: (a == b).float().mean().item()  # noqa: E731
    ulp = 2 ** -7 * plain.float().abs() + 1e-3 * max(1.0, plain.float().abs().max().item())
    assert ((out.float() - plain.float()).abs() <= 2 * ulp).all().item()
    assert share(out, plain) >= 0.999 and share(out, exact) >= 0.999


@pytest.mark.gpu
def test_window_attn_is_as_often_exact_as_plain_at_the_cells_canvas(cuda_device):
    """At the SwinIR cell's canvas, pooled over both shifts and three seeds
    (18.8 M values), window_attn is at least as often equal to the float64
    version as the plain version (fp32 matmuls on the card) is.  The
    tensor cores add the products of q k^T and P v without rounding to
    nearest, where cuBLAS's fp32 FMAs round each; the two shares differ by
    a handful of values of a 3.1 M-value draw, either way from draw to draw
    (99.98696% against 99.98711% on one draw, 99.9872% against 99.9863% on
    another, H100 80GB HBM3), so one draw cannot tell them apart."""
    from innfer_tpu_torch.ops import window_attn as WA

    eq_kernel = eq_plain = 0
    for shift in (0, 4):
        for seed in (1, 2, 3):
            qkv, bias = _qkv_case(cuda_device, (1, 544, 960), 6, 30, 100 * seed + shift)
            kw = dict(heads=6, head_dim=30, window=8, shift=shift)
            exact = WA.window_attn_reference(qkv, bias, acc=torch.float64, **kw)
            eq_kernel += (WA.window_attn(qkv, bias, **kw) == exact).sum().item()
            eq_plain += (WA.window_attn_reference(qkv, bias, **kw) == exact).sum().item()
    assert eq_kernel >= eq_plain, (eq_kernel, eq_plain)


@pytest.mark.gpu
@pytest.mark.parametrize("shape,width", [((1, 544, 960, 180), 184), ((3, 17, 9, 24), 24),
                                         ((2, 5, 7, 1024), 1024), ((4, 33, 180), 192)])
def test_layer_norm_matches_plain_on_card(cuda_device, shape, width):
    """fused_layer_norm at the SwinIR cell's tokens (180 channels into 184)
    and ragged ones, on tokens with per-channel offsets: >= 99.9% equal to
    its plain version (nn.LayerNorm in fp32, rounded once), at least as
    often equal to that composition in float64, the padding zero."""
    from innfer_tpu_torch.ops import layer_norm as LNK

    g = torch.Generator().manual_seed(sum(shape))
    c = shape[-1]
    x = (torch.randn(*shape, generator=g) * 2 + torch.randn(c, generator=g) * 3)
    x = x.to(cuda_device, torch.bfloat16)
    w = (1 + 0.3 * torch.randn(c, generator=g)).to(cuda_device)
    b = (0.2 * torch.randn(c, generator=g)).to(cuda_device)
    before = LNK.fused_layer_norm.launches
    out = LNK.fused_layer_norm(x, w, b, out_width=width)
    plain = LNK.layer_norm_reference(x, w, b, out_width=width)
    exact = LNK.layer_norm_reference(x.double(), w, b, out_width=width).to(torch.bfloat16)
    torch.cuda.synchronize()
    assert LNK.fused_layer_norm.launches - before == 1
    assert out.shape == (*shape[:-1], width) and not out[..., c:].any()
    share = lambda a, b: (a == b).float().mean().item()  # noqa: E731
    _within_one_ulp(out, plain)
    assert share(out, plain) >= 0.999 and share(out, exact) >= share(plain, exact)


@pytest.mark.gpu
def test_swinir_runs_its_layers_on_the_kernels_on_card(cuda_device):
    """A bf16 SwinIR (embed 180, 6 heads, two groups of two layers) through
    the runner's auto mode on the card: hybrid on the window-multiple
    canvas, every attention on the kernel (the counters and the device's
    winattn_fwd launches), every LayerNorm on its kernel (one a layer's
    norm, one after conv_first, one after the groups), proj, fc1 and fc2 on
    the token GEMM (three a layer), the tail on the tail conv, and no
    PyTorch attention kernel."""
    from innfer_tpu_torch import observability as obs
    from innfer_tpu_torch.loader import load_model_from_state
    from innfer_tpu_torch.checkpoint.detect import detect_and_infer
    from innfer_tpu_torch.ops import layer_norm as LNK
    from innfer_tpu_torch.ops import token_gemm as TGK
    from innfer_tpu_torch.ops import window_attn as WA
    from innfer_tpu_torch.ops.tail_conv import tail_conv
    from innfer_tpu_torch.tiling.engine import TiledRunner

    _, cfg, state = detect_and_infer(_swinir_published().state_dict())
    model, params = load_model_from_state(state, cfg, param_dtype=torch.bfloat16,
                                          device=cuda_device)
    runner = TiledRunner(model.apply, model.scale, mode="auto", trunk_fn=model.apply_trunk,
                         tail_fn=model.apply_tail, tail_halo=model.tail_halo,
                         trunk_kernel=model.trunk_kernel, hybrid_canvas=model.hybrid_canvas,
                         compute_dtype=torch.bfloat16)
    x = torch.rand(1, 37, 300, 3, device=cuda_device)
    with torch.no_grad():
        runner(params, x)
        torch.cuda.synchronize()
        obs.reset()
        attn, norms, tails = WA.window_attn.launches, LNK.fused_layer_norm.launches, \
            tail_conv.launches
        linears = TGK.token_linear.launches
        try:
            with torch.profiler.profile(activities=[
                    torch.profiler.ProfilerActivity.CPU,
                    torch.profiler.ProfilerActivity.CUDA]) as prof:
                out = runner(params, x)
                torch.cuda.synchronize()
            counters = obs.summary()["counters"]
        finally:
            obs.reset()
    assert runner.last_mode == "hybrid"
    plan = runner.plan_for(37, 300, True)
    assert (plan.pad_h, plan.pad_w) == (40, 304)
    assert out.shape == (1, 148, 1200, 3) and torch.isfinite(out).all()
    assert counters["window_attns"] == counters["window_attns_fused"] == 4
    assert counters["swin_linears"] == counters["swin_linears_fused"] == 12
    assert WA.window_attn.launches - attn == 4 and LNK.fused_layer_norm.launches - norms == 10
    assert TGK.token_linear.launches - linears == 12
    tails = tail_conv.launches - tails
    assert tails > 0 and tails % 4 == 0     # four tail convs a tile group
    kernels = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    assert sum("winattn_fwd" in k for k in kernels) == 4
    assert sum("lnorm_rows" in k for k in kernels) == 10
    assert sum("token_gemm" in k for k in kernels) == 12
    assert not any("attention" in k.lower() or "flash" in k.lower() or "fmha" in k.lower()
                   for k in kernels)


@pytest.mark.gpu
def test_swinir_on_card_matches_the_published_module(cuda_device):
    """SwinIR (embed 180, 6 heads, two groups of two layers) on the card
    against the published module (``tests/swinir_reference.py``) on the
    card in true fp32: the port in fp32 (its plain versions) within 1e-4
    (the header's fp32 bar), the port in bf16 (the kernels) >= 30 dB, the
    zoo's bf16 bar."""
    from innfer_tpu_torch.checkpoint.detect import detect_and_infer
    from innfer_tpu_torch.loader import load_model_from_state

    ref = _swinir_published().to(cuda_device)
    _, cfg, state = detect_and_infer(ref.state_dict())
    x = torch.rand(1, 3, 45, 70, device=cuda_device, generator=torch.Generator(
        device=cuda_device).manual_seed(3))
    with torch.no_grad(), true_fp32(torch.float32):
        want = ref(x)
    for dtype in (torch.float32, torch.bfloat16):
        model, params = load_model_from_state(state, cfg, param_dtype=dtype, device=cuda_device)
        with torch.no_grad():
            got = model.apply(params, x.permute(0, 2, 3, 1).to(dtype)).permute(0, 3, 1, 2).float()
        torch.cuda.synchronize()
        assert got.shape == want.shape
        if dtype == torch.float32:
            assert (got - want).abs().max().item() <= 1e-4
        else:
            mse = (got - want).square().mean().item()
            assert 10 * math.log10(1.0 / max(mse, 1e-12)) >= 30


def _token_case(dev, site, tokens, seed):
    """One of a SwinIR-M layer's linears at embed 180 as ``swin_layer``
    runs it: the tokens it reads (the attention's or the LayerNorm's
    184-wide rows, zeros past 180, or fc1's 360-wide GELU output), the
    weight packed as ``swin_layer`` packs it (input columns zero-padded to
    the rows' width), the bias in bf16, and the residual stream."""
    g = torch.Generator(device=dev).manual_seed(seed)
    rn = lambda *s: torch.randn(*s, generator=g, device=dev)  # noqa: E731
    pad = torch.nn.functional.pad
    kin, n, epilogue = {"proj": (180, 180, "residual"), "fc1": (180, 360, "gelu"),
                        "fc2": (360, 180, "residual")}[site]
    k = kin if site == "fc2" else 184
    scale = 0.4 if epilogue == "residual" else 1.0   # proj and fc2 as the benchmark's weights
    x = pad(torch.nn.functional.gelu(rn(*tokens, kin)) if site == "fc2" else rn(*tokens, kin),
            (0, k - kin)).to(torch.bfloat16)
    w = pad(rn(n, kin) * scale / kin ** 0.5, (0, k - kin)).to(torch.bfloat16)
    b = (rn(n) * 0.1).to(torch.bfloat16)
    res = (rn(*tokens, n) * 2).to(torch.bfloat16) if epilogue == "residual" else None
    return x, w, b, epilogue, res


@pytest.mark.gpu
@pytest.mark.parametrize("tokens", [(1, 544, 960), (2, 24, 40), (64,)])
@pytest.mark.parametrize("site", ["proj", "fc1", "fc2"])
def test_token_linear_matches_plain_on_card(cuda_device, site, tokens):
    """token_linear at the SwinIR cell's canvas (544 x 960 tokens) and at
    smaller ones (fewer 64-token tiles than SMs, one tile), for proj and
    fc2 with the residual and fc1 with GELU: one launch a call, >= 99.9% of
    values equal to the plain version (``token_linear_reference``: cuBLAS's
    addmm, then ATen's add or GELU), and every value within one bf16 ulp of
    the linear's output plus one of the result (the GEMM's fp32 sums differ
    in order only, so a rounding of y may flip, and the residual's sum or
    GELU carries that ulp)."""
    from innfer_tpu_torch.ops import token_gemm as TGK

    x, w, b, epilogue, res = _token_case(cuda_device, site, tokens, sum(tokens) + len(site))
    before = TGK.token_linear.launches
    out = TGK.token_linear(x, w, b, epilogue=epilogue, residual=res)
    plain = TGK.token_linear_reference(x, w, b, epilogue=epilogue, residual=res)
    y = F.linear(x, w, b)
    torch.cuda.synchronize()
    assert TGK.token_linear.launches - before == 1
    assert out.shape == plain.shape == (*tokens, w.shape[0]) and out.dtype == torch.bfloat16
    ref = plain.float()
    tol = 2 ** -7 * (ref.abs() + y.float().abs()) + 1e-3 * max(1.0, ref.abs().max().item())
    assert ((out.float() - ref).abs() <= tol).all().item()
    assert (out == plain).float().mean().item() >= 0.999


@pytest.mark.gpu
def test_swinir_m_frame_on_the_kernels_matches_plain_path(cuda_device, tmp_path):
    """A seeded SwinIR-M x4 (published widths and depth, the benchmark's
    weights) on a 540 x 960 frame through InferenceSession in bf16: hybrid
    on the 544 x 960 canvas, 108 token_linear launches a frame (proj, fc1
    and fc2 of 36 layers), and >= 40 dB against ``ops.plain_path`` (the bar
    of ``chip_smoke.py``'s [swinir])."""
    import json
    import os.path as osp

    from innbench.reference import swinir as BR
    from innfer_tpu_torch.ops import token_gemm as TGK
    from innfer_tpu_torch.pipeline import InferenceSession, select_presets

    root = osp.dirname(osp.dirname(osp.abspath(__file__)))
    with open(osp.join(root, "innbench", "configs", "swinir_m_x4.json")) as f:
        model = json.load(f)["model"]
    ckpt = str(tmp_path / "4x_swinir_m_x4.pth")
    state = BR.make_state(model, 23, cuda_device)
    torch.save({"params_ema": {k: v.cpu() for k, v in state.items()}}, ckpt)
    del state
    sess = InferenceSession(ckpt, arch="infer", presets=select_presets("infer", ckpt),
                            compute_dtype=torch.bfloat16, tile=256, overlap=16,
                            tile_mode="auto", tile_batch=8)
    rng = np.random.default_rng(23)
    yy, xx = np.mgrid[0:540, 0:960].astype(np.float32)
    smooth = 128 + 70 * np.sin(xx / 23) * np.cos(yy / 31)
    frame = np.clip(smooth[..., None] + rng.normal(0, 10, (540, 960, 3)), 0, 255).astype(np.uint8)
    with torch.no_grad():
        before = TGK.token_linear.launches
        out = sess.run_image(frame)
        torch.cuda.synchronize()
        launches = TGK.token_linear.launches - before
        with plain_path():
            plain = sess.run_image(frame)
    runner = sess.stages[0].runner
    plan = runner.plan_for(540, 960, True)
    assert runner.last_mode == "hybrid" and (plan.pad_h, plan.pad_w) == (544, 960)
    assert launches == 108
    assert out.shape == plain.shape == (2160, 3840, 3) and out.std() > 1.0
    mse = np.mean((out.astype(np.float64) - plain) ** 2)
    assert 10 * np.log10(255.0 ** 2 / max(mse, 1e-12)) >= 40


def _hat_case(dev, shape, heads, hd, rows, seed):
    """A (B, H, W, 3 heads 32) qkv as the packed GEMM writes it and a
    relative-position table of ``rows`` rows of std 1."""
    qkv, _ = _qkv_case(dev, shape, heads, hd, seed)
    g = torch.Generator().manual_seed(seed + 1)
    return qkv, torch.randn(rows, heads, generator=g).to(dev)


@pytest.mark.gpu
@pytest.mark.parametrize("site", ["sa0", "sa8", "oca"])
@pytest.mark.parametrize("shape,heads,hd", [((1, 544, 960), 6, 30), ((2, 32, 48), 6, 30),
                                            ((1, 16, 16), 2, 32), ((3, 48, 16), 3, 12)])
def test_hat_attn_matches_plain_on_card(cuda_device, site, shape, heads, hd):
    """hat_window_attn (shifts 0 and 8) and overlap_attn at the HAT cell's
    canvas (544 x 960, 6 heads of 30) and at ragged ones (a single window,
    one window column, B of 2 and 3, heads of 12 and 32, where the OCA's
    key windows reach past every edge), against their plain versions (fp32
    matmuls on the card) and those versions with float64 sums: >= 99.8% of
    values equal to the plain version, every value within two bf16 ulps of
    it (P is rounded to bf16 before P v; the kernel's exp2 on the SFU, an
    ulp or two of fp32 from expf, and its tensor-core sums flip a rounding
    now and then: 99.87% equal at the cell's OCA, whose rows sum 576 P v
    products), >= 99.7% equal to the float64 version, the padded channels
    zero."""
    from innfer_tpu_torch.ops import hat_attn as HA
    from innfer_tpu_torch.ops import window_attn as WA

    oca = site == "oca"
    qkv, table = _hat_case(cuda_device, shape, heads, hd, 1521 if oca else 961,
                           sum(shape) + len(site))
    fn, ref = ((HA.overlap_attn, HA.overlap_attn_reference) if oca else
               (HA.hat_window_attn, HA.hat_window_attn_reference))
    kw = dict(heads=heads, head_dim=hd, window=16,
              **(dict(kwin=24) if oca else dict(shift=int(site[2:]))))
    before = fn.launches
    out = fn(qkv, table, **kw)
    plain = ref(qkv, table, **kw)
    exact = ref(qkv, table, acc=torch.float64, **kw)
    torch.cuda.synchronize()
    assert fn.launches - before == 1
    c = heads * hd
    assert out.shape == (*shape, WA.padded(c)) and not out[..., c:].any()
    share = lambda a, b: (a == b).float().mean().item()  # noqa: E731
    ulp = 2 ** -7 * plain.float().abs() + 1e-3 * max(1.0, plain.float().abs().max().item())
    gap = ((out.float() - plain.float()).abs() / ulp).max().item()
    shares = (share(out, plain), share(out, exact), share(plain, exact))
    assert gap <= 2 and shares[0] >= 0.998 and shares[1] >= 0.997, (gap, shares)


def _hat_model(dev, tmp_path, seed):
    import json
    import os.path as osp

    from innbench.reference import hat as BR
    from innfer_tpu_torch.pipeline import InferenceSession, select_presets

    root = osp.dirname(osp.dirname(osp.abspath(__file__)))
    with open(osp.join(root, "innbench", "configs", "hat_x4.json")) as f:
        model = json.load(f)["model"]
    ckpt = str(tmp_path / "4x_hat_x4.pth")
    state = BR.make_state(model, seed, dev)
    torch.save({"params_ema": {k: v.cpu() for k, v in state.items()}}, ckpt)
    del state
    return InferenceSession(ckpt, arch="infer", presets=select_presets("infer", ckpt),
                            compute_dtype=torch.bfloat16, tile=256, overlap=16,
                            tile_mode="auto", tile_batch=8)


@pytest.mark.gpu
def test_hat_frame_on_the_kernels_matches_plain_path(cuda_device, tmp_path):
    """A seeded Real-HAT-GAN x4 (published widths and depth, the benchmark's
    weights) on a 540 x 960 frame through InferenceSession in bf16: hybrid
    on the 544 x 960 canvas, 36 hat_window_attn, 6 overlap_attn, 126
    token_linear and 3 tail conv launches a frame, and >= 40 dB against
    ``ops.plain_path`` (the bar of ``chip_smoke.py``'s [hat])."""
    from innfer_tpu_torch.ops import hat_attn as HA
    from innfer_tpu_torch.ops import tail_conv as TCK
    from innfer_tpu_torch.ops import token_gemm as TGK

    sess = _hat_model(cuda_device, tmp_path, 29)
    rng = np.random.default_rng(29)
    yy, xx = np.mgrid[0:540, 0:960].astype(np.float32)
    smooth = 128 + 70 * np.sin(xx / 23) * np.cos(yy / 31)
    frame = np.clip(smooth[..., None] + rng.normal(0, 10, (540, 960, 3)), 0, 255).astype(np.uint8)
    fns = (HA.hat_window_attn, HA.overlap_attn, TGK.token_linear, TCK.tail_conv)
    with torch.no_grad():
        before = [f.launches for f in fns]
        out = sess.run_image(frame)
        torch.cuda.synchronize()
        launches = [f.launches - b for f, b in zip(fns, before)]
        with plain_path():
            plain = sess.run_image(frame)
    runner = sess.stages[0].runner
    plan = runner.plan_for(540, 960, True)
    assert runner.last_mode == "hybrid" and (plan.pad_h, plan.pad_w) == (544, 960)
    assert launches == [36, 6, 126, 3]
    assert out.shape == plain.shape == (2160, 3840, 3) and out.std() > 1.0
    mse = np.mean((out.astype(np.float64) - plain) ** 2)
    assert 10 * np.log10(255.0 ** 2 / max(mse, 1e-12)) >= 40


@pytest.mark.gpu
@pytest.mark.parametrize("shift", [0, 4])
def test_swin_layer_is_its_pieces_on_card(cuda_device, shift):
    """``models/swinir.swin_layer``, whose pieces HAT now shares (LayerNorm
    into 16-byte rows, qkv in the attention's layout, the token GEMM with
    its epilogues), gives bit for bit what the composition it was before
    gives on the kernels: SwinIR's outputs are unchanged."""
    from innfer_tpu_torch.models import swinir as SW
    from innfer_tpu_torch.models.base import ParamDict
    from innfer_tpu_torch.ops import layer_norm as LNK
    from innfer_tpu_torch.ops import token_gemm as TGK
    from innfer_tpu_torch.ops import window_attn as WA

    ref = _swinir_published()
    p = "layers.0.residual_group.blocks.1"
    params = ParamDict({k: (v.to(cuda_device, torch.bfloat16) if v.dim() > 1
                            and "relative_position_bias_table" not in k
                            else v.float().to(cuda_device))
                        for k, v in ref.state_dict().items() if k.startswith(p)})
    g = torch.Generator().manual_seed(31 + shift)
    x = (torch.randn(1, 64, 96, 180, generator=g) * 1.5).to(cuda_device, torch.bfloat16)
    got = SW.swin_layer(params, x, p, heads=6, window=8, shift=shift)

    def lin(key, t, pack=None, **kw):
        w, b = params[f"{key}.weight"], params[f"{key}.bias"].to(torch.bfloat16)
        if pack is not None:
            w, b = pack(w, b)[0], b
        return TGK.token_linear(t, w, b, **kw) if kw else F.linear(t, w, b)

    def ln(key, t):
        return LNK.fused_layer_norm(t, params[f"{key}.weight"], params[f"{key}.bias"],
                                    out_width=184)

    w, b = WA.pack_qkv(params[f"{p}.attn.qkv.weight"], params[f"{p}.attn.qkv.bias"], 6, 184)
    qkv = F.linear(ln(f"{p}.norm1", x), w, b.to(torch.bfloat16))
    bias = WA.gather_bias(params[f"{p}.attn.relative_position_bias_table"], 8)
    a = WA.window_attn(qkv, bias, heads=6, head_dim=30, window=8, shift=shift)
    pad = lambda w, b: (torch.nn.functional.pad(w, (0, 4)).contiguous(), b)  # noqa: E731
    want = lin(f"{p}.attn.proj", a, pad, epilogue="residual", residual=x)
    h = lin(f"{p}.mlp.fc1", ln(f"{p}.norm2", want), pad, epilogue="gelu")
    want = lin(f"{p}.mlp.fc2", h, epilogue="residual", residual=want)
    assert torch.equal(got, want)
