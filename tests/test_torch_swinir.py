"""SwinIR on the CPU at tiny widths against the published forward
(``tests/swinir_reference.py``): the port's model whole and in the runner's
hybrid mode, the benchmark's copy of the reference, the window attention's
plain version and an emulation of its kernel's index arithmetic, the token
GEMM's plain version against the composition it replaces, faults that each
comparison must catch, the loader (detection, the ``params_ema`` wrapper,
every hyperparameter, the refused variants), the kernels' gates,
``ops.plain_path``, the counters and the hybrid canvas.  The kernels themselves are held on the
card by ``tests/test_torch_gpu.py``.

Tolerances: fp32 on both sides, true fp32 (no TF32), the same operations
summed in another order (the port's linears over zero-padded rows, its
convs channels-last, the attention's windows gathered by index): 2e-5 of
an output in [0, 1] (observed below 2e-6); a fault moves the output by far
more, so each fault test asks for a gap of at least 100 times that."""
import math
import os.path as osp
import sys

import numpy as np
import pytest
import torch
import torch.nn.functional as TF

from innfer_tpu_torch import observability as obs
from innfer_tpu_torch.checkpoint.detect import detect_and_infer
from innfer_tpu_torch.loader import load_model
from innfer_tpu_torch.models import convert_state, get_network
from innfer_tpu_torch.models import swinir as SW
from innfer_tpu_torch.nn import functional as F
from innfer_tpu_torch.nn.functional import true_fp32
from innfer_tpu_torch.ops import layer_norm as LN
from innfer_tpu_torch.ops import plain_path
from innfer_tpu_torch.ops import token_gemm as TG
from innfer_tpu_torch.ops import window_attn as WA
from innfer_tpu_torch.tiling.engine import TiledRunner

sys.path.insert(0, osp.dirname(osp.abspath(__file__)))
import swinir_reference as R  # noqa: E402

TOL = 2e-5
TINY = dict(img_size=64, embed_dim=24, depths=[2, 2], num_heads=[2, 2], window_size=8,
            mlp_ratio=2, upscale=4, upsampler="nearest+conv")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The tensors here are tiny: one thread runs them many times faster
    than a pool of threads that shares the machine's cores with the other
    test workers (30 times on a loaded 8-core machine)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _CudaLooking(torch.Tensor):
    """A CPU tensor that answers ``is_cuda`` True, to reach the gates that
    decide on the card."""

    @property
    def is_cuda(self):
        return True


def _reference(seed=5, **kw):
    return R.seeded(R.SwinIR(**{**TINY, **kw}), seed)


def _port(ref):
    _, cfg, state = detect_and_infer(ref.state_dict())
    model = get_network(cfg)
    return model, convert_state(model, state, device="cpu")


def _image(h, w, seed=0):
    return torch.rand(1, 3, h, w, generator=torch.Generator().manual_seed(seed))


def _published(ref, x):
    with torch.no_grad(), true_fp32(torch.float32):
        return ref(x)


def _whole(model, params, x):
    with torch.no_grad():
        return model.apply(params, x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)


def _hybrid(model, params, x):
    runner = TiledRunner(model.apply, model.scale, mode="hybrid", trunk_fn=model.apply_trunk,
                         tail_fn=model.apply_tail, tail_halo=model.tail_halo,
                         trunk_kernel=model.trunk_kernel, hybrid_canvas=model.hybrid_canvas)
    with torch.no_grad():
        out = runner(params, x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)
    assert runner.last_mode == "hybrid"
    return out


@pytest.mark.parametrize("mode", ["whole", "hybrid"])
@pytest.mark.parametrize("hw", [(21, 35), (24, 40), (37, 16), (8, 9)])
def test_port_matches_the_published_forward(mode, hw):
    """The port's SwinIR, whole and hybrid (trunk on the window-multiple
    canvas, the x4 tail on tiles), against the published module; images
    that need the reflect padding, one that does not, a canvas of a single
    window row, in fp32."""
    ref = _reference()
    model, params = _port(ref)
    x = _image(*hw)
    got = (_whole if mode == "whole" else _hybrid)(model, params, x)
    want = _published(ref, x)
    assert got.shape == want.shape == (1, 3, 4 * hw[0], 4 * hw[1])
    assert (got - want).abs().max().item() <= TOL


def _with_fault(monkeypatch, fault):
    if fault == "bias":
        monkeypatch.setattr(WA, "gather_bias", lambda t, w: torch.zeros(
            t.shape[1], w * w, w * w, dtype=torch.float32))
    elif fault == "mask":
        orig = WA.shift_mask
        monkeypatch.setattr(WA, "shift_mask", lambda *a, **k: torch.zeros_like(orig(*a, **k)))
    elif fault == "shift":
        orig = WA.window_attn_reference
        monkeypatch.setattr(WA, "window_attn_reference",
                            lambda *a, **k: orig(*a, **{**k, "shift": 0}))
    elif fault == "mean":
        monkeypatch.setattr(SW, "RGB_MEAN", (0.0, 0.0, 0.0))


@pytest.mark.parametrize("fault", ["bias", "mask", "shift", "mean"])
def test_each_fault_fails_the_comparison(monkeypatch, fault):
    """Left out of the port's plain path, each of the relative-position
    bias, the shift mask, the cyclic shift and the mean shift moves the
    output far past the tolerance of the comparison above."""
    ref = _reference()
    _with_fault(monkeypatch, fault)
    model, params = _port(ref)
    x = _image(24, 40)
    gap = (_whole(model, params, x) - _published(ref, x)).abs().max().item()
    assert gap > 100 * TOL, gap


def test_benchmark_reference_matches_the_published_forward():
    """``innbench/reference/swinir.py`` (the benchmark's own copy, which
    imports nothing of the port) on its seeded state, loaded into the
    published module, both fp32: the two copies agree."""
    from innbench.reference import swinir as BR

    model = dict(in_chans=3, embed_dim=24, depths=[2, 2], num_heads=[2, 2], window_size=8,
                 mlp_ratio=2, img_size=64, img_range=1.0, upsampler="nearest+conv",
                 resi_connection="1conv", num_feat=64, scale=4, out_std=0.25, bias_std=1.0,
                 qkv_gain=math.sqrt(2.0), branch_gain=0.4, group_gain=0.4)
    state = BR.make_state(model, 7, "cpu")
    ref = R.SwinIR(**TINY).eval()
    ref.load_state_dict(state)
    for hw in [(21, 35), (32, 16)]:
        x = _image(*hw, seed=2)
        with torch.no_grad(), true_fp32(torch.float32):
            got = BR.forward(BR.Ops(state), x, model)
        assert (got - _published(ref, x)).abs().max().item() <= TOL


def _attention_case(window, shift, hw, heads=3, hd=8, seed=3):
    """The published layer's attention (roll, partition, WindowAttention
    with qkv and proj, reverse, roll back) on tokens x, and the port's
    (packed qkv GEMM, the plain window attention, proj over padded rows)."""
    torch.manual_seed(seed)
    c = heads * hd
    blk = R.SwinTransformerBlock(c, (64, 64), heads, window, shift)
    with torch.no_grad():
        blk.attn.relative_position_bias_table.normal_()
    x = torch.randn(1, *hw, c)
    with torch.no_grad(), true_fp32(torch.float32):
        xs = torch.roll(x, (-shift, -shift), (1, 2)) if shift else x
        win = R.window_partition(xs, window).view(-1, window * window, c)
        mask = blk.calculate_mask(hw) if shift else None
        o = R.window_reverse(blk.attn(win, mask=mask).view(-1, window, window, c), window, *hw)
        want = torch.roll(o, (shift, shift), (1, 2)) if shift else o
        cp = WA.padded(c)
        wq, bq = WA.pack_qkv(blk.attn.qkv.weight, blk.attn.qkv.bias, heads, cp)
        qkv = F.linear(TF.pad(x, (0, cp - c)), wq, bq)
        bias = WA.gather_bias(blk.attn.relative_position_bias_table, window)
        a = WA.window_attn_reference(qkv, bias, heads=heads, head_dim=hd, window=window,
                                     shift=shift)
        got = F.linear(a, TF.pad(blk.attn.proj.weight, (0, cp - c)), blk.attn.proj.bias)
    return got, want, (qkv, bias, a)


@pytest.mark.parametrize("window,hw", [(8, (16, 40)), (8, (40, 24)), (4, (12, 20))])
@pytest.mark.parametrize("shift", [False, True])
def test_window_attention_plain_version_matches_the_published_one(window, hw, shift):
    """``window_attn_reference`` between the packed qkv and proj GEMMs
    against the published layer's attention, shifted and not, on canvases
    that are not square; the padded output channels are zero."""
    got, want, (_, _, a) = _attention_case(window, window // 2 if shift else 0, hw)
    assert (got - want).abs().max().item() <= TOL
    assert a.shape[-1] == WA.padded(24) and not a[..., 24:].any()


@pytest.mark.parametrize("shift", [0, 4])
def test_kernel_index_arithmetic_emulated(shift):
    """The kernel's arithmetic in Python (``csrc/window_attn.cu``): window
    (wr, wc) reads, at position (a, b), the token at ((8 wr + a + s) mod
    Hp, (8 wc + b + s) mod Wp), masks by the regions of the rolled
    coordinates, and writes back where it read; it equals the plain
    version's roll and partition."""
    _, _, (qkv, bias, want) = _attention_case(8, shift, (24, 40), heads=3, hd=8)
    hp, wp, heads, hd = 24, 40, 3, 8
    q, k, v = qkv[0].reshape(hp, wp, 3, heads, WA.HEAD_STRIDE)[..., :hd].unbind(2)

    def region(y, n):
        return 0 if y < n - 8 else (1 if y < n - shift else 2)

    out = torch.zeros(hp, wp, WA.padded(heads * hd))
    for wr in range(hp // 8):
        for wc in range(wp // 8):
            ys = [(8 * wr + t // 8 + shift) % hp for t in range(64)]
            xs = [(8 * wc + t % 8 + shift) % wp for t in range(64)]
            reg = torch.tensor([3 * region(8 * wr + t // 8, hp) + region(8 * wc + t % 8, wp)
                                for t in range(64)])
            m = torch.where(reg[:, None] != reg[None, :], WA.MASK, 0.0) if shift else 0.0
            for h in range(heads):
                qh, kh, vh = (t[ys, xs, h] for t in (q, k, v))
                s = (qh * hd ** -0.5) @ kh.t() + bias[h] + m
                out[ys, xs, h * hd:(h + 1) * hd] = torch.softmax(s, -1) @ vh
    assert (out - want[0]).abs().max().item() <= TOL


def test_pack_qkv_pads_heads_and_rows_with_zeros():
    """The packed qkv GEMM over zero-padded rows gives the published qkv
    values at each head's 32-channel slot, zeros in the padding."""
    heads, hd, c = 3, 10, 30
    g = torch.Generator().manual_seed(1)
    w, b = torch.randn(3 * c, c, generator=g), torch.randn(3 * c, generator=g)
    x = torch.randn(5, c, generator=g)
    wp, bp = WA.pack_qkv(w, b, heads, WA.padded(c))
    assert wp.shape == (3 * heads * 32, 32) and bp.shape == (3 * heads * 32,)
    got = (TF.pad(x, (0, 2)) @ wp.t() + bp).reshape(5, 3, heads, 32)
    want = (x @ w.t() + b).reshape(5, 3, heads, hd)
    assert torch.allclose(got[..., :hd], want, atol=1e-5) and not got[..., hd:].any()


def test_layer_norm_plain_version_is_torchs_fp32_layer_norm():
    """``layer_norm_reference``: nn.LayerNorm in fp32 of the bf16 values,
    rounded once, zero-padded; the wrapper takes it for a CPU tensor."""
    g = torch.Generator().manual_seed(2)
    x = (torch.randn(2, 5, 7, 180, generator=g) * 3 + 1).to(torch.bfloat16)
    w, b = 1 + 0.1 * torch.randn(180, generator=g), 0.1 * torch.randn(180, generator=g)
    want = TF.layer_norm(x.float(), (180,), w, b, 1e-5).to(torch.bfloat16)
    got = LN.layer_norm_reference(x, w, b, out_width=184)
    assert torch.equal(got[..., :180], want) and not got[..., 180:].any()
    assert torch.equal(LN.fused_layer_norm(x, w, b, out_width=184), got)


_ATTN_GATE = [  # (qkv shape, heads, head_dim, window, shift, dtype, takes)
    ((1, 544, 960, 576), 6, 30, 8, 4, torch.bfloat16, True),
    ((2, 16, 24, 576), 6, 30, 8, 0, torch.bfloat16, True),
    ((1, 16, 24, 192), 2, 12, 8, 4, torch.bfloat16, True),
    ((1, 16, 24, 576), 6, 30, 8, 4, torch.float32, False),     # fp32: the plain version
    ((1, 16, 24, 540), 6, 30, 8, 4, torch.bfloat16, False),    # heads not padded to 32
    ((1, 16, 24, 576), 6, 30, 4, 2, torch.bfloat16, False),    # window 4
    ((1, 16, 24, 576), 6, 30, 8, 2, torch.bfloat16, False),    # a shift of 2
    ((1, 12, 24, 576), 6, 30, 8, 4, torch.bfloat16, False),    # rows not a window multiple
    ((1, 16, 24, 576), 6, 31, 8, 4, torch.bfloat16, False),    # odd head width
    ((1, 8, 8, 3 * 24 * 32), 24, 30, 8, 0, torch.bfloat16, False),   # too wide for a block
]


@pytest.mark.parametrize("case", _ATTN_GATE)
def test_window_attn_gate(case):
    shape, heads, hd, window, shift, dtype, ok = case
    qkv = torch.zeros(shape, dtype=dtype)
    bias = torch.zeros(heads, 64, 64)
    kw = dict(heads=heads, head_dim=hd, window=window, shift=shift)
    assert WA.takes(qkv, bias, **kw) is ok
    assert WA.fusable(qkv, bias, **kw) is False                      # a CPU tensor
    assert WA.fusable(qkv.as_subclass(_CudaLooking), bias, **kw) is ok
    with plain_path():
        assert not WA.fusable(qkv.as_subclass(_CudaLooking), bias, **kw)
    sharded = torch.zeros(3)
    sharded.tp_shards = (sharded,)
    assert WA.takes(qkv, bias, weight=sharded, **kw) is False


@pytest.mark.parametrize("shape,dtype,wdt,ok", [
    ((4, 180), torch.bfloat16, torch.float32, True), ((2, 3, 5, 1024), torch.bfloat16,
                                                      torch.float32, True),
    ((4, 180), torch.float32, torch.float32, False), ((4, 182), torch.bfloat16, torch.float32,
                                                      False),
    ((4, 1028), torch.bfloat16, torch.float32, False), ((4, 180), torch.bfloat16,
                                                        torch.bfloat16, False)])
def test_layer_norm_gate(shape, dtype, wdt, ok):
    x = torch.zeros(shape, dtype=dtype)
    w = b = torch.zeros(shape[-1], dtype=wdt)
    assert LN.takes(x, w, b) is ok
    assert LN.fusable(x.as_subclass(_CudaLooking), w, b) is ok
    with plain_path():
        assert not LN.fusable(x.as_subclass(_CudaLooking), w, b)


def _counted(fn):
    obs.reset()
    try:
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
            with torch.no_grad():
                out = fn()
        return out, obs.summary()["counters"]
    finally:
        obs.reset()


def test_counters_and_the_gates_on_the_cpu(monkeypatch):
    """Every layer's attention is counted; on the CPU none runs on the
    kernel; with the gates forced open (bf16), the wrappers run their plain
    versions on the CPU, every attention counts as fused, and the output is
    the same bits."""
    ref = _reference()
    model, _ = _port(ref)
    params = convert_state(model, ref.state_dict(), param_dtype=torch.bfloat16, device="cpu")
    x = _image(16, 24).permute(0, 2, 3, 1).to(torch.bfloat16)
    out0, c0 = _counted(lambda: model.apply(params, x))
    monkeypatch.setattr(WA, "fusable", WA.takes)
    monkeypatch.setattr(LN, "fusable", LN.takes)
    out1, c1 = _counted(lambda: model.apply(params, x))
    assert c0["window_attns"] == c1["window_attns"] == 4
    assert c0.get("window_attns_fused", 0) == 0 and c1["window_attns_fused"] == 4
    assert torch.equal(out0, out1)


_SITES = {  # a Swin layer's linear: (K, N, epilogue) at embed 24 (tiny) and 180 (SwinIR-M)
    "proj": lambda c: (WA.padded(c), c, "residual"),
    "fc1": lambda c: (WA.padded(c), 2 * c, "gelu"),
    "fc2": lambda c: (2 * c, c, "residual"),
}


def _site_case(site, c, tokens=(2, 8, 8), dtype=torch.bfloat16, seed=0):
    """Tokens, the weight as ``swin_layer`` packs it (input columns
    zero-padded to the tokens' width), the bias and the residual of one of
    a layer's linears at embed ``c``."""
    k, n, epilogue = _SITES[site](c)
    g = torch.Generator().manual_seed(seed)
    kin = c if site != "fc2" else k
    x = TF.pad(torch.randn(*tokens, kin, generator=g), (0, k - kin)).to(dtype)
    w = TF.pad(torch.randn(n, kin, generator=g) / kin ** 0.5, (0, k - kin)).to(dtype)
    b = (torch.randn(n, generator=g) * 0.1).to(dtype)
    res = (torch.randn(*tokens, n, generator=g) * 2).to(dtype) if epilogue == "residual" else None
    return x, w, b, epilogue, res


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("site", sorted(_SITES))
def test_token_linear_reference_is_the_composition_it_replaces(site, dtype):
    """``token_linear_reference`` is, bit for bit, what ``swin_layer`` ran
    before the token GEMM: ``nn/functional.linear``, then ``x + y`` or
    ``TF.gelu(y)``; the wrapper takes it for a CPU tensor."""
    x, w, b, epilogue, res = _site_case(site, 24, dtype=dtype, seed=len(site))
    y = F.linear(x, w, b)
    want = res + y if epilogue == "residual" else TF.gelu(y)
    got = TG.token_linear_reference(x, w, b, epilogue=epilogue, residual=res)
    assert got.dtype == dtype and torch.equal(got, want)
    assert torch.equal(TG.token_linear(x, w, b, epilogue=epilogue, residual=res), want)


_TG_GATE = [  # (site, embed, tokens, change, takes)
    ("proj", 180, (1, 544, 960), None, True),
    ("fc1", 180, (1, 544, 960), None, True),
    ("fc2", 180, (2, 8, 16), None, True),
    ("proj", 180, (64,), None, True),
    ("fc1", 180, (2, 8, 8), "fp32", False),         # fp32: the plain version
    ("fc2", 180, (2, 8, 8), "fp16", False),         # not bf16
    ("proj", 180, (2, 8, 8), "bias fp32", False),   # the bias not in x's dtype
    ("proj", 180, (3, 7, 8), None, False),          # 168 tokens: not whole tiles of 64
    ("fc1", 24, (2, 8, 8), None, False),            # widths the kernel was not built for
    ("proj", 180, (2, 8, 8), "k 180", False),       # K % 8 != 0: 360-byte rows
    ("fc2", 180, (2, 8, 8), "no residual", False),
    ("fc1", 180, (2, 8, 8), "residual", False),     # gelu takes none
    ("proj", 180, (2, 8, 8), "residual shape", False),
    ("fc1", 180, (2, 8, 8), "sharded", False),
]


@pytest.mark.parametrize("case", _TG_GATE)
def test_token_gemm_gate(case):
    """The gate answers from dtypes and shapes: bf16 tokens, weight and
    bias, K % 8 == 0, whole 64-token tiles, a residual for the residual
    epilogue and none for GELU, the widths the kernel was built for, an
    unsharded weight; on a CUDA tensor only, and never inside
    ``ops.plain_path``.  Where it refuses, the wrapper raises on the card
    and the CPU takes the plain version."""
    site, c, tokens, change, ok = case
    k, n, epilogue = _SITES[site](c)
    # tokens and residual as views of one row: the gate reads shapes and dtypes only
    x = torch.zeros(k, dtype=torch.bfloat16).expand(*tokens, k)
    w, b = torch.zeros(n, k, dtype=torch.bfloat16), torch.zeros(n, dtype=torch.bfloat16)
    res = (torch.zeros(n, dtype=torch.bfloat16).expand(*tokens, n) if epilogue == "residual"
           else None)
    if change in ("fp32", "fp16"):
        dt = torch.float32 if change == "fp32" else torch.float16
        x, w, b = x.to(dt), w.to(dt), b.to(dt)
        res = None if res is None else res.to(dt)
    elif change == "bias fp32":
        b = b.float()
    elif change == "k 180":
        x, w = x[..., :180], w[:, :180].contiguous()
    elif change == "no residual":
        res = None
    elif change == "residual":
        res = torch.zeros(n, dtype=torch.bfloat16).expand(*tokens, n)
    elif change == "residual shape":
        res = res[..., :-8]
    elif change == "sharded":
        w.tp_shards = (w,)
    kw = dict(epilogue=epilogue, residual=res)
    assert TG.takes(x, w, b, **kw) is ok
    assert TG.fusable(x, w, b, **kw) is False                       # a CPU tensor
    assert TG.fusable(x.as_subclass(_CudaLooking), w, b, **kw) is ok
    with plain_path():
        assert not TG.fusable(x.as_subclass(_CudaLooking), w, b, **kw)


@pytest.mark.parametrize("embed,forced,fused", [(24, False, 0), (24, True, 0), (180, False, 0),
                                                (180, True, 3)])
def test_swin_linears_counted_and_gated_on_the_cpu(monkeypatch, embed, forced, fused):
    """Every Swin layer counts three linears with an epilogue (``proj``,
    ``fc1``, ``fc2``); none runs on the kernel on the CPU.  With the token
    GEMM's gate forced open (bf16), the three run through ``token_linear``
    (its plain version on the CPU) wherever the widths are the kernel's
    (SwinIR-M's embed 180, not 24), and the output is the same bits."""
    ref = _reference(embed_dim=embed, depths=[2], num_heads=[6 if embed == 180 else 2])
    model, _ = _port(ref)
    params = convert_state(model, ref.state_dict(), param_dtype=torch.bfloat16, device="cpu")
    x = _image(8, 16).permute(0, 2, 3, 1).to(torch.bfloat16)
    out0, c0 = _counted(lambda: model.apply(params, x))
    if forced:
        monkeypatch.setattr(TG, "fusable", TG.takes)
    launches = TG.token_linear.launches
    out1, c1 = _counted(lambda: model.apply(params, x))
    assert c0["swin_linears"] == c1["swin_linears"] == 3 * 2
    assert c0.get("swin_linears_fused", 0) == 0
    assert c1.get("swin_linears_fused", 0) == fused * 2
    assert TG.token_linear.launches == launches           # the CPU launches nothing
    assert torch.equal(out0, out1)


_GATED = ("rdb", "resnet_block", "tail_conv", "dilated_block", "instance_norm", "window_attn",
          "layer_norm", "token_gemm", "hat_attn")


@pytest.mark.parametrize("name", _GATED)
def test_plain_path_closes_all_eight_gates(name):
    """``ops.plain_path`` closes every kernel's gate, the token GEMM's and
    HAT's attention's among them: each of the nine ``fusable`` answers
    False inside and is itself again after; the nine are every ops module
    with a gate."""
    import importlib
    import pkgutil

    import innfer_tpu_torch.ops as ops

    gated = {m.name for m in pkgutil.iter_modules(ops.__path__)
             if hasattr(importlib.import_module(f"innfer_tpu_torch.ops.{m.name}"), "fusable")}
    assert gated == set(_GATED)
    mod = importlib.import_module(f"innfer_tpu_torch.ops.{name}")
    gate = mod.fusable
    with plain_path():
        assert mod.fusable is not gate
        assert mod.fusable(torch.zeros(1), epilogue="gelu") is False
    assert mod.fusable is gate


def _save(tmp_path, state, wrap, name="swinir.pth"):
    path = str(tmp_path / name)
    torch.save({"params_ema": state} if wrap else state, path)
    return path


@pytest.mark.parametrize("wrap", [True, False])
def test_loader_detects_swinir_and_infers_every_hyperparameter(tmp_path, wrap):
    """A released-layout state dict (the published module's, buffers and
    all), with or without ``params_ema``, through ``arch: infer``."""
    ref = _reference(embed_dim=36, depths=[2, 1, 3], num_heads=[3, 2, 6], mlp_ratio=3)
    model, params = load_model(_save(tmp_path, ref.state_dict(), wrap), arch="infer",
                               device="cpu")
    cfg = model.cfg
    assert model.name == "swinir" and model.scale == 4
    assert (cfg["embed_dim"], cfg["depths"], cfg["num_heads"], cfg["window_size"],
            cfg["mlp_ratio"], cfg["upsampler"], cfg["resi_connection"], cfg["upscale"],
            cfg["in_chans"]) == (36, [2, 1, 3], [3, 2, 6], 8, 3.0, "nearest+conv", "1conv", 4, 3)
    assert not any(k.endswith(("relative_position_index", "attn_mask")) for k in params)
    assert {"tail.1.weight", "tail.4.weight", "tail.6.weight", "tail.8.weight"} <= set(params)
    table = "layers.0.residual_group.blocks.0.attn.relative_position_bias_table"
    assert params[table].dtype == torch.float32


def test_loader_reads_swinir_m_at_its_published_widths():
    """The real-world x4 model M's shapes (``main_test_swinir.py --task
    real_sr``): detection and every hyperparameter, no forward."""
    ref = R.SwinIR(img_size=64, embed_dim=180, depths=[6] * 6, num_heads=[6] * 6,
                   window_size=8, mlp_ratio=2, upscale=4, upsampler="nearest+conv")
    arch, cfg, _ = detect_and_infer(ref.state_dict())
    assert arch == "swinir"
    assert (cfg["embed_dim"], cfg["depths"], cfg["num_heads"], cfg["window_size"],
            cfg["mlp_ratio"], cfg["upsampler"], cfg["upscale"]) == \
        (180, [6] * 6, [6] * 6, 8, 2.0, "nearest+conv", 4)
    assert sum(p.numel() for p in ref.parameters()) == 11_715_559
    assert get_network(cfg).trunk_kernel


@pytest.mark.parametrize("variant,match", [
    (dict(upsampler="pixelshuffle"), "pixelshuffle upsampler"),
    (dict(upsampler="pixelshuffledirect", embed_dim=60, upscale=2), "pixelshuffledirect"),
    (dict(upsampler="", upscale=1), "without an upsampler"),
    (dict(resi_connection="3conv"), "3conv"),
])
def test_other_variants_are_refused_by_name(tmp_path, variant, match):
    ref = _reference(**variant)
    with pytest.raises(NotImplementedError, match=match):
        load_model(_save(tmp_path, ref.state_dict(), True), arch="infer", device="cpu")


def test_session_goes_hybrid_on_the_window_canvas(tmp_path, monkeypatch):
    """Through ``InferenceSession`` with ``arch: infer``, the runner's auto
    mode as on the card goes hybrid on the window-multiple canvas (544 x
    960 for a 540 x 960 frame, its tail on four 544 x 256 tiles), and a
    small frame matches the published forward."""
    from innfer_tpu_torch.pipeline import InferenceSession, select_presets

    ref = _reference()
    path = _save(tmp_path, ref.state_dict(), True)
    sess = InferenceSession(path, arch="infer", presets=select_presets("infer", path),
                            compute_dtype=torch.float32, tile=256, overlap=16,
                            tile_mode="auto", tile_batch=8, device="cpu")
    runner = sess.stages[0].runner
    plan = runner.plan_for(540, 960, on_cuda=True)
    assert runner.mode_for(540, 960, True) == "hybrid"
    assert (plan.pad_h, plan.pad_w, plan.tile_h, plan.tile_w, plan.n_tiles) == \
        (544, 960, 544, 256, 4)
    orig = TiledRunner.mode_for
    monkeypatch.setattr(TiledRunner, "mode_for",
                        lambda self, h, w, on_cuda: orig(self, h, w, True))
    rgb = (np.random.default_rng(3).random((21, 35, 3)) * 255).astype(np.uint8)
    with torch.no_grad():
        got = sess.run_image(np.ascontiguousarray(rgb[..., ::-1]))[..., ::-1]
    assert runner.last_mode == "hybrid"
    x = torch.from_numpy(rgb.copy()).permute(2, 0, 1)[None].float() / 255
    want = torch.round(_published(ref, x).clamp(0, 1)[0] * 255).permute(1, 2, 0).numpy()
    d = np.abs(got.astype(int) - want.astype(int))
    assert d.max() <= 1 and (d > 0).mean() < 1e-3      # u8 rounding of outputs 2e-6 apart
