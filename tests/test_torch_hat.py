"""HAT on the CPU at tiny widths against the published forward
(``tests/hat_reference.py``): the port's model whole and in the runner's
hybrid mode, in fp32 and bf16, the benchmark's copy of the reference, both
attentions' plain versions against the published blocks and an emulation
of their kernel's index arithmetic, faults that the comparison must catch,
the loader (detection ahead of SwinIR, the ``params_ema`` wrapper, every
hyperparameter, the index buffers checked, the refused variants), the
kernel's gate, the counters and the CLI.  The kernel itself is held on the
card by ``tests/test_torch_gpu.py``.

Tiny: embed 60 (a width that compress_ratio 3 and squeeze_factor 30 both
divide), 2 heads of 30, window 16 and overlap ratio 0.5 as published, so
the 24 x 24 key windows reach past the canvas; canvases of 32 x 48 and a
37 x 70 image that the model reflects to 48 x 80.

Tolerances: fp32 on both sides, true fp32 (no TF32), the same operations
summed in another order (the port's linears over zero-padded rows, its
convs channels-last, its attention over key tiles with an online softmax):
2e-5 of an output in [0, 1] (observed below 5e-6); a fault moves the
output by far more, so each fault test asks for a gap of at least 100
times that.  bf16 against the fp32 forward: every activation rounds to 8
bits of mantissa, 2^-9 relative, through 4 blocks and 2 groups and the
tail, the output's spread about 0.8: an RMS gap of 0.02 and a largest of
0.1 (observed 0.008 and 0.04)."""
import math
import os.path as osp
import sys

import numpy as np
import pytest
import torch

from innfer_tpu_torch import observability as obs
from innfer_tpu_torch.checkpoint import remaps
from innfer_tpu_torch.checkpoint.detect import detect_and_infer, fingerprint_arch
from innfer_tpu_torch.loader import load_model
from innfer_tpu_torch.models import common as C
from innfer_tpu_torch.models import convert_state, get_network
from innfer_tpu_torch.models import hat as HM
from innfer_tpu_torch.nn.functional import true_fp32
from innfer_tpu_torch.ops import hat_attn as HA
from innfer_tpu_torch.ops import plain_path
from innfer_tpu_torch.ops import window_attn as WA
from innfer_tpu_torch.tiling.engine import TiledRunner

sys.path.insert(0, osp.dirname(osp.abspath(__file__)))
import hat_reference as R  # noqa: E402

TOL = 2e-5
TINY = dict(img_size=64, embed_dim=60, depths=[2, 2], num_heads=[2, 2], window_size=16,
            compress_ratio=3, squeeze_factor=30, conv_scale=0.01, overlap_ratio=0.5,
            mlp_ratio=2, upscale=4, upsampler="pixelshuffle")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The tensors here are tiny: one thread runs them many times faster
    than a pool of threads that shares the machine's cores with the other
    test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _CudaLooking(torch.Tensor):
    """A CPU tensor that answers ``is_cuda`` True, to reach the gate."""

    @property
    def is_cuda(self):
        return True


def _reference(seed=5, **kw):
    return R.seeded(R.HAT(**{**TINY, **kw}), seed)


def _port(ref, dtype=torch.float32):
    _, cfg, state = detect_and_infer(ref.state_dict())
    model = get_network(cfg)
    return model, convert_state(model, state, param_dtype=dtype, device="cpu")


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


@pytest.fixture(scope="module")
def tiny():
    ref = _reference()
    return ref, _port(ref)


@pytest.mark.parametrize("mode", ["whole", "hybrid"])
@pytest.mark.parametrize("hw", [(32, 48), (37, 70)])
def test_port_matches_the_published_forward(tiny, mode, hw):
    """The port's HAT, whole and hybrid (trunk on the window-multiple canvas,
    the x4 pixelshuffle tail on tiles), against the published module, in
    fp32: a canvas of whole windows and an image that needs the reflect
    padding."""
    ref, (model, params) = tiny
    x = _image(*hw)
    got = (_whole if mode == "whole" else _hybrid)(model, params, x)
    want = _published(ref, x)
    assert got.shape == want.shape == (1, 3, 4 * hw[0], 4 * hw[1])
    assert (got - want).abs().max().item() <= TOL


@pytest.mark.parametrize("upscale", [2, 3])
def test_other_scales_match_the_published_forward(upscale):
    """HAT's x2 (one pixelshuffle block, the phase tail) and x3 (one conv of
    9 nf outputs and PixelShuffle(3), the materialized tail): the scale is
    read from the tail's keys, and the port runs the published forward."""
    ref = _reference(depths=[2], num_heads=[2], upscale=upscale)
    model, params = _port(ref)
    assert model.scale == upscale
    x = _image(21, 35)
    got, want = _whole(model, params, x), _published(ref, x)
    assert got.shape == want.shape == (1, 3, 21 * upscale, 35 * upscale)
    assert (got - want).abs().max().item() <= TOL


def test_bf16_port_stays_near_the_published_forward(tiny):
    """The bf16 port (the attentions' plain versions with their rounding
    points, LayerNorm, the token GEMM's and the conv route's) against the
    fp32 published forward, within the module docstring's bf16 tolerance."""
    ref, _ = tiny
    model, params = _port(ref, torch.bfloat16)
    x = _image(37, 70, seed=1)
    with torch.no_grad():
        got = model.apply(params, x.permute(0, 2, 3, 1).to(torch.bfloat16)).float()
    gap = got.permute(0, 3, 1, 2) - _published(ref, x)
    assert gap.pow(2).mean().sqrt().item() <= 0.02 and gap.abs().max().item() <= 0.1


def _with_fault(monkeypatch, fault):
    if fault == "cab":
        monkeypatch.setattr(HM, "cab", lambda params, y, key, x, scale: x)
    elif fault == "gate":
        monkeypatch.setattr(HM, "channel_gate",
                            lambda params, z, key: torch.ones(z.shape[0], z.shape[-1]))
    elif fault == "masked_pad":
        orig_att = HA._attend

        def masked(q, k, v, bias, mask, **kw):
            if k.shape[-2] == 576:   # the OCA: mask the keys that lie outside the canvas
                mask = torch.where((k == 0).all(-1).any(1)[:, None, :], -1e4, 0.0)
                mask = mask.expand(k.shape[0], q.shape[-2], k.shape[-2])
            return orig_att(q, k, v, bias, mask, **kw)
        monkeypatch.setattr(HA, "_attend", masked)
    elif fault == "oca_index":
        orig_idx = HA.oca_index
        monkeypatch.setattr(HA, "oca_index", lambda w, kw, device=None: orig_idx(
            w, kw, device).view(w * w, kw, kw).transpose(1, 2).reshape(w * w, kw * kw))
    elif fault == "shift":
        orig_sa = HA.hat_window_attn_reference
        monkeypatch.setattr(HA, "hat_window_attn_reference",
                            lambda *a, **k: orig_sa(*a, **{**k, "shift": 0}))


@pytest.mark.parametrize("fault", ["cab", "gate", "masked_pad", "oca_index", "shift"])
def test_each_fault_fails_the_comparison(tiny, monkeypatch, fault):
    """Left out of the port's plain path, each of the CAB, its channel gate,
    the OCA's zero keys and values outside the canvas (masked instead), the
    OCA table's index (its key window transposed) and the cyclic shift
    moves the output far past the tolerance of the comparison above."""
    ref, (model, params) = tiny
    _with_fault(monkeypatch, fault)
    x = _image(32, 48)
    gap = (_whole(model, params, x) - _published(ref, x)).abs().max().item()
    assert gap > 100 * TOL, gap


def test_benchmark_reference_matches_the_published_forward():
    """``innbench/reference/hat.py`` (the benchmark's own copy, which
    imports nothing of the port) on its seeded state, loaded into the
    published module, both fp32: the two copies agree."""
    from innbench.reference import hat as BR

    model = dict(in_chans=3, embed_dim=60, depths=[2, 2], num_heads=[2, 2], window_size=16,
                 compress_ratio=3, squeeze_factor=30, conv_scale=0.01, overlap_ratio=0.5,
                 mlp_ratio=2, img_size=64, img_range=1.0, upsampler="pixelshuffle",
                 resi_connection="1conv", num_feat=64, scale=4, out_std=0.25, bias_std=1.0,
                 qkv_gain=math.sqrt(2.0), branch_gain=0.4, group_gain=0.4, cab_gain=25.0,
                 gate_gain=0.03, gate_std=0.8)
    state = BR.make_state(model, 7, "cpu")
    ref = R.HAT(**TINY).eval()
    ref.load_state_dict(state)
    x = _image(37, 70, seed=2)
    with torch.no_grad(), true_fp32(torch.float32):
        got = BR.forward(BR.Ops(state), x, model)
    assert (got - _published(ref, x)).abs().max().item() <= TOL


def _qkv(x, lin, heads):
    """The port's packed qkv of tokens x for the published linear ``lin``."""
    c = x.shape[-1]
    cp = WA.padded(c)
    w, b = WA.pack_qkv(lin.weight, lin.bias, heads, cp)
    return torch.nn.functional.pad(x, (0, cp - c)) @ w.t() + b


@pytest.mark.parametrize("shift", [0, 8])
def test_window_attention_plain_version_matches_the_published_block(shift):
    """``hat_window_attn_reference`` between the packed qkv and proj against
    the published HAB's WindowAttention with the roll, partition, reverse
    and roll back around it, on a 32 x 48 canvas of 2 heads of 30."""
    torch.manual_seed(3)
    hat = _reference(seed=6)
    blk = hat.layers[0].residual_group.blocks[1]
    x = torch.randn(1, 32, 48, 60)
    with torch.no_grad(), true_fp32(torch.float32):
        xs = torch.roll(x, (-shift, -shift), (1, 2)) if shift else x
        win = R.window_partition(xs, 16).view(-1, 256, 60)
        mask = hat.calculate_mask((32, 48)) if shift else None
        o = blk.attn(win, hat.relative_position_index_SA, mask=mask)
        o = R.window_reverse(o.view(-1, 16, 16, 60), 16, 32, 48)
        want = torch.roll(o, (shift, shift), (1, 2)) if shift else o
        a = HA.hat_window_attn_reference(_qkv(x, blk.attn.qkv, 2),
                                         blk.attn.relative_position_bias_table, heads=2,
                                         head_dim=30, window=16, shift=shift)
        got = a[..., :60] @ blk.attn.proj.weight.t() + blk.attn.proj.bias
    assert (got - want).abs().max().item() <= TOL and not a[..., 60:].any()


class _Zero(torch.nn.Module):
    def forward(self, t):
        return torch.zeros_like(t)


def test_overlap_attention_plain_version_matches_the_published_block():
    """``overlap_attn_reference`` between the packed qkv and proj against the
    published OCAB's attention (nn.Unfold of k and v, the table through
    ``calculate_rpi_oca`` with negative rows wrapped), on a 32 x 48 canvas
    whose key windows reach past every edge."""
    torch.manual_seed(4)
    hat = _reference(seed=7)
    oc = hat.layers[0].residual_group.overlap_attn
    x = torch.randn(1, 32, 48, 60)
    with torch.no_grad(), true_fp32(torch.float32):
        # the published block with its MLP silenced: y + proj(attn(LN1 y))
        oc.mlp = _Zero()
        y = x.view(1, 32 * 48, 60)
        want = oc(y, (32, 48), hat.relative_position_index_OCA)
        yln = oc.norm1(y).view(1, 32, 48, 60)
        a = HA.overlap_attn_reference(_qkv(yln, oc.qkv, 2), oc.relative_position_bias_table,
                                      heads=2, head_dim=30, window=16, kwin=24)
        got = a[..., :60] @ oc.proj.weight.t() + oc.proj.bias + x
    assert (got.view(1, -1, 60) - want).abs().max().item() <= TOL
    assert torch.equal(HA.oca_index(16, 24), hat.relative_position_index_OCA)
    assert torch.equal(HA.sa_index(16), hat.relative_position_index_SA)


@pytest.mark.parametrize("oca", [False, True])
def test_kernel_bias_index_arithmetic_emulated(oca):
    """The kernel's bias read (``csrc/hat_attn.cu``): the table's column
    staged rotated by ROT rows, read at C + SGN (P (ai - aj) + bi - bj) for
    query (ai, bi) and key (aj, bj); it equals the table read through the
    published index, PyTorch's wrap of negative rows included."""
    ws, kwin = 16, (24 if oca else 16)
    p, c, sgn, rot = (39, 600, -1, 880) if oca else (31, 480, 1, 0)
    table = torch.randn(p * p)
    staged = table[(torch.arange(p * p) - rot) % (p * p)]
    qa, qb = torch.meshgrid(torch.arange(ws), torch.arange(ws), indexing="ij")
    ka, kb = torch.meshgrid(torch.arange(kwin), torch.arange(kwin), indexing="ij")
    i = (p * qa + qb).reshape(-1, 1)
    j = (p * ka + kb).reshape(1, -1)
    got = staged[c + sgn * (i - j)]
    index = HA.oca_index(ws, kwin) if oca else HA.sa_index(ws)
    assert torch.equal(got, table[index])
    if oca:   # the published index is negative for some pairs, and covers every row once
        assert index.min().item() < 0 and sorted(set((index % (p * p)).flatten().tolist())) \
            == list(range(p * p))


def _save(tmp_path, state, wrap, name="hat.pth"):
    path = str(tmp_path / name)
    torch.save({"params_ema": state} if wrap else state, path)
    return path


@pytest.mark.parametrize("wrap", [True, False])
def test_loader_detects_hat_and_infers_every_hyperparameter(tmp_path, wrap):
    """A released-layout state dict (the published module's, its index
    buffers included), wrapped in ``params_ema`` or not, is detected as HAT
    (not SwinIR, whose key it shares) with every hyperparameter of the
    module, and runs as the published forward."""
    ref = _reference(depths=[2, 3], num_heads=[2, 3], mlp_ratio=3)
    model, params = load_model(_save(tmp_path, ref.state_dict(), wrap), device="cpu")
    cfg = model.cfg
    assert fingerprint_arch(ref.state_dict())[0] == "hat"
    assert (cfg["type"], cfg["embed_dim"], cfg["depths"], cfg["num_heads"]) == (
        "hat", 60, [2, 3], [2, 3], )
    assert (cfg["window_size"], cfg["overlap_ratio"], cfg["compress_ratio"],
            cfg["squeeze_factor"], cfg["mlp_ratio"], cfg["conv_scale"]) == (16, 0.5, 3, 30, 3.0,
                                                                              0.01)
    assert (cfg["upsampler"], cfg["upscale"], cfg["resi_connection"], cfg["in_chans"]) == (
        "pixelshuffle", 4, "1conv", 3)
    assert not any("relative_position_index" in k for k in params)
    x = _image(32, 32)
    assert (_whole(model, params, x) - _published(ref, x)).abs().max().item() <= TOL


def test_swinir_is_still_detected_as_swinir():
    """A SwinIR state dict (HAT's window-attention key, no OCA table) is
    still SwinIR, with the same parameters."""
    import swinir_reference as SR

    sw = SR.seeded(SR.SwinIR(img_size=64, embed_dim=24, depths=[2, 2], num_heads=[2, 2],
                             window_size=8, mlp_ratio=2, upscale=4, upsampler="nearest+conv"), 3)
    arch, cfg, _ = detect_and_infer(sw.state_dict())
    assert arch == "swinir" and cfg["type"] == "swinir"
    assert (cfg["window_size"], cfg["embed_dim"], cfg["upsampler"]) == (8, 24, "nearest+conv")


@pytest.mark.parametrize("buffer", [remaps.HAT_INDEX_SA, remaps.HAT_INDEX_OCA])
def test_loader_refuses_an_index_buffer_that_differs(tmp_path, buffer):
    """The program reads the tables through its own index: a checkpoint
    whose index buffer differs (here one pair swapped, or a transposed key
    window) is refused, naming the buffer."""
    state = _reference().state_dict()
    bad = state[buffer].clone()
    if buffer == remaps.HAT_INDEX_SA:
        bad[0, 1], bad[0, 2] = bad[0, 2].item(), bad[0, 1].item()
    else:
        bad = bad.view(256, 24, 24).transpose(1, 2).reshape(256, 576)
    state[buffer] = bad
    with pytest.raises(ValueError, match=buffer):
        load_model(_save(tmp_path, state, True), device="cpu")


@pytest.mark.parametrize("variant,match", [
    (dict(upsampler=""), "upsampler ''"),
    (dict(resi_connection="identity"), "residual connection 'identity'"),
])
def test_refused_variants_are_named(tmp_path, variant, match):
    """A HAT file the program does not run is refused by name."""
    ref = _reference(**variant)
    with pytest.raises(NotImplementedError, match=match):
        load_model(_save(tmp_path, ref.state_dict(), True), device="cpu")


_GATE = [  # (qkv shape, heads, head_dim, window, shift, kwin, dtype, table rows, takes)
    ((1, 544, 960, 576), 6, 30, 16, 8, None, torch.bfloat16, 961, True),
    ((2, 32, 48, 192), 2, 30, 16, 0, None, torch.bfloat16, 961, True),
    ((1, 544, 960, 576), 6, 30, 16, 0, 24, torch.bfloat16, 1521, True),
    ((1, 16, 16, 192), 2, 32, 16, 0, 24, torch.bfloat16, 1521, True),
    ((1, 32, 48, 576), 6, 30, 16, 8, None, torch.float32, 961, False),   # fp32
    ((1, 32, 48, 540), 6, 30, 16, 8, None, torch.bfloat16, 961, False),  # heads not padded
    ((1, 32, 48, 576), 6, 30, 8, 4, None, torch.bfloat16, 225, False),   # window 8
    ((1, 32, 48, 576), 6, 30, 16, 4, None, torch.bfloat16, 961, False),  # a shift of 4
    ((1, 24, 48, 576), 6, 30, 16, 0, None, torch.bfloat16, 961, False),  # rows not 16 x
    ((1, 32, 48, 576), 6, 30, 16, 0, 32, torch.bfloat16, 2209, False),   # overlap ratio 1
    ((1, 32, 48, 576), 6, 30, 16, 8, 24, torch.bfloat16, 1521, False),   # a shifted OCA
    ((1, 32, 48, 576), 6, 30, 16, 0, 24, torch.bfloat16, 961, False),    # the HAB's table
    ((1, 32, 48, 576), 6, 31, 16, 0, None, torch.bfloat16, 961, False),  # odd head width
]


@pytest.mark.parametrize("case", _GATE)
def test_hat_attn_gate(case):
    shape, heads, hd, window, shift, kwin, dtype, rows, ok = case
    qkv = torch.zeros(shape, dtype=dtype)
    table = torch.zeros(rows, heads)
    kw = dict(heads=heads, head_dim=hd, window=window, shift=shift, kwin=kwin)
    assert HA.takes(qkv, table, **kw) is ok
    assert HA.fusable(qkv, table, **kw) is False                      # a CPU tensor
    assert HA.fusable(qkv.as_subclass(_CudaLooking), table, **kw) is ok
    with plain_path():
        assert not HA.fusable(qkv.as_subclass(_CudaLooking), table, **kw)
    sharded = torch.zeros(3)
    sharded.tp_shards = (sharded,)
    assert HA.takes(qkv, table, weight=sharded, **kw) is False


def _counted(fn):
    obs.reset()
    try:
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
            with torch.no_grad():
                out = fn()
        return out, obs.summary()
    finally:
        obs.reset()


def test_counters_span_and_the_gates_on_the_cpu(tiny, monkeypatch):
    """Every block's attention, linears and CAB are counted; on the CPU none
    runs on a kernel; with the attention gate forced open (bf16) the
    wrappers run their plain versions on the CPU, every attention counts as
    fused, and the output is the same bits."""
    ref, _ = tiny
    model, params = _port(ref, torch.bfloat16)
    x = _image(32, 48).permute(0, 2, 3, 1).to(torch.bfloat16)
    out0, s0 = _counted(lambda: model.apply(params, x))
    monkeypatch.setattr(HA, "fusable", HA.takes)
    out1, s1 = _counted(lambda: model.apply(params, x))
    c0, c1 = s0["counters"], s1["counters"]
    assert c0["window_attns"] == c1["window_attns"] == 4
    assert c0["overlap_attns"] == c1["overlap_attns"] == 2
    assert c0["swin_linears"] == 3 * 6 and c0.get("swin_linears_fused", 0) == 0
    assert c0.get("window_attns_fused", 0) == c0.get("overlap_attns_fused", 0) == 0
    assert c1["window_attns_fused"] == 4 and c1["overlap_attns_fused"] == 2
    assert s0["spans"]["innfer.cab"]["count"] == 4
    assert c0["tail_convs"] == 3
    assert torch.equal(out0, out1)


def test_trunk_kernel_and_hybrid_canvas():
    """The model asks for the hybrid split where the kernel takes its
    blocks (window 16, overlap 0.5, heads of at most 32), on the window's
    multiple, with the tail's 2 LR px of reach."""
    model, _ = _port(_reference())
    assert model.trunk_kernel and model.tail_halo == 2
    assert model.hybrid_canvas(540, 960) == (544, 960)
    assert not _port(_reference(overlap_ratio=0.25))[0].trunk_kernel


def test_cli_runs_a_hat_checkpoint(tmp_path):
    """The CLI, auto-detecting the architecture, upscales a PNG with a HAT
    checkpoint on the CPU (the main path's entry point)."""
    import cv2

    from innfer_tpu_torch import cli

    ref = _reference(depths=[2], num_heads=[2])
    ckpt = _save(tmp_path, ref.state_dict(), True, "4x_hat.pth")
    src, dst = tmp_path / "in", tmp_path / "out"
    src.mkdir()
    img = (np.random.default_rng(3).random((20, 36, 3)) * 255).astype(np.uint8)
    cv2.imwrite(str(src / "a.png"), img)
    assert cli.main(["-m", ckpt, "-i", str(src), "-o", str(dst), "-cpu"]) == 0
    out = cv2.imread(str(dst / "a.png"))
    assert out is not None and out.shape == (80, 144, 3)


def _tail_params(seed, up_mode, nf=16, hr_conv=True):
    """A flattened-sequential x4 tail at ``tail``: two upsample blocks, then
    the HR conv and conv_last (``hr_conv``) or conv_last alone."""
    g = torch.Generator().manual_seed(seed)
    out = nf * 4 if up_mode == "pixelshuffle" else nf
    keys = [("tail.0" if up_mode == "pixelshuffle" else "tail.1", out, nf),
            ("tail.3" if up_mode == "pixelshuffle" else "tail.4", out, nf)]
    hr0 = 6
    keys += [(f"tail.{hr0}", nf, nf), (f"tail.{hr0 + 2}", 3, nf)] if hr_conv else \
        [(f"tail.{hr0}", 3, nf)]
    p = {}
    for k, o, i in keys:
        p[f"{k}.weight"] = torch.randn(o, i, 3, 3, generator=g) / (3 * i ** 0.5)
        p[f"{k}.bias"] = torch.randn(o, generator=g) * 0.1
    return p


def test_pixelshuffle_phase_tail_equals_the_materialized_one():
    """HAT's tail without an HR conv in phase space equals the materialized
    composition (conv, shuffle, conv, shuffle, conv_last) in fp32 within
    the tail conv's order-of-sums tolerance."""
    p = _tail_params(1, "pixelshuffle", hr_conv=False)
    h = torch.randn(1, 9, 13, 16, generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        got = C.sr_tail(p, h, "tail", upscale=4, up_mode="pixelshuffle", act_type=None,
                        finalact=None, start=0, hr_conv=False)
        t = h.permute(0, 3, 1, 2)
        for k in ("tail.0", "tail.3"):
            t = torch.nn.functional.pixel_shuffle(
                torch.nn.functional.conv2d(t, p[f"{k}.weight"], p[f"{k}.bias"], padding=1), 2)
        want = torch.nn.functional.conv2d(t, p["tail.6.weight"], p["tail.6.bias"], padding=1)
    assert got.shape == (1, 36, 52, 3)
    assert (got.permute(0, 3, 1, 2) - want).abs().max().item() <= 1e-5


@pytest.mark.parametrize("phase", [True, False])
@pytest.mark.parametrize("up_mode", ["upconv", "pixelshuffle"])
def test_existing_tail_forms_are_bit_identical(monkeypatch, phase, up_mode):
    """The tail with an HR conv (ESRGAN's, SRResNet's, PPON's, SwinIR's),
    in phase space and materialized, gives the same bits as the
    composition the shared tail ran before it took the HR-conv-less form:
    the last upsample block, the HR conv with its act and conv_last, or
    the upsample blocks and the two HR convs at full resolution."""
    if not phase:
        monkeypatch.setattr(C, "phase_tail_ok", lambda *a, **k: False)
    p = _tail_params(3, up_mode)
    hr0 = 6
    h = torch.randn(1, 7, 11, 16, generator=torch.Generator().manual_seed(4))
    kw = dict(up_mode=up_mode, act_type="leakyrelu", finalact=None)
    with torch.no_grad():
        got = C.sr_tail(p, h, "tail", upscale=4, start=0, **kw)
        up_convs, _ = C.upsample_indices(4, up_mode, start=0)
        t = h
        for ci in (up_convs[:-1] if phase else up_convs):
            t = C.apply_upsample_block(p, t, f"tail.{ci}", mode=up_mode, factor=2,
                                       act_type="leakyrelu")
        if phase:
            want = C.apply_phase_tail(p, t, up_key=f"tail.{up_convs[-1]}", up_mode=up_mode,
                                      act_type="leakyrelu", hr0=hr0, finalact=None,
                                      out_prefix="tail")
        else:
            want = C.apply_hr_convs(p, t, "tail", hr0, "leakyrelu")
    assert torch.equal(got, want)
