"""PPON's dilated multi-rate block and the model's trunk/tail split on the
CPU: the block's plain fp32 composition (``dilated_block_reference``)
against the model's plain path, the kernel's weight layout read back as the
kernel reads it, the gate and the wrapper's refusal of a CPU tensor, the
split model against ``apply``, the phase tails against the materialized
ones, and the tracer's counters.  The kernel itself is held on the card by
``tests/test_torch_gpu.py``."""
import numpy as np
import pytest
import torch

from innfer_tpu_torch import observability as obs
from innfer_tpu_torch.models import common as C
from innfer_tpu_torch.models import ppon as PP
from innfer_tpu_torch.models.base import ParamDict, cast_params
from innfer_tpu_torch.ops import dilated_block as DB
from innfer_tpu_torch.tools import synth_params as SP


class _CudaLooking(torch.Tensor):
    """A CPU tensor that answers ``is_cuda`` True, to reach the gate that
    decides on the card (the wrapper then runs its CPU path)."""

    @property
    def is_cuda(self):
        return True


def _model(nf=16, nb=1, scale=4, alpha=1.0, dtype=torch.float32, seed=3):
    state = SP.ppon_state(nb=nb, nf=nf, scale=scale, seed=seed)
    params = ParamDict({k: torch.from_numpy(np.asarray(v)) for k, v in state.items()})
    model = PP.build({"nb": nb, "nf": nf, "upscale": scale, "act_type": "leakyrelu",
                      "alpha": alpha})
    return model, cast_params(params, dtype)


def _x(h=12, w=14, dtype=torch.float32, seed=0):
    g = torch.Generator().manual_seed(seed)
    return torch.rand(1, h, w, 3, generator=g).to(dtype)


def _block(dtype=torch.bfloat16, seed=5):
    model, params = _model(nf=64, dtype=dtype, seed=seed)
    return params, "CFEM.1.sub.0.RB2"


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("with_res", [False, True])
def test_block_reference_equals_the_plain_path(dtype, with_res):
    """The kernel's plain version takes the plain path's rounding points:
    on the CPU, where both sum in fp32 in the same order, the same bits."""
    params, prefix = _block(dtype)
    g = torch.Generator().manual_seed(1)
    x = torch.randn(2, 11, 19, 64, generator=g).to(dtype)
    res = torch.randn(2, 11, 19, 64, generator=g).to(dtype) if with_res else None
    w, b = PP._block_params(params, prefix)
    with torch.no_grad():
        plain = PP._res_block_32(params, x, prefix, res=res)
        ref = DB.dilated_block_reference(x, w, b, res=res)
    assert torch.equal(plain, ref)


def test_fused_block_refuses_a_cpu_tensor():
    """The kernel runs on the card alone: the model's gate keeps CPU tensors
    on the plain composition, and the wrapper refuses them."""
    params, prefix = _block()
    x = torch.randn(1, 9, 13, 64).bfloat16()
    w, b = PP._block_params(params, prefix)
    before = DB.fused_dilated_block.launches
    with pytest.raises(ValueError, match="runs on CUDA tensors"):
        DB.fused_dilated_block(x, w, b)
    assert DB.fused_dilated_block.launches == before


def test_gate_takes_only_the_kernels_configuration():
    params, prefix = _block()
    w, b = PP._block_params(params, prefix)
    x = torch.zeros(1, 8, 8, 64, dtype=torch.bfloat16)
    assert DB.takes(x, w, b) and not DB.fusable(x, w, b)
    assert DB.fusable(x.as_subclass(_CudaLooking), w, b)
    assert not DB.takes(x.float(), w, b)                        # fp32: plain
    assert not DB.takes(torch.zeros(1, 8, 8, 16, dtype=torch.bfloat16), w, b)  # nf 16
    assert not DB.takes(x, w, b[:-1] + [None])                  # a missing bias
    sharded = w[0].clone()
    sharded.tp_shards = [sharded]
    assert not DB.takes(x, [sharded] + w[1:], b)
    with pytest.raises(ValueError, match="fused_dilated_block takes"):
        DB.fused_dilated_block(x.float(), w, b)


def test_c2_fragments_read_back_as_the_kernel_reads_them():
    """pack_fuse's B fragments, and the A words a lane loads, run through
    the mma.sync fragment rules of ``dilated_block.cu`` step by step, give
    the 1x1 conv: lane (g, t) of k-step j = 2 m + e takes words 2 e and
    2 e + 1 of its load of channels 32 m + 8 t .. + 7; n8 tile i's column
    2 t + c % 2 is output channel 16 t + 2 i + c % 2."""
    g_ = torch.Generator().manual_seed(2)
    w2 = torch.randn(64, 256, 1, 1, generator=g_)
    pk = DB.pack_fuse(w2).float().reshape(16, 8, 32, 4)
    ws = torch.randn(5, 256, generator=g_).bfloat16().float()
    out = torch.zeros(5, 64)
    for j in range(16):
        m, e = divmod(j, 2)
        a = torch.zeros(5, 16)
        for t in range(4):
            words = ws[:, 32 * m + 8 * t: 32 * m + 8 * t + 8]
            a[:, 2 * t:2 * t + 2] = words[:, 4 * e:4 * e + 2]
            a[:, 2 * t + 8:2 * t + 10] = words[:, 4 * e + 2:4 * e + 4]
        for i in range(8):
            bmat = torch.zeros(16, 8)
            for lane in range(32):
                g, t = divmod(lane, 4)
                bmat[2 * t:2 * t + 2, g] = pk[j, i, lane, 0:2]
                bmat[2 * t + 8:2 * t + 10, g] = pk[j, i, lane, 2:4]
            cols = a @ bmat
            for c in range(8):
                out[:, 16 * (c // 2) + 2 * i + c % 2] += cols[:, c]
    want = ws @ w2[:, :, 0, 0].bfloat16().float().t()
    torch.testing.assert_close(out, want, rtol=0, atol=1e-5)


def test_pack_block_lays_the_convs_back_to_back():
    params, prefix = _block()
    pk = DB.pack_block(*PP._block_params(params, prefix))
    assert pk.w.dtype == torch.bfloat16 and pk.w2.dtype == torch.bfloat16
    assert pk.w.numel() == 4 * 9 * 16 * 64 + 8 * 4 * 9 * 16 * 32   # chunks x taps x 16 x N
    assert pk.b.numel() == 64 + 8 * 32 and pk.w2.numel() == 64 * 256 and pk.b2.numel() == 64
    assert pk.b.dtype == pk.b2.dtype == torch.float32


@pytest.mark.parametrize("nf,scale,dtype", [(16, 4, torch.float32), (16, 2, torch.bfloat16),
                                            (64, 4, torch.bfloat16), (16, 3, torch.float32)])
def test_split_model_equals_apply(nf, scale, dtype):
    """apply_tail(apply_trunk(x)) is apply's out_p, bit for bit; the trunk
    gives the three 64-channel maps as one tensor."""
    model, params = _model(nf=nf, scale=scale, alpha=0.7, dtype=dtype)
    x = _x(dtype=dtype)
    with torch.no_grad():
        feats = model.apply_trunk(params, x)
        split = model.apply_tail(params, feats)
        whole = model.apply(params, x)
    assert feats.shape == (1, 12, 14, 3 * nf)
    assert len(whole) == 3 and model.output_index == 2
    assert torch.equal(split, whole[2])
    assert split.shape == (1, 12 * scale, 14 * scale, 3)


@pytest.mark.parametrize("dtype,db", [(torch.float32, 110), (torch.bfloat16, 35)])
def test_phase_tails_agree_with_the_materialized_tails(monkeypatch, dtype, db):
    """The three branches' phase tails against the materialized HR tails,
    each summed at full resolution: all three outputs."""
    model, params = _model(nf=16, alpha=0.5, dtype=dtype)
    x = _x(dtype=dtype, seed=2)
    with torch.no_grad():
        phase = model.apply(params, x)
        with monkeypatch.context() as m:
            m.setattr(C, "phase_tail_ok", lambda *a, **k: False)
            plain = model.apply(params, x)
    for a, b in zip(phase, plain):
        a, b = a.float().numpy(), b.float().numpy()
        mse = float(np.mean((a - b) ** 2))
        peak = max(1.0, float(np.abs(b).max()))
        assert mse == 0 or 10 * np.log10(peak ** 2 / mse) >= db


def _counted(model, params, x):
    obs.reset()
    try:
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
            with torch.no_grad():
                model.apply_tail(params, model.apply_trunk(params, x))
        return obs.summary()["counters"]
    finally:
        obs.reset()


def test_counters_count_every_block_of_a_forward():
    """84 blocks a forward at nb 24: on the CPU none fused; the tail's 12
    convs counted too (4 a branch)."""
    model, params = _model(nf=16, nb=24, dtype=torch.bfloat16)
    counters = _counted(model, params, _x(8, 8, torch.bfloat16))
    assert counters["dilated_blocks"] == 84
    assert counters.get("dilated_blocks_fused", 0) == 0
    assert counters["tail_convs"] == 12


def test_counters_see_the_kernels_gate(monkeypatch):
    """At nf 64 on a CUDA-looking bf16 tensor every block takes the kernel's
    wrapper (here a stand-in that runs the reference)."""
    model, params = _model(nf=64, nb=1, dtype=torch.bfloat16)
    calls = []

    def spy(x, w, b, **kw):
        calls.append(kw.get("res") is not None)
        res = None if kw.get("res") is None else kw["res"].as_subclass(torch.Tensor)
        return DB.dilated_block_reference(x.as_subclass(torch.Tensor), w, b,
                                          res=res).as_subclass(_CudaLooking)

    monkeypatch.setattr(DB, "fused_dilated_block", spy)
    x = _x(8, 8, torch.bfloat16).as_subclass(_CudaLooking)
    counters = _counted(model, params, x)
    assert counters["dilated_blocks"] == counters["dilated_blocks_fused"] == 15
    assert calls == [False, False, True] * 5   # every third block takes the RRBlock's residual


def test_trunk_kernel_at_the_kernels_width_only():
    assert _model(nf=64)[0].trunk_kernel
    assert not _model(nf=16)[0].trunk_kernel
    model = _model(nf=64)[0]
    assert model.tail_halo == 4
    assert model.apply_trunk is not None and model.apply_tail is not None
