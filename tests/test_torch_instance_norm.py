"""Instance norm + ReLU on a conv's fp32 accumulator (``ops/instance_norm.py``)
on the CPU: the plain version against the model's composition bit for bit,
the gate's truth table, ``ops.plain_path``, the transposed conv's fp32
accumulator, and the CycleGAN generator's route through the gate with the
tracer's counters.  The kernel itself is held on the card by
``tests/test_torch_gpu.py``."""
import numpy as np
import pytest
import torch

from innfer_tpu_torch import observability as obs
from innfer_tpu_torch.models import resnet as RN
from innfer_tpu_torch.models.base import ParamDict, cast_params
from innfer_tpu_torch.nn import functional as F
from innfer_tpu_torch.ops import instance_norm as IN
from innfer_tpu_torch.ops import plain_path
from innfer_tpu_torch.tools import synth_params as SP

BF16 = torch.bfloat16


class _CudaLooking(torch.Tensor):
    """A CPU tensor that answers ``is_cuda`` True, to reach the gate that
    decides on the card."""

    @property
    def is_cuda(self):
        return True


def _acc(shape, mean=40.0, std=1.0, seed=0):
    """A bias-shifted fp32 accumulator: per-channel offsets around ``mean``."""
    g = torch.Generator().manual_seed(seed)
    shift = mean + torch.randn(shape[-1], generator=g)
    return torch.randn(*shape, generator=g) * std + shift


@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("shape", [(1, 5, 7, 16), (3, 3, 5, 24), (3, 9, 11, 64), (1, 1, 3, 8)])
def test_plain_version_is_the_models_composition_bit_for_bit(shape, relu):
    """Odd H * W, B of 1 and 3: the wrapper on a CPU tensor is
    relu(instance_norm(acc.to(bf16))) to the last bit, and counts no
    launch."""
    acc = _acc(shape, seed=sum(shape))
    before = IN.fused_instance_norm.launches
    out = IN.fused_instance_norm(acc, relu=relu)
    assert IN.fused_instance_norm.launches == before
    want = F.instance_norm(acc.to(BF16))
    if relu:
        want = F.relu(want)
    assert out.dtype == BF16 and torch.equal(out, want)
    assert torch.equal(IN.instance_norm_reference(acc, relu=relu), want)


@pytest.mark.parametrize("shape", [(1, 5, 7, 16), (3, 9, 11, 64)])
def test_stats_are_those_of_the_rounded_accumulator(shape):
    acc = _acc(shape, seed=3)
    stats = torch.empty(shape[0], 2, shape[-1])
    IN.fused_instance_norm(acc, stats=stats)
    x = acc.to(BF16).double()
    mean = x.mean(dim=(1, 2))
    var = (x - mean[:, None, None]).square().mean(dim=(1, 2))
    torch.testing.assert_close(stats[:, 0].double(), mean, rtol=1e-6, atol=0)
    torch.testing.assert_close(stats[:, 1].double(), var, rtol=1e-5, atol=0)


def test_conv_accumulator_rounded_is_the_convs_own_rounding():
    """The five convs hand the norm their fp32 accumulator: rounded to bf16
    it is what the conv returns in bf16, so the norm's input is unchanged."""
    g = torch.Generator().manual_seed(7)
    x = torch.randn(2, 9, 11, 8, generator=g).to(BF16)
    w = torch.randn(16, 8, 3, 3, generator=g) * 0.2
    b = torch.randn(16, generator=g) + 40
    acc = F.conv2d(x, w, b, stride=2, padding=1, out_dtype=torch.float32)
    assert acc.dtype == torch.float32
    assert torch.equal(acc.to(BF16), F.conv2d(x, w, b, stride=2, padding=1))


@pytest.mark.parametrize("dtype", [BF16, torch.float32])
def test_conv_transpose2d_keeps_its_fp32_accumulator(dtype):
    """``out_dtype=float32`` returns the sum before its one rounding: bf16
    operands' products summed with the fp32 bias, which rounded equals the
    default result bit for bit."""
    g = torch.Generator().manual_seed(8)
    x = torch.randn(2, 5, 7, 16, generator=g).to(dtype)
    w = torch.randn(16, 8, 3, 3, generator=g) * 0.2   # (I, O, kh, kw)
    b = torch.randn(8, generator=g)
    kw = dict(stride=2, padding=1, output_padding=1)
    acc = F.conv_transpose2d(x, w, b, out_dtype=torch.float32, **kw)
    out = F.conv_transpose2d(x, w, b, **kw)
    assert acc.dtype == torch.float32 and out.dtype == dtype
    assert acc.shape == out.shape == (2, 10, 14, 8)
    assert torch.equal(acc.to(dtype), out)
    exact = torch.nn.functional.conv_transpose2d(
        x.double().permute(0, 3, 1, 2), w.to(dtype).double(), b.double(), **kw)
    torch.testing.assert_close(acc.double(), exact.permute(0, 2, 3, 1), rtol=0, atol=1e-5)


@pytest.mark.parametrize("shape,acc_dtype,dtype,ok", [
    ((2, 4, 6, 64), torch.float32, BF16, True),
    ((1, 1, 2, 8), torch.float32, BF16, True),            # H * W = 2
    ((1, 3, 3, 1024), torch.float32, BF16, True),
    ((1, 1, 1, 64), torch.float32, BF16, False),          # H * W = 1
    ((1, 4, 4, 12), torch.float32, BF16, False),          # C % 8
    ((1, 4, 4, 1032), torch.float32, BF16, False),        # C past the merge's room
    ((1, 4, 4, 64), BF16, BF16, False),                   # not an fp32 accumulator
    ((1, 4, 4, 64), torch.float64, BF16, False),
    ((1, 4, 4, 64), torch.float32, torch.float32, False),  # an fp32 model
    ((1, 4, 4, 64), torch.float32, torch.float16, False),
    ((4, 4, 64), torch.float32, BF16, False),             # rank
    ((1, 1, 4, 4, 64), torch.float32, BF16, False),
    ((0, 4, 4, 64), torch.float32, BF16, False),
])
def test_gate_truth_table(shape, acc_dtype, dtype, ok):
    acc = torch.zeros(shape, dtype=acc_dtype)
    assert IN.takes(acc, dtype=dtype) is ok
    assert IN.fusable(acc, dtype=dtype) is False                 # a CPU tensor
    assert IN.fusable(acc.as_subclass(_CudaLooking), dtype=dtype) is ok
    if not ok:
        with pytest.raises(ValueError, match="fused_instance_norm takes"):
            IN.fused_instance_norm(acc, out_dtype=dtype)


def test_plain_path_turns_the_gate_off():
    acc = torch.zeros(1, 4, 4, 64).as_subclass(_CudaLooking)
    assert IN.fusable(acc, dtype=BF16)
    with plain_path():
        assert not IN.fusable(acc, dtype=BF16)
    assert IN.fusable(acc, dtype=BF16)


def _generator(norm="instance", dtype=BF16, seed=4):
    model = RN.build({"n_blocks": 2, "norm_type": norm, "padding_type": "reflect"})
    state = SP.cyclegan_state(n_blocks=2, ngf=8, seed=seed)
    if norm == "batch":  # each norm's channels at ngf 8
        norms = {"model.2": 8, "model.5": 16, "model.8": 32, "model.13": 16, "model.16": 8,
                 **{f"model.{10 + i}.conv_block.{j}": 32 for i in range(2) for j in (2, 6)}}
        for key, n in norms.items():
            state.update({f"{key}.weight": np.ones(n, np.float32),
                          f"{key}.bias": np.zeros(n, np.float32),
                          f"{key}.running_mean": np.zeros(n, np.float32),
                          f"{key}.running_var": np.ones(n, np.float32)})
    params = ParamDict({k: torch.from_numpy(np.asarray(v)) for k, v in state.items()})
    g = torch.Generator().manual_seed(seed)
    x = (torch.rand(1, 20, 28, 3, generator=g) * 2 - 1).to(dtype)
    return model, cast_params(params, dtype), x


def _counted(model, params, x):
    obs.reset()
    try:
        with torch.no_grad(), torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]):
            out = model.apply(params, x)
        return out, obs.summary()["counters"]
    finally:
        obs.reset()


def test_generator_counts_its_five_norms_and_the_gate_changes_no_bit(monkeypatch):
    """On the CPU the five norms run plain (counted, none fused); with the
    gate answering as on the card the wrapper's plain version runs in their
    place (all five counted fused) and the output is the same to the last
    bit."""
    model, params, x = _generator()
    plain, counters = _counted(model, params, x)
    assert counters["norms"] == 5 and counters.get("norms_fused", 0) == 0
    monkeypatch.setattr(IN, "fusable", IN.takes)
    gated, counters = _counted(model, params, x)
    assert counters["norms"] == counters["norms_fused"] == 5
    assert gated.dtype == BF16 and torch.equal(gated, plain)


@pytest.mark.parametrize("norm,dtype,norms", [("instance", torch.float32, 5),
                                              ("batch", BF16, 0)])
def test_fp32_and_batch_norm_generators_do_not_take_the_kernel(monkeypatch, norm, dtype, norms):
    """An fp32 model keeps its accumulator in fp32 and the plain norm; batch
    norm keeps the conv's own rounding and is not counted."""
    monkeypatch.setattr(IN, "fusable", IN.takes)
    model, params, x = _generator(norm=norm, dtype=dtype)
    out, counters = _counted(model, params, x)
    assert counters.get("norms", 0) == norms and counters.get("norms_fused", 0) == 0
    assert out.dtype == dtype and torch.isfinite(out.float()).all()
