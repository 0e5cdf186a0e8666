"""The SR tail's conv kernel (``ops/tail_conv.py``) on the CPU: its gate,
its packed weights read as the kernel reads them (:func:`emulate`) against
the plain composition of ``models/common.py``, and the tracer's counters
of the tail's convs.  The kernel itself runs only on the card
(``tests/test_torch_gpu.py``)."""
import numpy as np
import pytest
import torch

from innfer_tpu_torch import observability as obs
from innfer_tpu_torch.config.defaults import get_network_config
from innfer_tpu_torch.models import common as C
from innfer_tpu_torch.models import convert_state, get_network
from innfer_tpu_torch.nn import functional as F
from innfer_tpu_torch.nn import phase as PH
from innfer_tpu_torch.ops import tail_conv as TC


def _t(*shape, seed=0, scale=1.0):
    g = np.random.default_rng(seed)
    return torch.from_numpy(g.standard_normal(shape).astype(np.float32) * scale)


def test_gate_takes_bf16_3x3_with_a_fusable_act_only():
    """bf16, an unsharded 3x3 weight, None/LeakyReLU/ReLU and channel counts
    the kernel takes; fp32, a sharded weight, tanh, a 1x1 weight, odd
    channel counts and more than 64 outputs a phase take the plain route,
    and so does every CPU tensor."""
    x = torch.zeros(1, 4, 4, 64, dtype=torch.bfloat16)
    w = torch.zeros(64, 64, 3, 3, dtype=torch.bfloat16)
    p = torch.zeros(1, 4, 4, 256, dtype=torch.bfloat16)
    for act in (None, "leakyrelu", "lrelu", "LeakyReLU", "relu"):
        assert TC.takes(x, w, act, mode="upconv") and TC.takes(p, w, act, mode="phase")
    assert TC.takes(x, torch.zeros(12, 64, 3, 3), "lrelu", mode="pixelshuffle")
    sharded = w.clone()
    sharded.tp_shards = (w[:32], w[32:])
    refused = [(x.float(), w, None, "upconv"), (x, sharded, None, "upconv"),
               (x, w, "tanh", "upconv"), (x, w, "prelu", "upconv"),
               (x, w[..., :1, :1], None, "upconv"), (x, w, None, "phase"),
               (p[..., :96], torch.zeros(3, 24, 3, 3), None, "phase"),
               (x, torch.zeros(80, 64, 3, 3), None, "upconv"),
               (x, torch.zeros(14, 64, 3, 3), None, "pixelshuffle")]
    for xx, ww, act, mode in refused:
        assert not TC.takes(xx, ww, act, mode=mode), (tuple(ww.shape), act, mode)
    assert not TC.fusable(x, w, None, mode="upconv")  # a CPU tensor


def _one_ulp(a, b):
    """Every value within one bf16 ulp of the plain version's (plus 1e-4 for
    values the rounding leaves near 0), and nearly all equal: the fp32 sums
    are taken in another order, so a rounding may flip."""
    a, b = a.float(), b.float()
    assert a.shape == b.shape
    assert ((a - b).abs() <= 2 ** -7 * b.abs() + 1e-4).all()
    assert (a == b).float().mean().item() >= 0.98


@pytest.mark.parametrize("nf,cp,act", [(16, 16, "leakyrelu"), (32, 8, None), (64, 3, "relu"),
                                       (16, 64, "lrelu")])
def test_packed_weights_emulated_equal_the_plain_composition(nf, cp, act):
    """Each mode and layout's packed weights, read chunk by chunk and wgmma
    by wgmma as the kernel reads them, against the plain composition in
    bf16 at a ragged size: the same fp32 sums in another order, the same
    rounding and activation."""
    x = _t(2, 5, 7, nf, seed=1).bfloat16()
    p = _t(2, 5, 7, 4 * nf, seed=2).bfloat16()
    w = _t(cp, nf, 3, 3, seed=3, scale=(3 * nf) ** -0.5).bfloat16()
    b = _t(cp, seed=4, scale=0.1)
    w2 = C.collapse_upconv_weight(w, None, 2)[0]
    packed = TC.pack_plain(PH.cmajor_to_phase_major(w2), PH.phase_bias(b))
    up = F.conv2d(x, w2, b.repeat_interleave(4), padding=1)
    _one_ulp(TC.tail_conv(x, packed, act=act, layout="shuffle"),
             F.act(act, F.pixel_shuffle(up, 2)))
    _one_ulp(TC.tail_conv(x, packed, act=act, layout="phase"),
             F.act(act, F.conv2d(x, PH.cmajor_to_phase_major(w2), PH.phase_bias(b), padding=1)))
    _one_ulp(TC.tail_conv(p, TC.pack_phase(w, b), act=act, layout="phase"),
             F.act(act, PH.phase_conv3x3(p, w, b)))


def test_each_input_phase_feeds_nine_of_the_hr_convs_taps():
    """The taps that read each input phase's chunks: 9 of the 36 (output
    phase, tap) pairs each, at a grid offset of at most one cell, and every
    pair once over the four input phases: the HR conv's own operations."""
    seen = []
    for p in range(4):
        taps = TC.phase_taps(p)
        assert len(taps) == 9
        for q, oy, ox, dy, dx in taps:
            a, c = divmod(q, 2)
            assert divmod(a + dy, 2) == (oy, p // 2) and divmod(c + dx, 2) == (ox, p % 2)
            seen.append((q, dy, dx))
    assert sorted(seen) == [(q, dy, dx) for q in range(4) for dy in (-1, 0, 1)
                            for dx in (-1, 0, 1)]


@pytest.mark.parametrize("phase_tail", [True, False])
def test_cpu_tail_counts_its_convs_and_fuses_none(monkeypatch, phase_tail):
    """Under the profiler a 4x ESRGAN tail on the CPU counts its four convs
    (the phase tail: the upsample block, the phase tail's first conv, the
    HR conv, conv_last; the materialized tail: two upsample blocks, the HR
    conv, conv_last) and runs none on the kernel."""
    if not phase_tail:
        monkeypatch.setattr(C, "phase_tail_ok", lambda *a, **k: False)
    nf = 16
    state = {}
    for i, (key, o) in enumerate((("model.3", nf), ("model.6", nf), ("model.8", nf),
                                  ("model.10", 3))):
        state[f"{key}.weight"] = _t(o, nf, 3, 3, seed=i, scale=0.1)
        state[f"{key}.bias"] = _t(o, seed=10 + i, scale=0.01)
    model = get_network(get_network_config({"type": "esrgan", "nb": 1, "nf": nf}, 4))
    params = convert_state(model, state, param_dtype=torch.bfloat16, device=torch.device("cpu"))
    obs.reset()
    launches = TC.tail_conv.launches
    try:
        with torch.no_grad(), torch.profiler.profile():
            out = model.apply_tail(params, _t(1, 6, 5, nf, seed=7).bfloat16())
        assert out.shape == (1, 24, 20, 3)
        counters = obs.summary()["counters"]
        assert counters["tail_convs"] == 4 and counters.get("tail_convs_fused", 0) == 0
        assert TC.tail_conv.launches == launches
    finally:
        obs.reset()
