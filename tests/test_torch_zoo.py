"""The port's SR zoo (SRResNet, PAN, PPON, the ESRGAN norm/PReLU/Swish
variants) against the reference goldens and the JAX package.

Goldens (fp32, reference PyTorch outputs): >= 80 dB, PAN's nearest-mode
goldens >= 70 dB (the JAX suite's bar, tests/test_model_parity_zoo.py:88),
PPON's fp16 checkpoint >= 55 dB.  Port against the JAX model on identical
weights (``params_from_jax``): fp32 max-abs <= 1e-5 of the output's peak;
bf16 the share of outputs equal to the JAX package's stated per test
(>= 95% for SRResNet and the ESRGAN variants; the instance-norm trunk is
held to the JAX package's own one-ulp noise floor, with each of its
blocks >= 99.8%), PSNR >= 55 dB for PAN and PPON.  Both packages' tails
run in phase space for parameter-free activations
(innfer_tpu/models/common.py:135-151, innfer_tpu_torch/models/common.py),
an exact rewrite that rounds bf16 at other points than the materialized
tail; the bf16 SRResNet comparisons turn it off in both, as the
predicates' docstrings say tests do.
"""
import json
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import innfer_tpu.models.common as JC
from innfer_tpu.checkpoint.detect import detect_and_infer as jax_detect
from innfer_tpu.checkpoint.remaps import swa_to_normal as jax_swa
from innfer_tpu.checkpoint.torch_pickle import load_checkpoint as jax_load
from innfer_tpu.config.defaults import get_network_config as jax_config
from innfer_tpu.loader import load_model_from_state as jax_load_from_state
from innfer_tpu.models.base import cast_params as jax_cast_params
from innfer_tpu.tiling import engine as JE
from innfer_tpu_torch.checkpoint.detect import detect_and_infer, load_checkpoint
from innfer_tpu_torch.checkpoint.remaps import swa_to_normal
from innfer_tpu_torch.config.defaults import get_network_config
from innfer_tpu_torch.loader import load_model, load_model_from_state
from innfer_tpu_torch.models import cast_params, get_network, params_from_jax
from innfer_tpu_torch.models import common as TC
from innfer_tpu_torch.models import rrdb as RR
from innfer_tpu_torch.ops import rdb as RDB
from innfer_tpu_torch.ops import resnet_block as RB
from innfer_tpu_torch.pipeline import InferenceSession
from innfer_tpu_torch.tiling import engine as TE
from tools import synth_params as SP

GOLDENS = os.path.join(os.path.dirname(__file__), "goldens")
SRRESNET = ["srresnet_x2", "srresnet_x3", "srresnet_x4", "srresnet_bn_x2",
            "srresnet_nac_bn_x2", "srresnet_cnac_bn_x2"]
ESRGAN_VARIANTS = ["esrgan_bn_x2", "esrgan_in_x2", "esrgan_nac_bn_x2", "esrgan_prelu_x2",
                   "esrgan_swish_x2"]
PAN = ["pan_x2", "pan_x4", "pan_bilinear_x4"]


def psnr(a, b):
    peak = max(1.0, float(np.abs(b).max()))
    mse = np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2)
    return np.inf if mse == 0 else 10 * np.log10(peak ** 2 / mse)


def _golden(name):
    fx = np.load(os.path.join(GOLDENS, f"{name}.npz"))
    return fx, json.loads(str(fx["meta"]))


def _nhwc(fx):
    return np.ascontiguousarray(np.transpose(fx["input"], (0, 2, 3, 1)))


def _run(model, params, x, index=None):
    with torch.no_grad():
        out = model.apply(params, torch.from_numpy(x))
    if index is None:
        index = model.output_index
    out = out if index is None else out[index]
    return out.float().permute(0, 3, 1, 2).numpy()


# ---------------------------------------------------------------------------
# Goldens
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,key,index,min_db", (
    [(n, "output", None, 80) for n in SRRESNET + ESRGAN_VARIANTS]
    + [("pan_x2", "output", None, 70), ("pan_x4", "output", None, 70),
       ("pan_bilinear_x4", "output", None, 80)]
    + [("ppon_x4", f"output_{i}", i, 55) for i in range(3)]))
def test_golden_through_load_model_from_state(name, key, index, min_db):
    fx, meta = _golden(name)
    state = load_checkpoint(os.path.join(GOLDENS, f"{name}.pth"))
    model, params = load_model_from_state(state, dict(meta["cfg"]), device="cpu")
    out = _run(model, params, _nhwc(fx), index)
    assert out.shape == fx[key].shape
    assert psnr(out, fx[key]) >= min_db


@pytest.mark.parametrize("name,kind,min_db", [
    ("srresnet_x2", "sr_resnet", 80), ("srresnet_x3", "sr_resnet", 80),
    ("srresnet_x4", "sr_resnet", 80), ("pan_x2", "pan_net", 70),
    ("pan_x4", "pan_net", 70), ("ppon_x4", "ppon", 55)])
def test_golden_autodetected_through_load_model(name, kind, min_db):
    fx, meta = _golden(name)
    # x3 shares the single-upsampler layout with x2: the scale comes from
    # the caller, as the CLI takes it from the '3x_' filename
    model, params = load_model(os.path.join(GOLDENS, f"{name}.pth"),
                               scale=meta.get("scale"), device="cpu")
    assert model.name == kind and model.scale == meta["scale"]
    key = "output_2" if kind == "ppon" else "output"
    assert psnr(_run(model, params, _nhwc(fx)), fx[key]) >= min_db


@pytest.mark.parametrize("name", SRRESNET + ESRGAN_VARIANTS + PAN + ["ppon_x4"])
def test_detection_equals_jax(name):
    """The same family, config and keys; where the JAX package's detection
    fails (esrgan_swish_x2: a 0-d ``model.6.beta`` is read as the top
    conv), the port's fails with the same error."""
    path = os.path.join(GOLDENS, f"{name}.pth")
    try:
        jfam, jcfg, jstate = jax_detect(jax_swa(jax_load(path)))
    except IndexError:
        with pytest.raises(IndexError):
            detect_and_infer(swa_to_normal(load_checkpoint(path)))
        return
    fam, cfg, state = detect_and_infer(swa_to_normal(load_checkpoint(path)))
    assert (fam, cfg) == (jfam, jcfg)
    assert sorted(state) == sorted(jstate)


@pytest.mark.parametrize("spec", [
    "sr_resnet", "srresnet", "srgan", "ppon", "pan", "pan_net",
    {"type": "srgan", "nb": 3, "norm_type": "batch", "mode": "NAC", "res_scale": 0.5,
     "outm": "clamp"},
    {"type": "pan", "ups_inter_mode": "bilinear", "double_scpa": True, "nf": 16},
    {"which_model_G": "ppon", "nb": 2, "alpha": 0.5, "net_act": "leakyrelu"},
])
def test_config_defaults_equal_jax(spec):
    for scale in (2, 4):
        assert get_network_config(spec, scale) == jax_config(spec, scale)


# ---------------------------------------------------------------------------
# Port against the JAX model on identical weights
# ---------------------------------------------------------------------------

def _pair(state, cfg):
    """The same model in both packages from one numpy state dict."""
    jm, jp = jax_load_from_state(state, cfg)
    tm = get_network(cfg)
    return jm, jp, tm, params_from_jax({k: np.asarray(v) for k, v in jp.items()}, tm)


def _golden_pair(name):
    fx, meta = _golden(name)
    return _pair(jax_load(os.path.join(GOLDENS, f"{name}.pth")), dict(meta["cfg"]))


def _synth_pair(family, **kw):
    spec = {"srresnet": "srgan", "pan": "pan", "ppon": "ppon"}[family]
    make = {"srresnet": SP.srresnet_state, "pan": SP.pan_state, "ppon": SP.ppon_state}[family]
    scale = kw.pop("scale", 4)
    cfg_kw = kw.pop("cfg", {})
    state = make(scale=scale, seed=7, **kw)
    return _pair(state, jax_config(dict({"type": spec}, **kw, **cfg_kw), scale))


def _x(h=20, w=24, seed=0):
    return np.random.default_rng(seed).random((1, h, w, 3), np.float32)


def _jax_out(jm, jp, x, dtype=None):
    if dtype is not None:
        jp, x = jax_cast_params(jp, dtype), jnp.asarray(x, dtype)
    out = jm.apply(jp, jnp.asarray(x))
    if jm.output_index is not None:
        return [np.asarray(o, np.float32) for o in out]
    return np.asarray(out, np.float32)


def _port_out(tm, tp, x, dtype=None):
    t = torch.from_numpy(x)
    if dtype is not None:
        tp, t = cast_params(tp, dtype), t.to(dtype)
    with torch.no_grad():
        out = tm.apply(tp, t)
    if tm.output_index is not None:
        return [o.float().numpy() for o in out]
    return out.float().numpy()


def _assert_fp32_close(out, ref):
    for o, r in zip(out if isinstance(out, list) else [out],
                    ref if isinstance(ref, list) else [ref]):
        assert o.shape == r.shape
        assert np.abs(o - r).max() <= 1e-5 * max(1.0, np.abs(r).max())


FP32_CASES = {
    "srresnet_x4": lambda: _synth_pair("srresnet", nb=2, nf=16),
    "srresnet_x3": lambda: _synth_pair("srresnet", nb=1, nf=16, scale=3),
    "srresnet_res_scale": lambda: _synth_pair("srresnet", nb=2, nf=16, cfg={"res_scale": 0.1}),
    "pan_x4": lambda: _synth_pair("pan", nb=2, nf=16, unf=8),
    "pan_x2_no_attention": lambda: _synth_pair("pan", nb=1, nf=16, unf=8, scale=2,
                                               self_attention=False),
    "pan_x3": lambda: _synth_pair("pan", nb=1, nf=16, unf=8, scale=3),
    "ppon_x4": lambda: _synth_pair("ppon", nb=1, nf=16),
    "ppon_x2_alpha": lambda: _synth_pair("ppon", nb=1, nf=16, scale=2, cfg={"alpha": 0.5}),
}
FP32_CASES.update({n: (lambda n=n: _golden_pair(n))
                   for n in SRRESNET[3:] + ESRGAN_VARIANTS + PAN})


@pytest.mark.parametrize("case", sorted(FP32_CASES))
def test_matches_jax_model_fp32(case):
    jm, jp, tm, tp = FP32_CASES[case]()
    x = _x(20, 28)
    _assert_fp32_close(_port_out(tm, tp, x), _jax_out(jm, jp, x))


def test_params_from_jax_carries_pan_dense_weights_across():
    """The JAX package stores PAN's Conv1d projections as dense (I, O); the
    port keeps the checkpoint's (O, I, 1)."""
    jm, jp, tm, tp = _synth_pair("pan", nb=1, nf=16, unf=8)
    assert tuple(jp["FSA.conv_f.weight"].shape) == (16, 2)
    assert tuple(tp["FSA.conv_f.weight"].shape) == (2, 16, 1)
    state = SP.pan_state(nb=1, nf=16, unf=8, scale=4, seed=7)
    np.testing.assert_array_equal(tp["FSA.conv_h.weight"].numpy(), state["FSA.conv_h.weight"])
    x = _x(24, 20, seed=3)
    _assert_fp32_close(_port_out(tm, tp, x), _jax_out(jm, jp, x))


def _equal_share(out, ref):
    return float(np.mean(np.asarray(out, np.float32) == np.asarray(ref, np.float32)))


@pytest.mark.parametrize("name,part,min_share", [
    ("srresnet_x2", "apply", 0.95), ("srresnet_bn_x2", "apply", 0.95),
    ("srresnet_nac_bn_x2", "apply", 0.95), ("srresnet_cnac_bn_x2", "apply", 0.95),
    ("esrgan_bn_x2", "apply_trunk", 0.95), ("esrgan_nac_bn_x2", "apply_trunk", 0.95),
    ("esrgan_prelu_x2", "apply_trunk", 0.95), ("esrgan_swish_x2", "apply_trunk", 0.95)])
def test_bf16_matches_jax_model(name, part, min_share, monkeypatch):
    """bf16 on the golden's weights: the share of outputs that are the JAX
    package's own bf16 values.  SRResNet runs whole, with both packages'
    materialized tail.  ESRGAN's upconv tail cannot be compared so: the JAX
    package always runs its upconv blocks LR-collapsed
    (innfer_tpu/models/common.py:108-115), so its trunk is compared.
    Measured: 100% for SRResNet and the batch-norm CNA trunk, 99.1% NAC,
    99.9% prelu and swish.  The instance-norm trunk is held by the three
    tests below."""
    monkeypatch.setattr(JC, "phase_tail_ok", lambda *a, **k: False)
    monkeypatch.setattr(TC, "phase_tail_ok", lambda *a, **k: False)
    jm, jp, tm, tp = _golden_pair(name)
    x = _x(16, 20, seed=4)
    jf, tf = getattr(jm, part), getattr(tm, part)
    ref = np.asarray(jf(jax_cast_params(jp, jnp.bfloat16), jnp.asarray(x, jnp.bfloat16)),
                     np.float32)
    with torch.no_grad():
        out = tf(cast_params(tp, torch.bfloat16), torch.from_numpy(x).bfloat16()).float().numpy()
    assert out.shape == ref.shape
    assert _equal_share(out, ref) >= min_share
    assert psnr(out, ref) >= 50


def _in_golden_bf16():
    jm, jp, tm, tp = _golden_pair("esrgan_in_x2")
    return jm, jax_cast_params(jp, jnp.bfloat16), tm, cast_params(tp, torch.bfloat16)


def _bf16_pair(seed):
    x = torch.from_numpy(_x(16, 20, seed=seed)).bfloat16()
    return x, jnp.asarray(x.float().numpy(), jnp.bfloat16)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_bf16_instance_norm_conv_blocks_match_jax(seed):
    """The first RDB of the instance-norm ESRGAN golden, block by block in
    bf16, each block fed the JAX package's own input: (a) the JAX conv's
    output fed to both packages' instance_norm, (b) the conv itself, (c) the
    whole CNA block (conv, IN, leakyrelu).  Measured over seeds 0-3, the
    least share of the five blocks: (a) 99.96% (not bit-equal: the fp32
    mean and variance are summed in another order, and lax.rsqrt and
    torch.rsqrt differ in the last fp32 bit), (b) 99.95%, (c) 99.86%.  So each rounding point of the IN
    path is the JAX package's."""
    from innfer_tpu.nn import functional as JF
    from innfer_tpu_torch.nn import functional as TF

    jm, jp, tm, tp = _in_golden_bf16()
    x, xj = _bf16_pair(seed)
    prefix = "model.1.sub.0.RDB1"
    srcs = [JF.conv2d(xj, jp["model.0.weight"], jp["model.0.bias"], padding=1)]
    for k in range(1, 6):
        inp = jnp.concatenate(srcs, axis=-1)
        tin = torch.from_numpy(np.asarray(inp, np.float32)).bfloat16()
        w, b = f"{prefix}.conv{k}.0.weight", f"{prefix}.conv{k}.0.bias"
        conv_j = JF.conv2d(inp, jp[w], jp[b], padding=1)
        conv_t = TF.conv2d(tin, tp[w], tp[b], padding=1)
        in_j = JF.instance_norm(conv_j)
        in_t = TF.instance_norm(torch.from_numpy(np.asarray(conv_j, np.float32)).bfloat16())
        act = "leakyrelu" if k < 5 else None
        block_j = JC.apply_conv_block(jp, inp, lambda j: f"{prefix}.conv{k}.{j}", mode="CNA",
                                      norm_type="instance", act_type=act)
        with torch.no_grad():
            block_t = TC.apply_conv_block(tp, tin, lambda j: f"{prefix}.conv{k}.{j}",
                                          mode="CNA", norm_type="instance", act_type=act)
        assert _equal_share(in_t.float().numpy(), in_j) >= 0.999
        assert _equal_share(conv_t.float().numpy(), conv_j) >= 0.999
        assert _equal_share(block_t.float().numpy(), block_j) >= 0.998
        srcs.append(block_j)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_bf16_instance_norm_trunk_is_at_the_jax_noise_floor(seed):
    """The whole instance-norm trunk in bf16 cannot meet the 95% share of
    the other variants, and the JAX package's own trunk shows why: moving
    ONE input value by one bf16 ulp changes 57-60% of its outputs (seeds
    0-2), because each of the 30 instance norms rescales its channel by the
    inverse of its std, so one flipped rounding shifts the statistics and
    with them every value of the channel downstream.  The port's trunk
    starts from the blocks' rare conv-order flips (test above) and lands at
    that same floor: 42.7-45.3% equal to the JAX package's, 53.8-54.4 dB.  The bar is
    the JAX package's own share less 5 points."""
    jm, jp, tm, tp = _in_golden_bf16()
    x, xj = _bf16_pair(seed)
    ref = np.asarray(jm.apply_trunk(jp, xj), np.float32)
    moved = np.asarray(xj, np.float32)
    moved[0, 8, 10, 1] = float(jnp.nextafter(xj[0, 8, 10, 1], jnp.asarray(2, jnp.bfloat16)))
    floor = _equal_share(np.asarray(jm.apply_trunk(jp, jnp.asarray(moved, jnp.bfloat16)),
                                    np.float32), ref)
    with torch.no_grad():
        out = tm.apply_trunk(tp, x).float().numpy()
    assert floor < 0.5
    assert _equal_share(out, ref) >= floor - 0.05
    assert psnr(out, ref) >= 50


@pytest.mark.parametrize("case", ["pan_x4", "pan_bilinear_x4", "ppon_x4"])
def test_bf16_pan_and_ppon_match_jax_model(case):
    if case == "ppon_x4":
        jm, jp, tm, tp = _synth_pair("ppon", nb=1, nf=32)
    else:
        jm, jp, tm, tp = _golden_pair(case)
    x = _x(24, 20, seed=5)
    ref = _jax_out(jm, jp, x, jnp.bfloat16)
    out = _port_out(tm, tp, x, torch.bfloat16)
    for o, r in zip(out if isinstance(out, list) else [out],
                    ref if isinstance(ref, list) else [ref]):
        assert o.shape == r.shape
        assert psnr(o, r) >= 55


def test_bf16_fsa_attention_rounds_like_the_jax_package():
    """PAN's FSA block alone in bf16: the scores stay fp32 into the softmax
    and both products accumulate in fp32, as the JAX package's einsums
    (innfer_tpu/models/pan.py:63-67).  Measured: 100% of outputs are the
    JAX package's bf16 values; rounding the scores to bf16 (a bf16
    torch.matmul) gives 98.9%."""
    from innfer_tpu.models import pan as JPAN
    from innfer_tpu_torch.models import pan as TPAN

    _jm, jp, _tm, tp = _synth_pair("pan", nb=1, nf=32, unf=8)
    x = np.random.default_rng(3).standard_normal((2, 48, 40, 32)).astype(np.float32)
    ref = np.asarray(JPAN._fsa(jax_cast_params(jp, jnp.bfloat16), jnp.asarray(x, jnp.bfloat16),
                               "FSA"), np.float32)
    with torch.no_grad():
        out = TPAN._fsa(cast_params(tp, torch.bfloat16), torch.from_numpy(x).bfloat16(), "FSA")
    assert out.dtype == torch.bfloat16
    assert _equal_share(out.float().numpy(), ref) >= 0.999


# ---------------------------------------------------------------------------
# Tiling of the zoo
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode,tile", [("uniform", 16), ("auto", 256)])
def test_ppon_runner_matches_jax_runner(mode, tile):
    """PPON's third output through both packages' TiledRunner."""
    jm, jp, tm, tp = _synth_pair("ppon", nb=1, nf=16, scale=2)
    x = _x(30, 36, seed=7)
    kw = dict(mode=mode, tile=tile, overlap=8, tile_batch=4, output_index=2)
    ref = np.asarray(JE.TiledRunner(jm.apply, 2, **kw)(jp, jnp.asarray(x)))
    with torch.no_grad():
        out = TE.TiledRunner(tm.apply, 2, **kw)(tp, torch.from_numpy(x)).numpy()
    assert out.shape == ref.shape == (1, 60, 72, 3)
    assert np.abs(out - ref).max() <= 1e-5


def test_srresnet_hybrid_runner_matches_jax_runner():
    jm, jp, tm, tp = _synth_pair("srresnet", nb=1, nf=16)
    x = _x(40, 52, seed=8)
    kw = dict(mode="hybrid", tile=(32, 32), overlap=8, tile_batch=4, tail_halo=tm.tail_halo)
    ref = np.asarray(JE.TiledRunner(jm.apply, 4, trunk_fn=jm.apply_trunk,
                                    tail_fn=jm.apply_tail, **kw)(jp, jnp.asarray(x)))
    runner = TE.TiledRunner(tm.apply, 4, trunk_fn=tm.apply_trunk, tail_fn=tm.apply_tail, **kw)
    with torch.no_grad():
        out = runner(tp, torch.from_numpy(x)).numpy()
    assert out.shape == ref.shape == (1, 160, 208, 3)
    assert np.abs(out - ref).max() <= 1e-5


# ---------------------------------------------------------------------------
# The kernel gates (ops/rdb.fusable, ops/resnet_block.fusable) see the
# norm layers; auto -> hybrid only where the trunk runs a port kernel
# ---------------------------------------------------------------------------

class _CudaLooking(torch.Tensor):
    """A CPU tensor that answers ``is_cuda`` True, to reach the gates that
    decide on the card."""

    @property
    def is_cuda(self):
        return True


def _esrgan_variant(norm=None, act="leakyrelu"):
    cfg = jax_config({"type": "esrgan", "nb": 1, "nf": 16, "gc": 8, "norm_type": norm,
                      "act_type": act}, 2)
    return get_network(cfg)


def _rdb_weights(nf=16, gc=8, bias=True, dim=4):
    ws = [torch.zeros(gc if c < 5 else nf, nf + (c - 1) * gc, *(3,) * (dim - 2))
          for c in range(1, 6)]
    return ws, [torch.zeros(w.shape[0]) if bias else None for w in ws]


@pytest.mark.parametrize("case,takes", [
    ({}, True), ({"act": "lrelu", "dtype": torch.bfloat16}, True),
    ({"act": "prelu"}, False), ({"act": "swish"}, False), ({"norm": "batch"}, False),
    ({"norm": "instance"}, False), ({"bias": False}, False), ({"cuda": False}, False),
    ({"dim": 5}, False)])
def test_rdb_fusable_takes_only_the_kernels_configuration(case, takes):
    """rdb.fusable holds for the kernel's configuration alone: a CUDA tensor
    of fp32 or bf16, biased convs, LeakyReLU, no norm; a 5-D Conv3D clip
    (evsrgan) keeps the plain path."""
    c = {"dtype": torch.float32, "act": "leakyrelu", "norm": None, "bias": True, "dim": 4,
         "cuda": True, **case}
    ws, bs = _rdb_weights(bias=c["bias"], dim=c["dim"])
    x = torch.zeros(1, *(8,) * (c["dim"] - 2), 16, dtype=c["dtype"])
    if c["cuda"]:
        x = x.as_subclass(_CudaLooking)
    assert RDB.fusable(x, ws, bs, act_type=c["act"], norm_type=c["norm"]) is takes


@pytest.mark.parametrize("case,takes", [
    ({}, True), ({"dtype": torch.bfloat16}, True), ({"norm": "batch"}, False),
    ({"pad": "zero"}, False), ({"pad": "replicate"}, False), ({"cuda": False}, False),
    ({"c": 48}, False)])
def test_resnet_block_fusable_takes_only_the_kernels_configuration(case, takes):
    """resnet_block.fusable holds for the kernel's configuration alone:
    instance norm, reflect padding, a CUDA tensor, fp32 or bf16, channels a
    multiple of 32."""
    c = {"dtype": torch.float32, "norm": "instance", "pad": "reflect", "cuda": True, "c": 32,
         **case}
    x = torch.zeros(1, 8, 8, c["c"], dtype=c["dtype"])
    if c["cuda"]:
        x = x.as_subclass(_CudaLooking)
    w = torch.zeros(c["c"], c["c"], 3, 3)
    assert RB.fusable(x, w, w, norm_type=c["norm"], pad_type=c["pad"]) is takes


@pytest.mark.parametrize("norm,act,kernel_calls", [
    (None, "leakyrelu", 3), ("batch", "leakyrelu", 0), ("instance", "leakyrelu", 0),
    (None, "prelu", 0)])
def test_auto_gate_on_the_card_passes_the_norm(norm, act, kernel_calls, monkeypatch):
    """On a CUDA tensor the model reaches the fused RDB only for the
    kernel's configuration; the gate used to take norm_type as None."""
    calls = []

    def spy(params, x, prefix, *, plus):
        calls.append(prefix)
        return RR._rdb5c(params, x, prefix, act_type="leakyrelu", plus=plus)

    monkeypatch.setattr(RR, "_rdb5c_kernel", spy)
    model = _esrgan_variant(norm, act)
    name = {None: "esrgan_x2", "batch": "esrgan_bn_x2", "instance": "esrgan_in_x2"}[norm]
    if act == "prelu":
        name = "esrgan_prelu_x2"
    fx, meta = _golden(name)
    cfg = dict(meta["cfg"], nb=2) if norm or act != "leakyrelu" else None
    model = get_network(cfg) if cfg else load_model(os.path.join(GOLDENS, f"{name}.pth"),
                                                    device="cpu")[0]
    params = load_model_from_state(load_checkpoint(os.path.join(GOLDENS, f"{name}.pth")),
                                   model.cfg, device="cpu")[1]
    x = torch.from_numpy(_nhwc(fx)).as_subclass(_CudaLooking)
    with torch.no_grad():
        model.apply_trunk(params, x)
    assert len(calls) == kernel_calls * model.cfg["nb"]
    assert model.trunk_kernel == (kernel_calls > 0)


@pytest.mark.parametrize("norm,act,chain", [
    (None, "leakyrelu", True), ("batch", "leakyrelu", False),
    ("instance", "leakyrelu", False), (None, "swish", False)])
def test_chain_gate_refuses_what_the_kernel_does_not_cover(norm, act, chain, monkeypatch):
    monkeypatch.setenv("INNFER_RDB_CHAIN", "1")
    ws, bs = _rdb_weights()
    params = {f"model.1.sub.0.RDB1.conv{c}.0.{k}": t for c, w, b in zip(range(1, 6), ws, bs)
              for k, t in (("weight", w), ("bias", b))}
    x = torch.zeros(1, 8, 8, 16).as_subclass(_CudaLooking)
    assert RR._use_chain(params, x, nr=3, act_type=act, norm_type=norm) is chain


def _session_mode(tmp_path, name, state):
    path = str(tmp_path / f"4x_{name}.pth")
    torch.save({k: torch.as_tensor(v) for k, v in state.items()}, path)
    sess = InferenceSession(path, compute_dtype=torch.float32, tile_mode="auto", device="cpu")
    return sess.stages[0].runner.mode_for(1080, 1920, on_cuda=True)


def test_session_auto_goes_hybrid_only_where_the_trunk_runs_a_kernel(tmp_path):
    assert _session_mode(tmp_path, "srresnet", SP.srresnet_state(nb=1, nf=16, seed=1)) == "auto"
    assert _session_mode(tmp_path, "esrgan", SP.esrgan_state(nb=1, nf=16, gc=8, seed=1)) == "hybrid"
    assert _session_mode(tmp_path, "ppon", SP.ppon_state(nb=1, nf=16, seed=1)) == "auto"


@pytest.mark.parametrize("norm,act,mode", [
    (None, "leakyrelu", "hybrid"), ("instance", "leakyrelu", "auto"),
    ("batch", "leakyrelu", "auto"), (None, "prelu", "auto")])
def test_runner_mode_for_esrgan_variants(norm, act, mode):
    model = _esrgan_variant(norm, act)
    runner = TE.TiledRunner(model.apply, model.scale, mode="auto", trunk_fn=model.apply_trunk,
                            tail_fn=model.apply_tail, tail_halo=model.tail_halo,
                            trunk_kernel=model.trunk_kernel)
    assert runner.mode_for(1080, 1920, on_cuda=True) == mode
    assert runner.mode_for(1080, 1920, on_cuda=False) == "auto"


def test_session_applies_output_index_on_whole_image_forwards(tmp_path):
    """PPON through the session as a whole-image forward: the Stage gives
    output 2 (the tiled path's output_index is held by the runner tests)."""
    from innfer_tpu_torch.pipeline import _postprocess_u8, np2tensor

    state = SP.ppon_state(nb=1, nf=16, scale=2, seed=3)
    path = str(tmp_path / "2x_ppon.pth")
    torch.save({k: torch.from_numpy(v) for k, v in state.items()}, path)
    img = np.random.default_rng(9).integers(0, 256, (20, 24, 3), dtype=np.uint8)
    sess = InferenceSession(path, compute_dtype=torch.float32, device="cpu")
    sess.stages[0].chop = False
    assert sess.stages[0].model.output_index == 2
    out = sess.run_image(img)
    with torch.no_grad():
        ref = sess.stages[0].model.apply(sess.stages[0].params, np2tensor(img))[2]
    np.testing.assert_array_equal(out, _postprocess_u8(ref).numpy())


@pytest.mark.parametrize("family", ["ppon", "pan", "srresnet"])
def test_session_matches_jax_session(family, tmp_path):
    """The same checkpoint and PNGs through both packages' sessions in fp32
    (uniform tiles): u8 outputs within one rounding step."""
    import cv2

    from innfer_tpu.pipeline import InferenceSession as JaxSession

    make = {"ppon": SP.ppon_state, "pan": SP.pan_state, "srresnet": SP.srresnet_state}[family]
    kw = {"ppon": dict(nb=1, nf=16), "pan": dict(nb=1, nf=16, unf=8),
          "srresnet": dict(nb=1, nf=16)}[family]
    path = str(tmp_path / f"2x_{family}.pth")
    torch.save({k: torch.from_numpy(v) for k, v in make(scale=2, seed=4, **kw).items()}, path)
    in_dir = tmp_path / "in"
    in_dir.mkdir()
    cv2.imwrite(str(in_dir / "a.png"),
                np.random.default_rng(5).integers(0, 256, (36, 44, 3), dtype=np.uint8))
    opts = dict(tile=24, overlap=8, tile_batch=4, tile_mode="uniform")
    JaxSession(path, compute_dtype=jnp.float32, **opts).process(
        str(in_dir), str(tmp_path / "jax"), verbose=False)
    InferenceSession(path, compute_dtype=torch.float32, device="cpu", **opts).process(
        str(in_dir), str(tmp_path / "port"), verbose=False)
    a = cv2.imread(str(tmp_path / "jax" / "a.png"))
    b = cv2.imread(str(tmp_path / "port" / "a.png"))
    assert a.shape == b.shape == (72, 88, 3)
    assert np.abs(a.astype(int) - b.astype(int)).max() <= 1
