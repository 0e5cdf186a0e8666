"""The port's bf16 convolutions (innfer_tpu_torch/nn/functional.py) against
the JAX package's (innfer_tpu/nn/functional.py), on the CPU.

The JAX package adds an fp32 bias to the fp32 accumulator and rounds once
to bf16; a bf16 cuDNN/ATen conv rounds the bias to bf16 first and changed
about 15% of the outputs of a 3x3 conv with a bias of std 0.5.  Bars:
a single bf16 conv gives the JAX package's bf16 value in >= 99.9% of
outputs (what remains is the two frameworks' summation order flipping a
rounding, each flip one bf16 ulp); a small bf16 ESRGAN run end to end in
both packages agrees in the share of outputs stated at its test.  fp32
stays true fp32 (atol 1e-5 on one conv).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from innfer_tpu.config.defaults import get_network_config as jax_config
from innfer_tpu.loader import load_model_from_state as jax_load_from_state
from innfer_tpu.models.base import cast_params as jax_cast_params
from innfer_tpu.nn import functional as JF
from innfer_tpu_torch.models import cast_params, get_network, params_from_jax
from innfer_tpu_torch.nn import functional as F
from tools import synth_params as SP


def _conv_case(seed, cin, cout, k, hw=24, bias_std=0.5):
    """x (1, hw, hw, cin), w (cout, cin, k, k), b (cout,) as seeded numpy."""
    g = np.random.default_rng(seed)
    x = g.standard_normal((1, hw, hw, cin)).astype(np.float32)
    w = (g.standard_normal((cout, cin, k, k)) / np.sqrt(cin * k * k)).astype(np.float32)
    b = (g.standard_normal(cout) * bias_std).astype(np.float32)
    return x, w, b


def _same_share(a: np.ndarray, b: np.ndarray) -> float:
    return float(np.mean(np.asarray(a, np.float32) == np.asarray(b, np.float32)))


@pytest.mark.parametrize("cin,cout,k,pad", [(64, 64, 3, 1), (64, 3, 3, 1), (3, 64, 3, 1),
                                            (32, 48, 1, 0)])
def test_bf16_conv2d_adds_the_bias_in_fp32_as_jax(cin, cout, k, pad):
    x, w, b = _conv_case(0, cin, cout, k)
    ref = JF.conv2d(jnp.asarray(x, jnp.bfloat16), jnp.asarray(w.transpose(2, 3, 1, 0)),
                    jnp.asarray(b), padding=pad)
    out = F.conv2d(torch.from_numpy(x).bfloat16(), torch.from_numpy(w), torch.from_numpy(b),
                   padding=pad)
    assert out.dtype == torch.bfloat16 and out.is_contiguous()
    assert _same_share(out.float().numpy(), np.asarray(ref, np.float32)) >= 0.999


@pytest.mark.parametrize("stride,padding,output_padding", [(2, 1, 1), (1, 1, 0)])
def test_bf16_conv_transpose2d_adds_the_bias_in_fp32_as_jax(stride, padding, output_padding):
    x, _, b = _conv_case(1, 32, 16, 3, hw=12)
    w = (np.random.default_rng(2).standard_normal((32, 16, 3, 3)) / 17).astype(np.float32)
    w_jax = np.ascontiguousarray(w[:, :, ::-1, ::-1].transpose(2, 3, 0, 1))  # flipped HWIO
    ref = JF.conv_transpose2d(jnp.asarray(x, jnp.bfloat16), jnp.asarray(w_jax),
                              jnp.asarray(b), stride=stride, padding=padding,
                              output_padding=output_padding)
    out = F.conv_transpose2d(torch.from_numpy(x).bfloat16(), torch.from_numpy(w),
                             torch.from_numpy(b), stride=stride, padding=padding,
                             output_padding=output_padding)
    assert out.shape == ref.shape and out.dtype == torch.bfloat16
    assert _same_share(out.float().numpy(), np.asarray(ref, np.float32)) >= 0.999


def test_fp32_conv2d_stays_true_fp32():
    x, w, b = _conv_case(3, 16, 16, 3)
    ref = JF.conv2d(jnp.asarray(x), jnp.asarray(w.transpose(2, 3, 1, 0)), jnp.asarray(b),
                    padding=1)
    out = F.conv2d(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b), padding=1)
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5, rtol=0)


def test_bias_free_bf16_conv_matches_jax():
    x, w, _ = _conv_case(4, 32, 32, 3)
    ref = JF.conv2d(jnp.asarray(x, jnp.bfloat16), jnp.asarray(w.transpose(2, 3, 1, 0)),
                    padding=1)
    out = F.conv2d(torch.from_numpy(x).bfloat16(), torch.from_numpy(w), None, padding=1)
    assert _same_share(out.float().numpy(), np.asarray(ref, np.float32)) >= 0.999


@pytest.mark.parametrize("part", ["trunk", "apply"])
def test_bf16_esrgan_torch_backend_matches_jax_model(part):
    """A small 4x ESRGAN (nb=1, nf=32, gc=16) in bf16 on the plain path,
    with the JAX package's weights through params_from_jax and biases that
    are NOT bf16-representable.  The trunk rounds at the JAX package's
    points now: 100% of its outputs are identical (94.0% when the bias was
    rounded to bf16).  The whole model (apply) agrees in 99.9% of its
    outputs: the port's tail takes the JAX package's form, collapsed
    upconv blocks and the phase-space tail (innfer_tpu/models/rrdb.py:
    305-315), and rounds bf16 at its points (25% when the port ran the
    plain tail); every output is within 2^-6 of max(|ref|, 1) (measured:
    2^-14)."""
    spec = {"type": "esrgan", "nb": 1, "nf": 32, "gc": 16}
    state = SP.esrgan_state(nb=1, nf=32, gc=16, scale=4, seed=5)
    jm, jp = jax_load_from_state(state, jax_config(spec, 4))
    tm = get_network(jax_config(spec, 4))
    tp = params_from_jax({k: np.asarray(v) for k, v in jp.items()})
    x = np.random.default_rng(1).random((1, 16, 20, 3), np.float32)
    fn_j = jm.apply_trunk if part == "trunk" else jm.apply
    fn_t = tm.apply_trunk if part == "trunk" else tm.apply
    ref = np.asarray(fn_j(jax_cast_params(jp, jnp.bfloat16), jnp.asarray(x, jnp.bfloat16)),
                     np.float32)
    with torch.no_grad():
        out = fn_t(cast_params(tp, torch.bfloat16),
                   torch.from_numpy(x).to(torch.bfloat16)).float().numpy()
    assert out.shape == ref.shape
    assert _same_share(out, ref) >= (0.999 if part == "trunk" else 0.99)
    assert (np.abs(out - ref) <= 2.0 ** -6 * np.maximum(np.abs(ref), 1)).all()


# ---------------------------------------------------------------------------
# The SR zoo's ops against innfer_tpu.nn (fp32 atol 1e-5 unless stated;
# bf16 the JAX package's own values in the share stated)
# ---------------------------------------------------------------------------

from innfer_tpu.nn import resize as JR  # noqa: E402
from innfer_tpu_torch.nn import resize as R  # noqa: E402


@pytest.mark.parametrize("mode,align", [("nearest", None), ("bilinear", True),
                                        ("bilinear", False), ("bicubic", False),
                                        ("bicubic", True)])
@pytest.mark.parametrize("size", [(34, 46), (7, 11), (13, 9)])
def test_interpolate_matches_jax(mode, align, size):
    """Up and down, odd sizes, both align_corners: the same tables and the
    same fp32 blend order give the JAX package's fp32 values."""
    x = np.random.default_rng(10).random((2, 11, 17, 3), np.float32)
    ref = JR.interpolate(jnp.asarray(x), size=size, mode=mode, align_corners=align)
    out = R.interpolate(torch.from_numpy(x), size=size, mode=mode, align_corners=align)
    assert out.shape == ref.shape and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-6, rtol=0)


@pytest.mark.parametrize("mode,align", [("bilinear", True), ("bicubic", False)])
def test_interpolate_bf16_and_scale_factor_match_jax(mode, align):
    x = np.random.default_rng(11).random((1, 9, 12, 4), np.float32)
    ref = JR.interpolate(jnp.asarray(x, jnp.bfloat16), scale_factor=4.0, mode=mode,
                         align_corners=align)
    out = R.interpolate(torch.from_numpy(x).bfloat16(), scale_factor=4.0, mode=mode,
                        align_corners=align)
    assert out.shape == ref.shape == (1, 36, 48, 4) and out.dtype == torch.bfloat16
    assert _same_share(out.float().numpy(), np.asarray(ref, np.float32)) >= 0.999


@pytest.mark.parametrize("mode,align", [("bilinear", True), ("bilinear", False),
                                        ("bicubic", False)])
def test_interpolate_matches_torch(mode, align):
    """And torch's own F.interpolate (the reference's op) on NCHW."""
    x = np.random.default_rng(12).random((1, 3, 10, 14), np.float32)
    ref = torch.nn.functional.interpolate(torch.from_numpy(x), size=(23, 31), mode=mode,
                                          align_corners=align)
    out = R.interpolate(torch.from_numpy(x).permute(0, 2, 3, 1), size=(23, 31), mode=mode,
                        align_corners=align)
    np.testing.assert_allclose(out.permute(0, 3, 1, 2).numpy(), ref.numpy(), atol=1e-5, rtol=0)


@pytest.mark.parametrize("dtype", [np.float32, "bf16"])
@pytest.mark.parametrize("k,s", [(4, None), (2, 1), (3, 2)])
def test_max_pool2d_matches_jax(dtype, k, s):
    x = np.random.default_rng(13).standard_normal((2, 13, 18, 5)).astype(np.float32)
    jd, td = (jnp.bfloat16, torch.bfloat16) if dtype == "bf16" else (jnp.float32, torch.float32)
    ref = np.asarray(JF.max_pool2d(jnp.asarray(x, jd), k, s), np.float32)
    out = F.max_pool2d(torch.from_numpy(x).to(td), k, s).float().numpy()
    np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("dtype", [np.float32, "bf16"])
def test_softmax_runs_in_fp32_as_jax(dtype):
    x = np.random.default_rng(14).standard_normal((2, 7, 33)).astype(np.float32) * 4
    jd, td = (jnp.bfloat16, torch.bfloat16) if dtype == "bf16" else (jnp.float32, torch.float32)
    ref = np.asarray(JF.softmax(jnp.asarray(x, jd), axis=-1), np.float32)
    out = F.softmax(torch.from_numpy(x).to(td), dim=-1)
    assert out.dtype == td
    if dtype == "bf16":
        assert _same_share(out.float().numpy(), ref) >= 0.999
    else:
        np.testing.assert_allclose(out.numpy(), ref, atol=1e-6, rtol=0)


@pytest.mark.parametrize("bias", [True, False])
def test_dense_takes_the_conv1d_layout_and_adds_the_bias_in_fp32(bias):
    """Conv1d weights stay (O, I, 1); the JAX package's dense takes (I, O).
    bf16: the fp32 bias joins the fp32 accumulator, one rounding."""
    g = np.random.default_rng(15)
    x = g.standard_normal((2, 50, 40)).astype(np.float32)
    w = (g.standard_normal((24, 40, 1)) / 6).astype(np.float32)
    b = (g.standard_normal(24) * 0.5).astype(np.float32) if bias else None
    jb = None if b is None else jnp.asarray(b)
    tb = None if b is None else torch.from_numpy(b)
    ref = JF.dense(jnp.asarray(x), jnp.asarray(w[:, :, 0].T), jb)
    np.testing.assert_allclose(F.dense(torch.from_numpy(x), torch.from_numpy(w), tb).numpy(),
                               np.asarray(ref), atol=1e-5, rtol=0)
    ref = JF.dense(jnp.asarray(x, jnp.bfloat16), jnp.asarray(w[:, :, 0].T), jb)
    out = F.dense(torch.from_numpy(x).bfloat16(), torch.from_numpy(w), tb)
    assert out.dtype == torch.bfloat16
    assert _same_share(out.float().numpy(), np.asarray(ref, np.float32)) >= 0.999


def test_bf16_matmul_keeps_fp32_scores_as_the_jax_einsum():
    """PAN's attention: scores of two bf16 operands stay fp32
    (preferred_element_type=float32); a bf16 torch.matmul rounds them."""
    g = np.random.default_rng(16)
    f = g.standard_normal((2, 64, 5)).astype(np.float32)
    h = g.standard_normal((2, 80, 5)).astype(np.float32)
    ref = np.asarray(jnp.einsum("bnc,bmc->bnm", jnp.asarray(f, jnp.bfloat16),
                                jnp.asarray(h, jnp.bfloat16),
                                preferred_element_type=jnp.float32))
    fb, hb = torch.from_numpy(f).bfloat16(), torch.from_numpy(h).bfloat16()
    out = F.matmul(fb, hb.transpose(1, 2), out_dtype=torch.float32)
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5, rtol=0)
    assert _same_share(torch.matmul(fb, hb.transpose(1, 2)).float().numpy(), ref) < 0.5


@pytest.mark.parametrize("dilation", [1, 3, 8])
def test_dilated_conv2d_matches_jax(dilation):
    x, w, b = _conv_case(17, 16, 8, 3, hw=30)
    ref = JF.conv2d(jnp.asarray(x), jnp.asarray(w.transpose(2, 3, 1, 0)), jnp.asarray(b),
                    padding=dilation, dilation=dilation)
    out = F.conv2d(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b),
                   padding=dilation, dilation=dilation)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5, rtol=0)
    ref = JF.conv2d(jnp.asarray(x, jnp.bfloat16), jnp.asarray(w.transpose(2, 3, 1, 0)),
                    jnp.asarray(b), padding=dilation, dilation=dilation)
    out = F.conv2d(torch.from_numpy(x).bfloat16(), torch.from_numpy(w), torch.from_numpy(b),
                   padding=dilation, dilation=dilation)
    assert _same_share(out.float().numpy(), np.asarray(ref, np.float32)) >= 0.999


@pytest.mark.parametrize("n_weights", [1, 12])
def test_bf16_prelu_multiplies_in_the_activation_dtype_as_jax(n_weights):
    """The port keeps the PReLU weight fp32; it multiplies as bf16, as the
    JAX package's ``weight.astype(x.dtype)``.  An fp32 weight would round
    x * w once from fp32 and differ in about a third of the negative
    outputs."""
    g = np.random.default_rng(18)
    x = g.standard_normal((1, 9, 10, 12)).astype(np.float32)
    w = g.uniform(0.05, 0.5, n_weights).astype(np.float32)
    ref = np.asarray(JF.prelu(jnp.asarray(x, jnp.bfloat16), jnp.asarray(w)), np.float32)
    out = F.prelu(torch.from_numpy(x).bfloat16(), torch.from_numpy(w))
    assert out.dtype == torch.bfloat16
    np.testing.assert_array_equal(out.float().numpy(), ref)


@pytest.mark.parametrize("inplace", [True, False])
def test_bf16_swish_matches_jax(inplace):
    """slope, beta and the products in bf16; in place is slope * x * x (the
    reference's swish_func bug, golden esrgan_swish_x2).  Out of place, the
    sigmoid differs on purpose: the JAX package's bf16 ``jax.nn.sigmoid``
    lowers to exp, add and divide, each rounded to bf16 (30% of values
    differ from one rounding), where torch.sigmoid rounds once from fp32,
    as the reference's own PyTorch op does; so the reference here is the
    JAX formula with its sigmoid rounded once."""
    g = np.random.default_rng(19)
    x = g.standard_normal((1, 9, 10, 8)).astype(np.float32)
    beta = np.asarray(1.3, np.float32)
    xb = jnp.asarray(x, jnp.bfloat16)
    if inplace:
        ref = JF.swish(xb, jnp.asarray(beta), inplace=True)
    else:
        bx = jnp.asarray(beta, jnp.bfloat16) * xb
        sig = JF.sigmoid(bx.astype(jnp.float32)).astype(jnp.bfloat16)
        ref = jnp.asarray(1.67653251702, jnp.bfloat16) * xb * sig
    out = F.swish(torch.from_numpy(x).bfloat16(), torch.from_numpy(beta), inplace=inplace)
    np.testing.assert_array_equal(out.float().numpy(), np.asarray(ref, np.float32))
    out32 = F.swish(torch.from_numpy(x), torch.from_numpy(beta), inplace=inplace).numpy()
    ref32 = np.asarray(JF.swish(jnp.asarray(x), jnp.asarray(beta), inplace=inplace))
    np.testing.assert_allclose(out32, ref32, atol=1e-6, rtol=0)


def test_act_reads_parameters_by_key():
    x = torch.linspace(-2, 2, 16).reshape(1, 2, 2, 4)
    params = {"m.1.weight": torch.tensor([0.25]), "m.2.beta": torch.tensor(1.0)}
    np.testing.assert_allclose(F.act("prelu", x, params=params, key="m.1").numpy(),
                               torch.nn.functional.prelu(x, torch.tensor([0.25])).numpy())
    assert torch.equal(F.act("swish", x, params=params, key="m.2", inplace=False),
                       F.swish(x, params["m.2.beta"]))
    with pytest.raises(NotImplementedError, match="plumbing"):
        F.act("prelu", x)


def test_bf16_ppon_residual_block_rounds_like_the_jax_package():
    """PPON's cascading sums and its two 0.2 scales in bf16 (innfer_tpu/
    models/ppon.py:44,51): the JAX package's values in >= 99% of outputs;
    the rest come from conv summation order, at most one bf16 ulp of
    max(|ref|, 1) each."""
    from innfer_tpu.models import ppon as JP
    from innfer_tpu_torch.models import ppon as TPN

    state = SP.ppon_state(nb=1, nf=32, scale=2, seed=6)
    jm, jp = jax_load_from_state(state, jax_config({"type": "ppon", "nb": 1, "nf": 32}, 2))
    tp = params_from_jax({k: np.asarray(v) for k, v in jp.items()})
    x = np.random.default_rng(20).standard_normal((1, 12, 14, 32)).astype(np.float32)
    ref = np.asarray(JP._rr_block(jax_cast_params(jp, jnp.bfloat16),
                                  jnp.asarray(x, jnp.bfloat16), "CFEM.1.sub.0"), np.float32)
    out = TPN._rr_block(cast_params(tp, torch.bfloat16), torch.from_numpy(x).bfloat16(),
                        "CFEM.1.sub.0").float().numpy()
    assert _same_share(out, ref) >= 0.99
    assert (np.abs(out - ref) <= 2.0 ** -7 * np.maximum(np.abs(ref), 1)).all()


def test_pad2d_takes_a_ltrb_tuple_as_jax():
    x = np.random.default_rng(21).random((1, 5, 6, 2), np.float32)
    for mode in ("zero", "reflect", "replicate"):
        ref = JF.pad2d(jnp.asarray(x), (1, 2, 0, 3), mode=mode)
        out = F.pad2d(torch.from_numpy(x), (1, 2, 0, 3), mode=mode)
        np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
