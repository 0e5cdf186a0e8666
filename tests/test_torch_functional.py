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
    """A small 4x ESRGAN (nb=1, nf=32, gc=16) in bf16, backend='torch',
    with the JAX package's weights through params_from_jax and biases that
    are NOT bf16-representable.  The trunk rounds at the JAX package's
    points now: 100% of its outputs are identical (94.0% when the bias was
    rounded to bf16).  The whole model (apply) agrees in 25% of its
    outputs only, before and after the repair: the JAX package's tail runs
    its last upsample block and the HR convs in phase space
    (innfer_tpu/models/rrdb.py:305-315), an exact rewrite in real
    arithmetic that rounds bf16 at other points; every output is within
    2^-6 of max(|ref|, 1) (measured: 2^-12)."""
    spec = {"type": "esrgan", "nb": 1, "nf": 32, "gc": 16}
    state = SP.esrgan_state(nb=1, nf=32, gc=16, scale=4, seed=5)
    jm, jp = jax_load_from_state(state, jax_config(spec, 4))
    tm = get_network(jax_config(dict(spec, backend="torch"), 4))
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
    if part == "trunk":
        assert _same_share(out, ref) >= 0.999
    assert (np.abs(out - ref) <= 2.0 ** -6 * np.maximum(np.abs(ref), 1)).all()
