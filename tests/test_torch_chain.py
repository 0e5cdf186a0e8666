"""The port's RRDB trunk chain (ops/rdb.py fused_rdb_padded /
fused_rrdb_trunk, models/rrdb.py INNFER_RDB_CHAIN) against the JAX package
on the CPU.

Inputs and weights are seeded numpy arrays handed to both packages.
Tolerances: fp32 atol 2e-5, the JAX suite's own bar for its trunk
(tests/test_pallas_rdb.py:171; true fp32 on both sides, summation order
differs over nb*nr*5 convs); the workspace loop against the plain trunk
is exact (the same plain arithmetic in the same order).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from innfer_tpu.config.defaults import get_network_config as jax_config
from innfer_tpu.loader import load_model_from_state as jax_load_from_state
from innfer_tpu.ops.pallas.rdb import fused_rrdb_trunk as jax_trunk
from innfer_tpu_torch.models import get_network, params_from_jax
from innfer_tpu_torch.ops import rdb as RDB
from innfer_tpu_torch.ops.rdb import (fused_rdb_padded, fused_rrdb_trunk,
                                      rrdb_trunk_reference)
from tools import synth_params as SP

NF, GC = 64, 32


def _rdb_np(rng, nf=NF, gc=GC):
    ws, bs = [], []
    for c in range(1, 6):
        cin, cout = nf + (c - 1) * gc, (gc if c < 5 else nf)
        ws.append(rng.standard_normal((3, 3, cin, cout)).astype(np.float32) / np.sqrt(cin * 9))
        bs.append(rng.standard_normal(cout).astype(np.float32) * 0.02)
    return ws, bs


def _trunk_np(seed, nb, nr, plus, nf=NF, gc=GC):
    """[nb][nr] HWIO weights, biases and (nf, gc) 1x1 weights, the JAX layouts."""
    rng = np.random.default_rng(seed)
    tws, tbs, w1s = [], [], []
    for _ in range(nb):
        rows = [_rdb_np(rng, nf, gc) for _ in range(nr)]
        tws.append([r[0] for r in rows])
        tbs.append([r[1] for r in rows])
        w1s.append([rng.standard_normal((nf, gc)).astype(np.float32) * 0.1 for _ in range(nr)])
    return tws, tbs, (w1s if plus else None)


def _to_port(tws, tbs, w1s):
    oihw = lambda w: torch.from_numpy(np.ascontiguousarray(w.transpose(3, 2, 0, 1)))  # noqa: E731
    weights = [[[oihw(w) for w in rdb] for rdb in row] for row in tws]
    biases = [[[torch.from_numpy(b) for b in rdb] for rdb in row] for row in tbs]
    w1 = None
    if w1s is not None:
        w1 = [[torch.from_numpy(np.ascontiguousarray(w.T))[:, :, None, None] for w in row]
              for row in w1s]
    return weights, biases, w1


@pytest.mark.parametrize("nb,plus,shape", [(2, False, (2, 32, 48, NF)),
                                           (1, True, (1, 32, 32, NF))])
def test_trunk_matches_jax_trunk(nb, plus, shape):
    """The port's trunk (on the CPU: the workspace loop over the plain
    versions) against the JAX fused_rrdb_trunk in interpret mode, the cases
    of test_fused_rrdb_trunk_matches_xla and _plus."""
    tws, tbs, w1s = _trunk_np(7, nb, 3, plus)
    x = np.random.default_rng(8).standard_normal(shape).astype(np.float32)
    ref = np.asarray(jax_trunk(
        jnp.asarray(x), [[[jnp.asarray(w) for w in r] for r in row] for row in tws],
        [[[jnp.asarray(b) for b in r] for r in row] for row in tbs], nb=nb, nr=3, gc=GC,
        plus=plus, conv1x1_ws=None if w1s is None else [[jnp.asarray(w) for w in row] for row in w1s],
        block=(16, 16), interpret=True))
    weights, biases, w1 = _to_port(tws, tbs, w1s)
    out = fused_rrdb_trunk(torch.from_numpy(x), weights, biases, nb=nb, nr=3, gc=GC,
                           plus=plus, conv1x1_ws=w1)
    np.testing.assert_allclose(out.numpy(), ref, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("nb,nr,plus", [(2, 3, False), (1, 3, True), (2, 1, False), (2, 2, True)])
def test_workspace_loop_equals_the_plain_trunk(dtype, nb, nr, plus):
    """The three-workspace rotation (the last RDB of an RRDB writing over
    the RRDB input in place; nr == 1 swapping workspaces) gives exactly
    the plain trunk."""
    tws, tbs, w1s = _trunk_np(3, nb, nr, plus, nf=16, gc=8)
    weights, biases, w1 = _to_port(tws, tbs, w1s)
    weights = [[[w.to(dtype) for w in r] for r in row] for row in weights]
    x = torch.from_numpy(np.random.default_rng(4).standard_normal((2, 9, 11, 16), np.float32)).to(dtype)
    out = fused_rrdb_trunk(x, weights, biases, nb=nb, nr=nr, gc=8, plus=plus, conv1x1_ws=w1)
    ref = rrdb_trunk_reference(x, weights, biases, nb=nb, nr=nr, plus=plus, conv1x1_ws=w1)
    assert out.dtype == dtype and torch.equal(out, ref)


def test_padded_call_refuses_what_the_kernel_cannot_do():
    tws, tbs, _ = _trunk_np(1, 1, 1, False, nf=16, gc=8)
    weights, biases, _ = _to_port(tws, tbs, None)
    ws = torch.zeros(1, 5, 6, 16 + 4 * 8)
    with pytest.raises(ValueError, match="must not be ws"):
        fused_rdb_padded(ws, weights[0][0], biases[0][0], ws)
    with pytest.raises(ValueError, match="res must be"):
        fused_rdb_padded(ws, weights[0][0], biases[0][0], torch.zeros_like(ws),
                         res=torch.zeros(1, 5, 6, 16))


@pytest.mark.parametrize("plus", [False, True])
def test_chain_gate_fires_in_the_model(monkeypatch, plus):
    """INNFER_RDB_CHAIN=1 routes the trunk through fused_rrdb_trunk (the
    weights collected by the JAX package's keys); the result matches the
    per-RRDB path, as test_model_chain_integration does for the JAX side."""
    import innfer_tpu_torch.models.rrdb as M

    spec = {"type": "esrgan", "nb": 2, "nf": 32, "gc": 16, "plus": plus}
    state = SP.esrgan_state(nb=2, nf=32, gc=16, scale=4, plus=plus, seed=2)
    jm, jp = jax_load_from_state(state, jax_config(spec, 4))
    params = params_from_jax({k: np.asarray(v) for k, v in jp.items()})
    x = torch.from_numpy(np.random.default_rng(1).random((1, 20, 28, 3), np.float32))
    calls = []
    orig = M.fused_rrdb_trunk

    def spy(*a, **kw):
        calls.append(kw["nb"])
        return orig(*a, **kw)

    monkeypatch.setattr(M, "fused_rrdb_trunk", spy)
    monkeypatch.delenv("INNFER_RDB_CHAIN", raising=False)
    model = get_network(jax_config(spec, 4))
    # the card's answer on the CPU: the kernels' wrappers run their plain versions
    monkeypatch.setattr(RDB, "fusable", RDB.takes)
    ref = model.apply_trunk(params, x)
    assert calls == []  # off by default
    monkeypatch.setenv("INNFER_RDB_CHAIN", "1")
    out = model.apply_trunk(params, x)
    assert calls == [2], "chain gate did not fire"
    monkeypatch.setattr(RDB, "fusable", lambda *a, **k: False)
    model.apply_trunk(params, x)
    assert calls == [2], "a trunk the kernel does not take must not take the chain"
    np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(out.numpy(), np.asarray(jm.apply_trunk(jp, jnp.asarray(x.numpy()))),
                               atol=2e-5, rtol=2e-5)
