"""The port's fused RDB (innfer_tpu_torch/ops/rdb.py) against the JAX package.

The plain version ``rdb_reference`` is held against the Pallas kernel in
interpret mode (as tests/test_pallas_rdb.py runs it) and against the XLA
gather form ``innfer_tpu.models.rrdb._rdb5c``.  Tolerances: fp32 atol =
rtol = 2e-5, because XLA-CPU and torch-CPU sum the 5-conv chain in
different orders; bf16 max-abs < 0.05, the bar of
test_pallas_rdb.py::test_fused_rdb_bf16_close.  The CUDA kernel itself
runs only on the card: tests/test_torch_gpu.py.
"""
import numpy as np
import pytest
import torch
import torch.nn.functional as TF

import jax.numpy as jnp

from innfer_tpu.models.rrdb import _rdb5c as jax_rdb5c
from innfer_tpu.ops.pallas.rdb import fused_rdb as jax_fused_rdb
from innfer_tpu_torch.ops.conv3x3 import n_tile, pack_conv3x3, packed_elems
from innfer_tpu_torch.ops.rdb import fused_rdb, pack_rdb, rdb_reference


def _make_rdb(seed, nf, gc, plus=False):
    """Seeded HWIO weights (the JAX layout) and fp32 biases, as numpy."""
    rng = np.random.default_rng(seed)
    ws, bs = [], []
    for c in range(1, 6):
        cin = nf + (c - 1) * gc
        cout = gc if c < 5 else nf
        ws.append(rng.standard_normal((3, 3, cin, cout)).astype(np.float32)
                  / np.sqrt(cin * 9))
        bs.append(rng.standard_normal(cout).astype(np.float32) * 0.02)
    w1 = (rng.standard_normal((1, 1, nf, gc)).astype(np.float32) / 8
          if plus else None)
    return ws, bs, w1


def _torch_params(ws, bs, w1):
    tw = [torch.from_numpy(np.ascontiguousarray(w.transpose(3, 2, 0, 1)))
          for w in ws]  # HWIO -> OIHW
    tb = [torch.from_numpy(b) for b in bs]
    t1 = (None if w1 is None else
          torch.from_numpy(np.ascontiguousarray(w1.transpose(3, 2, 0, 1))))
    return tw, tb, t1


CASES = [
    # (nf, gc, h, w, plus)
    (64, 32, 32, 32, False),
    (32, 16, 32, 32, False),
    (32, 16, 48, 32, False),   # rectangular tile
    (64, 32, 32, 32, True),    # ESRGAN+ plus
]


@pytest.mark.parametrize("nf,gc,h,w,plus", CASES)
def test_reference_matches_pallas_interpret_fp32(nf, gc, h, w, plus):
    ws, bs, w1 = _make_rdb(1, nf, gc, plus)
    x = np.random.default_rng(2).standard_normal((1, h, w, nf)).astype(np.float32)
    ref = jax_fused_rdb(jnp.asarray(x), [jnp.asarray(v) for v in ws],
                        [jnp.asarray(v) for v in bs], gc=gc, plus=plus,
                        conv1x1_w=None if w1 is None else jnp.asarray(w1),
                        block=(16, 16), interpret=True)
    tw, tb, t1 = _torch_params(ws, bs, w1)
    out = rdb_reference(torch.from_numpy(x), tw, tb, plus=plus, conv1x1_w=t1)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("nf,gc,h,w,plus", CASES)
def test_reference_matches_xla_gather_fp32(nf, gc, h, w, plus):
    ws, bs, w1 = _make_rdb(3, nf, gc, plus)
    x = np.random.default_rng(4).standard_normal((1, h, w, nf)).astype(np.float32)
    params = {}
    for c in range(5):
        params[f"p.conv{c + 1}.0.weight"] = jnp.asarray(ws[c])
        params[f"p.conv{c + 1}.0.bias"] = jnp.asarray(bs[c])
    if plus:
        params["p.conv1x1.weight"] = jnp.asarray(w1)
    ref = jax_rdb5c(params, jnp.asarray(x), "p", act_type="leakyrelu", plus=plus)
    tw, tb, t1 = _torch_params(ws, bs, w1)
    out = rdb_reference(torch.from_numpy(x), tw, tb, plus=plus, conv1x1_w=t1)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("plus", [False, True])
def test_reference_bf16_close(plus):
    nf, gc = 64, 32
    ws, bs, w1 = _make_rdb(5, nf, gc, plus)
    x = np.random.default_rng(6).standard_normal((1, 32, 32, nf)).astype(np.float32)
    bf = lambda v: jnp.asarray(v).astype(jnp.bfloat16)  # noqa: E731
    pallas_bf16 = np.asarray(jax_fused_rdb(
        bf(x), [bf(v) for v in ws], [jnp.asarray(v) for v in bs], gc=gc,
        plus=plus, conv1x1_w=None if w1 is None else bf(w1), block=(16, 16),
        interpret=True), np.float32)
    tw, tb, t1 = _torch_params(ws, bs, w1)
    fp32 = rdb_reference(torch.from_numpy(x), tw, tb, plus=plus, conv1x1_w=t1)
    out = rdb_reference(torch.from_numpy(x).bfloat16(), [v.bfloat16() for v in tw],
                        tb, plus=plus,
                        conv1x1_w=None if t1 is None else t1.bfloat16())
    assert out.dtype == torch.bfloat16
    out = out.float().numpy()
    assert np.abs(out - pallas_bf16).max() < 0.05
    assert np.abs(out - fp32.numpy()).max() < 0.05


def read_packed(flat, cin, cout):
    """An OIHW fp32 weight read back from the packed layout at the offsets
    conv3x3_tc.cuh::packed_index computes:
    ((((g * chunks + c / 16) * 9 + tap) * 2 + (c % 16) / 8) * nt + n) * 8 + c % 8
    with nt the N tile of cout, g = co / nt and n = co % nt."""
    nt = next(n for n in (8, 16, 32, 64, 128, 256, 10 ** 9) if n >= min(cout, 256))
    chunks = -(-cin // 16)
    co, c, tap = np.meshgrid(np.arange(cout), np.arange(cin), np.arange(9), indexing="ij")
    idx = (((((co // nt) * chunks + c // 16) * 9 + tap) * 2 + (c % 16) // 8) * nt
           + co % nt) * 8 + c % 8
    assert idx.max() < flat.numel()
    return flat.float()[torch.from_numpy(idx)].reshape(cout, cin, 3, 3)


def _emulate_kernel(x, packed, nf, gc, plus):
    """The CUDA host function's split of the work, in PyTorch: the NHWC
    workspace [x|x1..x4], five convs reading the packed weights at the C
    code's offsets (conv c's block starts where conv c-1's padded block
    ends), and its four epilogues."""
    dt = x.dtype
    rnd = lambda t: t.to(dt).float()  # noqa: E731
    b_, h, w, _ = x.shape
    ws = torch.zeros(b_, h, w, nf + 4 * gc)
    ws[..., :nf] = x.float()
    woff = boff = 0
    for c in range(1, 6):
        cin, cout = nf + (c - 1) * gc, (gc if c < 5 else nf)
        nt = next(n for n in (8, 16, 32, 64, 128, 256) if n >= min(cout, 256))
        size = -(-cout // nt) * -(-cin // 16) * 9 * 16 * nt
        wc = read_packed(packed.w[woff: woff + size], cin, cout).permute(1, 2, 3, 0)
        xp = TF.pad(ws[..., :cin], (0, 0, 1, 1, 1, 1))
        acc = sum(xp[:, ky: ky + h, kx: kx + w, :] @ wc[:, ky, kx, :]
                  for ky in range(3) for kx in range(3))
        acc = acc + packed.b[boff: boff + cout]
        if c == 5:
            out = (acc * 0.2 + ws[..., :nf]).to(dt)
            break
        v = rnd(torch.where(acc >= 0, acc, acc * 0.2))
        if plus and c == 2:
            v = v + rnd(ws[..., :nf] @ packed.w1.float())
        if plus and c == 4:
            v = v + ws[..., nf + gc: nf + 2 * gc]
        ws[..., nf + (c - 1) * gc: nf + c * gc] = rnd(v)
        woff += size
        boff += cout
    return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("plus", [False, True])
@pytest.mark.parametrize("nf_gc", [(32, 16), (24, 8)])
def test_packed_layout_emulation_matches_reference(dtype, plus, nf_gc):
    """The kernel's packed weights and channel offsets, emulated on the CPU,
    compute the plain version's function; (24, 8) pads cin and cout."""
    nf, gc = nf_gc
    ws, bs, w1 = _make_rdb(7, nf, gc, plus)
    tw, tb, t1 = _torch_params(ws, bs, w1)
    tw = [v.to(dtype) for v in tw]
    t1 = None if t1 is None else t1.to(dtype)
    x = torch.from_numpy(np.random.default_rng(8).standard_normal(
        (2, 20, 24, nf)).astype(np.float32)).to(dtype)
    packed = pack_rdb(tw, tb, t1, dtype)
    assert packed.w.dtype == dtype and packed.b.dtype == torch.float32
    assert packed.w.numel() == sum(packed_elems(nf + c * gc, gc if c < 4 else nf)
                                   for c in range(5))
    emu = _emulate_kernel(x, packed, nf, gc, plus).float()
    ref = rdb_reference(x, tw, tb, plus=plus, conv1x1_w=t1).float()
    tol = 2e-5 if dtype == torch.float32 else 0.05
    assert (emu - ref).abs().max().item() < tol


def test_wrapper_takes_plain_path_on_cpu_without_counting():
    nf, gc = 32, 16
    ws, bs, w1 = _make_rdb(9, nf, gc, True)
    tw, tb, t1 = _torch_params(ws, bs, w1)
    x = torch.from_numpy(np.random.default_rng(10).standard_normal(
        (1, 16, 24, nf)).astype(np.float32))
    before = fused_rdb.launches
    out = fused_rdb(x, tw, tb, plus=True, conv1x1_w=t1)
    ref = rdb_reference(x, tw, tb, plus=True, conv1x1_w=t1)
    assert torch.equal(out, ref)
    assert fused_rdb.launches == before  # the plain path launches nothing


def test_wrapper_rejects_what_the_kernel_does_not_take():
    nf, gc = 32, 16
    ws, bs, _ = _make_rdb(11, nf, gc)
    tw, tb, _ = _torch_params(ws, bs, None)
    x = torch.zeros(1, 16, 16, nf)
    with pytest.raises(ValueError, match="contiguous"):
        fused_rdb(x.permute(0, 2, 1, 3), tw, tb)
    with pytest.raises(TypeError):
        fused_rdb(x.half(), tw, tb)
    with pytest.raises(ValueError, match="five"):
        fused_rdb(x, tw[:4], tb)
    with pytest.raises(ValueError, match="plus"):
        fused_rdb(x, tw, tb, plus=True)
    ws12, bs12, _ = _make_rdb(12, 12, 8)
    tw12, tb12, _ = _torch_params(ws12, bs12, None)
    with pytest.raises(ValueError, match="nf % 8"):
        fused_rdb(torch.zeros(1, 8, 8, 12), tw12, tb12)


@pytest.mark.parametrize("cout,nt", [(8, 8), (24, 32), (32, 32), (64, 64), (96, 128),
                                     (256, 256), (320, 256)])
def test_n_tile_and_packed_size(cout, nt):
    """N tiles are wgmma widths; cout above 256 spans several tiles, and the
    padded channels of the packed weights are zeros."""
    assert n_tile(cout) == nt
    w = torch.randn(cout, 40, 3, 3)
    flat = pack_conv3x3(w, torch.float32)
    assert flat.numel() == packed_elems(40, cout) == -(-cout // nt) * nt * 48 * 9
    assert torch.equal(read_packed(flat, 40, cout), w)
    assert flat.abs().sum().item() == pytest.approx(w.abs().sum().item(), rel=1e-5)
