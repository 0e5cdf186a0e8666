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
from innfer_tpu_torch.ops.conv3x3 import n_tile, pack_conv3x3, packed_elems, tma_channels
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


def read_packed(flat, cin, cout, tma=False):
    """An OIHW fp32 weight read back from the packed layout at the offsets
    conv3x3_tc.cuh::packed_index computes:
    ((((g * chunks + c / 16) * 9 + tap) * 2 + (c % 16) / 8) * nt + n) * 8 + c % 8
    with nt the N tile of cout, g = co / nt and n = co % nt; with ``tma``
    (the bf16 TMA conv) n is the column whose channel is co % nt: column
    8 i + 2 q + e holds channel (nt / 4) q + 2 i + e."""
    nt = next(n for n in (8, 16, 32, 64, 128, 256, 10 ** 9) if n >= min(cout, 256))
    chunks = -(-cin // 16)
    co, c, tap = np.meshgrid(np.arange(cout), np.arange(cin), np.arange(9), indexing="ij")
    col = co % nt
    if tma:
        k = col % (nt // 4)  # column of channel (nt / 4) q + k: 8 (k // 2) + 2 q + k % 2
        col = 8 * (k // 2) + 2 * (col // (nt // 4)) + k % 2
    idx = (((((co // nt) * chunks + c // 16) * 9 + tap) * 2 + (c % 16) // 8) * nt
           + col) * 8 + c % 8
    assert idx.max() < flat.numel()
    return flat.float()[torch.from_numpy(idx)].reshape(cout, cin, 3, 3)


def _emulate_kernel(x, packed, nf, gc, plus):
    """The CUDA host function's split of the work, in PyTorch: the NHWC
    workspace [x|x1..x4], five convs reading the packed weights at the C
    code's offsets (conv c's block starts where conv c-1's padded block
    ends; bf16 in the TMA conv's column order), and its four epilogues."""
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
        wc = read_packed(packed.w[woff: woff + size], cin, cout,
                         tma=dt == torch.bfloat16).permute(1, 2, 3, 0)
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


# conv3x3_tma.cuh's split of a bf16 conv: tiles of TH = 2 R rows x 64
# columns, consumer warpgroup c taking rows [c R, c R + R); R by N tile.
TMA_TW, TMA_CONSUMERS = 64, 2


def tma_rows(nt):
    return 1 if nt >= 256 else 2 if nt >= 128 else 4 if nt >= 64 else 8


def tma_tile_walk(b, h, w, cout, sms):
    """The persistent grid's order: min(tiles, sms) blocks; block k takes
    tiles k, k + grid, ... of the row-major (N group, image, tile row, tile
    column) order.  Yields (block, group, image, y0, x0)."""
    th = TMA_CONSUMERS * tma_rows(n_tile(cout))
    tx_n, ty_n = -(-w // TMA_TW), -(-h // th)
    per_img = tx_n * ty_n
    count = per_img * b * -(-cout // n_tile(cout))
    grid = min(count, sms)
    for blk in range(grid):
        for t in range(blk, count, grid):
            grp, rem = divmod(t, per_img * b)
            img, ti = divmod(rem, per_img)
            yield blk, grp, img, (ti // tx_n) * th, (ti % tx_n) * TMA_TW


def _tma_box(t, ch, c, x, y, img, rows):
    """One TMA box of 8 channels x 66 columns x rows at (c, x, y, img) of
    an NHWC tensor with ch channels, zero where it lies outside."""
    out = torch.zeros(rows, TMA_TW + 2, 8)
    if c >= ch:
        return out
    _, h, w, _ = t.shape
    ys, xs = slice(max(y, 0), min(y + rows, h)), slice(max(x, 0), min(x + TMA_TW + 2, w))
    out[ys.start - y: ys.stop - y, xs.start - x: xs.stop - x] = t[img, ys, xs, c: c + 8].float()
    return out


def _tma_conv(head, src, cin, cout, flat, sms):
    """One conv as conv_tma computes it: per tile and 16-channel chunk, the
    two 8-channel halo boxes (from head below its channel count, else from
    src; past cin a box past the tensor) and the chunk's packed weights
    [tap][half][n][8] (column n: channel tma_channels(nt)[n]); each
    consumer's rows as nine tap-shifted products.  Returns the fp32 sums
    (B, H, W, cout) and how often each was written."""
    b, h, w, _ = src.shape
    nt, chunks = n_tile(cout), -(-cin // 16)
    r = tma_rows(nt)
    acc = torch.zeros(b, h, w, cout)
    hits = torch.zeros(b, h, w, cout, dtype=torch.int32)
    wgt = flat.float().reshape(-1, chunks, 9, 2, nt, 8)
    for _, grp, img, y0, x0 in tma_tile_walk(b, h, w, cout, sms):
        tile = torch.zeros(TMA_CONSUMERS * r, TMA_TW, nt)
        for k in range(chunks):
            planes = [_tma_box(head, head.shape[-1], c, x0 - 1, y0 - 1, img, 2 * r + 2)
                      if c < min(cin, head.shape[-1]) else
                      _tma_box(src, cin, c, x0 - 1, y0 - 1, img, 2 * r + 2)
                      for c in (16 * k, 16 * k + 8)]
            halo = torch.cat(planes, -1)                      # (TH + 2, 66, 16)
            bk = wgt[grp, k].permute(0, 2, 1, 3).reshape(9, nt, 16)  # [tap][n][c]
            for cw in range(TMA_CONSUMERS):
                rows = slice(cw * r, cw * r + r)
                for tap in range(9):
                    dy, dx = divmod(tap, 3)
                    a = halo[cw * r + dy: cw * r + dy + r, dx: dx + TMA_TW]
                    tile[rows] += a @ bk[tap].t()
        chan = torch.empty_like(tile)
        chan[..., tma_channels(nt)] = tile  # column n holds channel tma_channels(nt)[n]
        ys, xs = slice(y0, min(y0 + 2 * r, h)), slice(x0, min(x0 + TMA_TW, w))
        co = slice(grp * nt, min(grp * nt + nt, cout))
        acc[img, ys, xs, co] = chan[: ys.stop - y0, : xs.stop - x0, : co.stop - co.start]
        hits[img, ys, xs, co] += 1
    return acc, hits


def _emulate_tma_rdb(x, packed, nf, gc, plus, sms):
    """The bf16 device path's split of one RDB: five _tma_conv calls on the
    workspace [x|x1..x4] (x read where it lies, as the head), each with
    RdbEpi's epilogue; asserts every output value is written exactly once."""
    dt = x.dtype
    rnd = lambda t: t.to(dt).float()  # noqa: E731
    ws = torch.zeros(*x.shape[:3], nf + 4 * gc)
    woff = boff = 0
    for c in range(1, 6):
        cin, cout = nf + (c - 1) * gc, (gc if c < 5 else nf)
        size = packed_elems(cin, cout)
        acc, hits = _tma_conv(x, ws, cin, cout, packed.w[woff: woff + size], sms)
        assert hits.min().item() == hits.max().item() == 1
        acc = acc + packed.b[boff: boff + cout]
        if c == 5:
            return (acc * 0.2 + x.float()).to(dt)
        v = rnd(torch.where(acc >= 0, acc, acc * 0.2))
        if plus and c == 2:
            v = v + rnd(x.float() @ packed.w1.float())
        if plus and c == 4:
            v = v + ws[..., nf + gc: nf + 2 * gc]
        ws[..., nf + (c - 1) * gc: nf + c * gc] = rnd(v)
        woff += size
        boff += cout


TMA_CASES = [
    # (nf, gc, b, h, w, plus, sms): columns past the 64-column tile, rows
    # past the 16- and 8-row tiles, B > 1, several tiles a block and fewer
    # tiles than blocks, a 16-channel chunk split at nf (24)
    (64, 32, 1, 48, 144, False, 5),
    (32, 16, 2, 32, 80, True, 3),
    (24, 8, 2, 9, 65, False, 132),
    (64, 32, 2, 21, 130, True, 132),
]


def _jax_rdb(x, ws, bs, w1, gc, plus, dtype):
    """The JAX package's RDB: the Pallas kernel in interpret mode where its
    16-multiple blocks divide the image, else (fp32 only) the XLA gather
    form; None for bf16 on a ragged image."""
    h, w = x.shape[1:3]
    if h % 16 == 0 and w % 16 == 0:
        jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
        return np.asarray(jax_fused_rdb(
            jnp.asarray(x).astype(jdt), [jnp.asarray(v).astype(jdt) for v in ws],
            [jnp.asarray(v) for v in bs], gc=gc, plus=plus,
            conv1x1_w=None if w1 is None else jnp.asarray(w1).astype(jdt), block=(16, 16),
            interpret=True), np.float32)
    if dtype != torch.float32:
        return None
    params = {f"p.conv{c + 1}.0.{k}": jnp.asarray(v) for c in range(5)
              for k, v in (("weight", ws[c]), ("bias", bs[c]))}
    if plus:
        params["p.conv1x1.weight"] = jnp.asarray(w1)
    return np.asarray(jax_rdb5c(params, jnp.asarray(x), "p", act_type="leakyrelu", plus=plus))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("nf,gc,b,h,w,plus,sms", TMA_CASES)
def test_tma_tile_walk_emulation_matches_reference_and_jax(dtype, nf, gc, b, h, w, plus, sms):
    """conv_tma's persistent tile walk and halo boxes, emulated on the CPU,
    cover every output once and compute the plain version's function and
    the JAX package's (see _jax_rdb): fp32 2e-5, bf16 0.05."""
    ws, bs, w1 = _make_rdb(13, nf, gc, plus)
    tw, tb, t1 = _torch_params(ws, bs, w1)
    tw = [v.to(dtype) for v in tw]
    t1 = None if t1 is None else t1.to(dtype)
    x = np.random.default_rng(14).standard_normal((b, h, w, nf)).astype(np.float32)
    xt = torch.from_numpy(x).to(dtype)
    packed = pack_rdb(tw, tb, t1, dtype)
    if dtype == torch.float32:  # the TMA conv's column order in fp32 arithmetic too
        packed = packed._replace(w=torch.cat([pack_conv3x3(v, dtype, tma=True) for v in tw]))
    emu = _emulate_tma_rdb(xt, packed, nf, gc, plus, sms).float()
    ref = rdb_reference(xt, tw, tb, plus=plus, conv1x1_w=t1).float()
    tol = 2e-5 if dtype == torch.float32 else 0.05
    assert (emu - ref).abs().max().item() < tol
    jax_out = _jax_rdb(x, ws, bs, w1, gc, plus, dtype)
    if jax_out is not None:
        assert np.abs(emu.numpy() - jax_out).max() < tol


@pytest.mark.parametrize("cout,nt", [(8, 8), (16, 16), (24, 32), (64, 64), (96, 128), (320, 256)])
def test_tma_packed_columns_hold_consecutive_channels_per_lane(cout, nt):
    """pack_conv3x3(tma=True) is a column permutation of the plain layout in
    which accumulator lane q (columns 8 i + 2 q + e) holds channels
    (nt / 4) q .. (nt / 4) (q + 1) - 1, read back at the C offsets."""
    w = torch.randn(cout, 40, 3, 3)
    flat = pack_conv3x3(w, torch.float32, tma=True)
    assert flat.numel() == packed_elems(40, cout)
    assert torch.equal(read_packed(flat, 40, cout, tma=True), w)
    perm = tma_channels(nt)
    assert sorted(perm.tolist()) == list(range(nt))
    for q in range(4):
        cols = [8 * i + 2 * q + e for i in range(nt // 8) for e in range(2)]
        assert perm[cols].tolist() == list(range(nt // 4 * q, nt // 4 * (q + 1)))


@pytest.mark.parametrize("b,h,w,cout,sms", [(1, 1088, 1920, 32, 132), (1, 1088, 1920, 64, 132),
                                            (3, 17, 129, 24, 4), (2, 5, 64, 320, 7)])
def test_tma_tile_walk_covers_each_tile_once(b, h, w, cout, sms):
    """The persistent order visits every (N group, image, tile) once, spread
    over min(tiles, SMs) blocks whose counts differ by at most one; at the
    main-path shape 2040 tiles of 16 x 64 for N = 32 and 4080 of 8 x 64 for
    N = 64 over 132 blocks."""
    seen = list(tma_tile_walk(b, h, w, cout, sms))
    keys = [s[1:] for s in seen]
    assert len(keys) == len(set(keys))
    th = TMA_CONSUMERS * tma_rows(n_tile(cout))
    groups = -(-cout // n_tile(cout))
    assert len(keys) == groups * b * -(-h // th) * -(-w // TMA_TW)
    per_block = np.bincount([s[0] for s in seen])
    assert len(per_block) == min(len(keys), sms) and per_block.max() - per_block.min() <= 1
    if (h, w) == (1088, 1920):
        assert len(keys) == {32: 2040, 64: 4080}[cout]


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
