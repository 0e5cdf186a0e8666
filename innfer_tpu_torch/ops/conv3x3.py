"""The host side of the shared 3x3 conv core (``csrc/conv3x3_tc.cuh``):
the packed weight layout that both its kernels read.

    [N tile g][16-channel chunk][tap ky*3+kx][8-channel half][n][8]

An N tile holds ``n_tile(cout)`` output channels; channels past cin and
past cout are zeros.  One 16-channel chunk of all nine taps is then one
contiguous block, laid out as the wgmma B operand reads it from shared
memory (core matrices of 8 output channels x 8 input channels), so the
kernel stages it with a straight copy.
"""
from __future__ import annotations

import torch

KC = 16            # input channels per chunk (one wgmma K step)
N_TILES = (8, 16, 32, 64, 128, 256)


def n_tile(cout: int) -> int:
    """Output channels per N tile: the smallest wgmma width in N_TILES
    that holds cout, 256 beyond it (the rule of conv3x3_tc.cuh::n_tile)."""
    return next((n for n in N_TILES if n >= cout), N_TILES[-1])


def packed_elems(cin: int, cout: int) -> int:
    nt = n_tile(cout)
    return -(-cout // nt) * -(-cin // KC) * 9 * KC * nt


def pack_conv3x3(w: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """An OIHW (cout, cin, 3, 3) weight in the packed layout, flat, in
    ``dtype``."""
    cout, cin = w.shape[:2]
    nt = n_tile(cout)
    groups, chunks = -(-cout // nt), -(-cin // KC)
    p = torch.zeros(groups * nt, chunks * KC, 3, 3, dtype=dtype, device=w.device)
    p[:cout, :cin] = w.to(dtype)
    # (g, n, chunk, half, e, tap) -> (g, chunk, tap, half, n, e)
    p = p.reshape(groups, nt, chunks, 2, 8, 9).permute(0, 2, 5, 3, 1, 4)
    return p.contiguous().reshape(-1)
