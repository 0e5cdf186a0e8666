"""Phase-space (deferred pixel-shuffle) convolution primitives, in PyTorch.

The port's counterpart of ``innfer_tpu/nn/phase.py``.  A tensor at the
r-times-finer resolution is held in *phase-major* form

    P[b, y, x, (a*r + c)*C + ch]  ==  HR[b, r*y + a, r*x + c, ch]

and a 3x3/pad-1 conv at HR resolution decomposes exactly into r^2 small
convs on P, one per output phase: the three HR taps around output row
r*y + a land on phase (a+dy) mod r at grid row y + floor((a+dy)/r), a
window of at most two grid cells per axis.  The per-phase kernels are a
pure placement of the original taps (0/1 coefficients, disjoint slots), so
the decomposition is exact up to fp32 accumulation order.

Weights stay OIHW, as everywhere in the port (``models/base.py``); the
phase-major channel order ``(a*r + c)*C + ch`` holds on the input and the
output channels of every kernel built here.

At r=2 the per-phase kernels cost 16/9 of the HR conv's FLOPs, at 1/r^2
the spatial size with r^2-wider input channels.  :func:`phase_conv3x3`
runs all r^2 phases as ONE convolution: every per-phase window fits a
``kmax`` x ``kmax`` kernel (kmax = 2 for every r >= 2), so the phases'
kernels stack on the output channels of one conv with symmetric padding 1,
and each phase crops its own window offset from the (H+1, W+1) result.
That reads the input once (one fp32 copy on the bias route of
``nn/functional.conv2d``) where r^2 separate convs would read it r^2
times, and it needs no padded copy of the input.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from innfer_tpu_torch.nn import functional as F

Pad = Tuple[Tuple[int, int], Tuple[int, int]]


def _phase_windows(r: int):
    """Per output phase a: (cmin, cmax) grid-cell window covering the
    3 taps dy in {-1,0,1} -> cell floor((a+dy)/r)."""
    wins = []
    for a in range(r):
        cells = [(a + dy) // r for dy in (-1, 0, 1)]
        wins.append((min(cells), max(cells)))
    return wins


def _phase_sel(r: int) -> np.ndarray:
    """sel[a, p, k, d] = 1 iff tap d (dy = d-1) of output phase a reads
    input phase p at kernel cell k (relative to the phase's window start)."""
    wins = _phase_windows(r)
    kmax = max(hi - lo + 1 for lo, hi in wins)
    sel = np.zeros((r, r, kmax, 3), np.float32)
    for a in range(r):
        lo, _hi = wins[a]
        for d, dy in enumerate((-1, 0, 1)):
            sel[a, (a + dy) % r, (a + dy) // r - lo, d] = 1.0
    return sel


def phase_kernels(w: torch.Tensor, r: int = 2) -> List[Tuple[torch.Tensor, Pad]]:
    """Per-output-phase kernels of a 3x3/pad-1 conv evaluated in phase space.

    ``w``: (cout, cin, 3, 3) OIHW.  Returns r*r entries, in output-phase-
    major order (a*r + c), of ((cout, r*r*cin, ka, kc) kernel, ((top, bot),
    (left, right)) pad); input channels are phase-major.  Pure placement:
    exact."""
    cout, cin, kh, kw = w.shape
    assert kh == 3 and kw == 3, (kh, kw)
    sel = torch.from_numpy(_phase_sel(r)).to(w.device)
    wins = _phase_windows(r)
    wf = w.float()
    out = []
    for a in range(r):
        alo, ahi = wins[a]
        ka = ahi - alo + 1
        for c in range(r):
            clo, chi = wins[c]
            kc = chi - clo + 1
            # (p,k,d) x (q,l,e) x (o,i,d,e) -> (o,p,q,i,k,l); (p,q,i) flattens
            # phase-major, the layout of P's channels
            kab = torch.einsum("pkd,qle,oide->opqikl", sel[a, :, :ka], sel[c, :, :kc], wf)
            out.append((kab.reshape(cout, r * r * cin, ka, kc).to(w.dtype),
                        ((-alo, ahi), (-clo, chi))))
    return out


def merge_phase_kernels(kernels: List[Tuple[torch.Tensor, Pad]], r: int = 2):
    """The r*r per-phase kernels of :func:`phase_kernels` stacked on the
    output channels of one (r*r*cout, r*r*cin, kmax, kmax) kernel, each at
    the top-left of its slot (zeros fill a smaller window), with the (row,
    column) offset at which each phase's output starts in a symmetric
    pad-1 conv's result.  The offset is 1 + the window's first cell, and
    every window starts at cell -1 or 0, so a kmax = 2 kernel never reads
    past pad 1."""
    cout = kernels[0][0].shape[0]
    kmax = max(max(k.shape[2:]) for k, _ in kernels)
    merged = kernels[0][0].new_zeros((len(kernels) * cout, kernels[0][0].shape[1], kmax, kmax))
    offsets = []
    for i, (k, ((top, _), (left, _))) in enumerate(kernels):
        merged[i * cout:(i + 1) * cout, :, :k.shape[2], :k.shape[3]] = k
        offsets.append((1 - top, 1 - left))
    return merged, offsets


def conv_phases(p: torch.Tensor, merged: torch.Tensor, offsets, b: Optional[torch.Tensor],
                r: int = 2) -> torch.Tensor:
    """Run merged per-phase kernels (:func:`merge_phase_kernels`) on the
    phase-major ``p``: one conv with symmetric padding 1, then each phase's
    channels cropped at its offset and concatenated phase-major."""
    _bsz, hg, wg, _ = p.shape
    out = F.conv2d(p, merged, phase_bias(b, r), padding=1)
    cout = merged.shape[0] // len(offsets)
    return torch.cat([out[:, oy:oy + hg, ox:ox + wg, i * cout:(i + 1) * cout]
                      for i, (oy, ox) in enumerate(offsets)], dim=-1)


def phase_conv3x3(p: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None,
                  r: int = 2) -> torch.Tensor:
    """Exact phase-space evaluation of conv3x3(HR, w, b, padding=1).

    ``p``: (B, Hg, Wg, r*r*cin) phase-major; returns (B, Hg, Wg, r*r*cout)
    phase-major.  HR zero padding maps bit-for-bit to grid zero padding
    (only taps that cross the HR border reach grid cells -1 / Hg)."""
    merged, offsets = merge_phase_kernels(phase_kernels(w, r), r)
    return conv_phases(p, merged, offsets, b, r)


def dense_phase_kernel(w: torch.Tensor, r: int = 2) -> torch.Tensor:
    """The merged (r*r*cout, r*r*cin, 3, 3) kernel of
    :func:`phase_conv3x3_dense`: absolute cell indexing, zeros where a
    (cell, phase) slot carries no tap."""
    cout, cin, kh, kw = w.shape
    assert kh == 3 and kw == 3, (kh, kw)
    sel = np.zeros((r, r, 3, 3), np.float32)  # (a, p, cell, tap)
    for a in range(r):
        for d, dy in enumerate((-1, 0, 1)):
            sel[a, (a + dy) % r, (a + dy) // r + 1, d] = 1.0
    s = torch.from_numpy(sel).to(w.device)
    kd = torch.einsum("apkd,cqle,oide->acopqikl", s, s, w.float())
    return kd.reshape(r * r * cout, r * r * cin, 3, 3).to(w.dtype)


def phase_conv3x3_dense(p: torch.Tensor, w: torch.Tensor,
                        b: Optional[torch.Tensor] = None, r: int = 2) -> torch.Tensor:
    """Same math as :func:`phase_conv3x3` as one 3x3 conv with the merged
    kernel of :func:`dense_phase_kernel`: more structural zeros (36 vs 16
    tap-slots at r=2) and no crop."""
    return F.conv2d(p, dense_phase_kernel(w, r), phase_bias(b, r), padding=1)


def phase_shuffle_out(p: torch.Tensor, r: int = 2) -> torch.Tensor:
    """Materialize a phase-major tensor at full resolution:
    (B, Hg, Wg, r*r*C) -> (B, r*Hg, r*Wg, C)."""
    bsz, hg, wg, pc = p.shape
    c = pc // (r * r)
    t = p.reshape(bsz, hg, wg, r, r, c).permute(0, 1, 3, 2, 4, 5)
    return t.reshape(bsz, hg * r, wg * r, c)


def cmajor_to_phase_major(w: torch.Tensor, r: int = 2) -> torch.Tensor:
    """Reorder an OIHW kernel's OUTPUT channels from PixelShuffle c-major
    order (o*r^2 + a*r + c) to phase-major ((a*r + c)*cout + o).  A static
    permutation: exact."""
    n, cin, kh, kw = w.shape
    cout = n // (r * r)
    return w.reshape(cout, r * r, cin, kh, kw).transpose(0, 1).reshape(n, cin, kh, kw)


def phase_bias(b: Optional[torch.Tensor], r: int = 2) -> Optional[torch.Tensor]:
    """Per-channel bias replicated across phases (phase-major layout)."""
    if b is None:
        return None
    return b.repeat(r * r)


def cmajor_bias_to_phase_major(b: Optional[torch.Tensor], r: int = 2):
    """Reorder an r^2*cout bias from PixelShuffle c-major order to
    phase-major (pixelshuffle upsample convs, whose checkpoint bias is
    already per (channel, phase))."""
    if b is None:
        return None
    n = b.shape[0]
    return b.reshape(n // (r * r), r * r).t().reshape(-1)
