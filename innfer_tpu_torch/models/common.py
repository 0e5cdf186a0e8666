"""Shared pieces of the flattened-sequential SR skeleton of RRDBNet,
SRResNet and PPON (the port's counterpart of ``innfer_tpu/models/common.py``):
positional indices, the upsample block, the JAX package's two exact tail
rewrites (the LR-collapsed upconv, :func:`collapse_upconv_weight`, and the
phase-space tail, :func:`apply_phase_tail` over ``nn/phase.py``),
reference-semantics conv blocks (mode CNA | NAC | CNAC, batch/instance
norm, act, pad) and the output cap.

The three models run their tails through :func:`sr_tail`.  Which tail
form runs is decided by two predicates, :func:`upconv_collapse_ok`
and :func:`phase_tail_ok`, from an A/B on the H100 (``chip_smoke.py``
``[tail]``), which adopted the JAX package's form: collapsed upconv
blocks and the phase tail.  Each form stays callable, and tests force
each by monkeypatching the predicates.  The rewrites' weights are derived
once per parameter dict and dtype and kept in ``ParamDict.cache``.

The tail's 2x convs (the upsample block's, the phase tail's first conv,
its HR conv and conv_last) run on the hand-written bf16 conv of
``ops/tail_conv.py`` wherever ``tail_conv.fusable`` holds (a bf16 CUDA
tensor, an unsharded 3x3 weight, an activation of None, LeakyReLU or ReLU,
channel counts the kernel takes): its epilogue adds the fp32 bias, rounds
once, applies the activation in bf16 and writes the next op's layout.
Elsewhere the plain composition below runs (the CPU, fp32, tp-sharded
weights, tanh or sigmoid).  The tracer's counters ``tail_convs`` (every
conv of the tail) and ``tail_convs_fused`` (those on the kernel) say which.
"""
from __future__ import annotations

import math
from typing import List, Optional, Tuple

import torch

from innfer_tpu_torch.models.base import cached
from innfer_tpu_torch.nn import functional as F
from innfer_tpu_torch.nn import phase as PH
from innfer_tpu_torch.nn import resize as R
from innfer_tpu_torch.observability import count
from innfer_tpu_torch.ops import tail_conv as TC

Params = dict


def n_upscale_blocks(upscale: int) -> Tuple[int, int]:
    """Number of upsample blocks and the per-block factor: 2^k scales use
    k blocks of 2x, scale 3 one 3x block, scale 1 none."""
    if upscale == 3:
        return 1, 3
    if upscale == 1:
        return 0, 2
    return int(math.log2(upscale)), 2


def upsample_indices(upscale: int, mode: str, start: int = 2) -> Tuple[List[int], int]:
    """Positional indices of the conv inside each upsample block, plus the
    index of the first HR conv, in the flattened Sequential layout:
    upconv block = [Upsample, Conv, Act]; pixelshuffle = [Conv, PS, Act]."""
    n_up, _factor = n_upscale_blocks(upscale)
    conv_idxs = []
    i = start
    for _ in range(n_up):
        conv_idxs.append(i + 1 if mode == "upconv" else i)
        i += 3
    return conv_idxs, i


def conv3x3(params: Params, x: torch.Tensor, key: str) -> torch.Tensor:
    return F.conv2d(x, params[f"{key}.weight"], params.get(f"{key}.bias"), padding=1)


def apply_hr_convs(params: Params, h: torch.Tensor, prefix: str, hr0: int, act_type,
                   act_key: str = "") -> torch.Tensor:
    """A materialized tail's HR conv ``prefix.hr0``, its act (parameters
    at ``act_key``) and conv_last ``prefix.hr0+2``: two tail convs at HR
    resolution, counted, on the plain composition."""
    count("tail_convs", 2)
    h = F.act(act_type, conv3x3(params, h, f"{prefix}.{hr0}"), params=params, key=act_key)
    return conv3x3(params, h, f"{prefix}.{hr0 + 2}")


def _fused(params: Params, x: torch.Tensor, key: str, act, *, mode: str, pack,
           layout: str, ok: bool = True) -> Optional[torch.Tensor]:
    """Count one tail conv; where the caller's form allows it (``ok``) and
    ``tail_conv.fusable`` holds for ``mode``, run it on the kernel (its
    packed weights ``pack(weight)`` kept per ParamDict) with ``act`` fused,
    in ``layout``; None where the caller runs the plain composition."""
    count("tail_convs", 1)
    if not (ok and TC.fusable(x, params.get(f"{key}.weight"), act, mode=mode)):
        return None
    count("tail_convs_fused", 1)
    return TC.tail_conv(x, derived(params, f"tail_{mode}", key, pack), act=act,
                        layout=layout)


def derived(params: Params, tag: str, key: str, build):
    """``build(weight)`` for the weight ``key + ".weight"``, :func:`cached`
    per (tag, key, the weight's dtype and device): a cast (a new ParamDict)
    builds its own."""
    w = params[f"{key}.weight"]
    return cached(params, (tag, key, w.dtype, w.device), lambda: build(w))


def collapse_upconv_weight(w: torch.Tensor, b: Optional[torch.Tensor], factor: int):
    """Rewrite a nearest-up(x r) + 3x3/pad-1 conv as an LR conv + shuffle.

    The upsampled image is piecewise constant, so each HR output phase
    (a, b) in [0, r)^2 reads only LR offsets {-1, 0, +1}: tap dp of the 3x3
    kernel lands on LR offset floor((a+dp)/r), and per phase the HR taps
    collapse (sum) onto a 3x3 LR kernel.  The block is then exactly
    ``PixelShuffle(conv2d(x, w', b', padding=1), r)``, with w' of shape
    (cout*r*r, cin, 3, 3) in PixelShuffle channel order o*r*r + a*r + b and
    b' = repeat(b, r*r); HR zero padding maps to LR zero padding bit for
    bit.  As ``innfer_tpu/models/common.py:52-96``: the taps are pre-summed
    in fp32 and rounded once to the weight's dtype, which in bf16 is a
    rounding the HR conv does not have."""
    r = factor
    cout, cin, kh, kw = w.shape
    assert kh == 3 and kw == 3, (kh, kw)
    # sel[a, P, t]: HR tap t (dp = t-1) of phase a lands on LR offset P-1
    sel = torch.zeros(r, 3, 3)
    for a in range(r):
        for t, dp in enumerate((-1, 0, 1)):
            sel[a, (-1 if a + dp < 0 else (1 if a + dp >= r else 0)) + 1, t] = 1.0
    sel = sel.to(w.device)
    w2 = torch.einsum("apd,bqe,oide->oabipq", sel, sel, w.float())
    w2 = w2.reshape(cout * r * r, cin, 3, 3).to(w.dtype)
    return w2, None if b is None else b.repeat_interleave(r * r)


def upconv_collapse_ok(params: Params, key: str, *, factor: int) -> bool:
    """Whether an upconv block runs LR-collapsed (:func:`collapse_upconv_weight`):
    every 3x3 upconv block with a factor above 1, on every device.

    Adopted from an A/B on the card (``chip_smoke.py`` ``[tail]``: the
    main path's 1080x1920 tail through the session's hybrid tile groups,
    bf16, NVIDIA H100 80GB HBM3 at its 700.00 W power limit): collapsed
    blocks with the materialized HR tail 113.96 ms against 129.37 ms for
    the plain tail (medians of 6 reps, spreads 0.45 and 0.50 ms); the same
    FLOPs without the nearest-up materializations.  Tests force the plain
    block by patching this predicate."""
    w = params.get(f"{key}.weight")
    return factor > 1 and w is not None and w.dim() == 4 and tuple(w.shape[2:]) == (3, 3)


def apply_upsample_block(params: Params, x: torch.Tensor, key: str, *,
                         mode: str, factor: int, act_type: str,
                         act_key: str = "") -> torch.Tensor:
    """One upsample block (upconv: nearest-resize + conv + act, reference
    block.py:348-361, LR-collapsed where :func:`upconv_collapse_ok` says;
    pixelshuffle: conv + shuffle + act, block.py:333-346).  ``act_key`` is
    the act submodule's prefix, for prelu/swish parameters.  At factor 2
    a fused conv writes the shuffled output with the act applied."""
    collapsed = mode == "upconv" and upconv_collapse_ok(params, key, factor=factor)
    y = _fused(params, x, key, act_type, mode=mode, layout="shuffle",
               ok=factor == 2 and (collapsed or mode == "pixelshuffle"),
               pack=lambda w: TC.pack_plain(*_phase_major_block(params, key, mode, w)))
    if y is not None:
        return y
    if collapsed:
        w2 = derived(params, "collapse", key, lambda w: collapse_upconv_weight(w, None, factor)[0])
        b = params.get(f"{key}.bias")
        b2 = None if b is None else b.repeat_interleave(factor * factor)
        x = F.pixel_shuffle(F.conv2d(x, w2, b2, padding=1), factor)
    elif mode == "upconv":
        x = conv3x3(params, R.upsample_nearest(x, factor), key)
    elif mode == "pixelshuffle":
        x = F.pixel_shuffle(conv3x3(params, x, key), factor)
    else:
        raise NotImplementedError(f"upsample mode [{mode}] is not found")
    return F.act(act_type, x, params=params, key=act_key)


def _phase_major_block(params: Params, key: str, mode: str, w: torch.Tensor):
    """A factor-2 upsample block's LR conv (LR-collapsed for upconv) with its
    output channels, and the bias, in phase-major order."""
    b = params.get(f"{key}.bias")
    if mode == "upconv":
        return PH.cmajor_to_phase_major(collapse_upconv_weight(w, None, 2)[0]), PH.phase_bias(b)
    return PH.cmajor_to_phase_major(w), PH.cmajor_bias_to_phase_major(b)


_PHASE_SAFE_ACTS = (None, "relu", "leakyrelu", "lrelu", "tanh", "sigmoid")


def phase_tail_ok(params: Params, up_key: str, *, factor: int, up_mode: str,
                  act_type, finalact) -> bool:
    """Whether the tail (last upsample block + HR convs) runs in phase
    space (:func:`apply_phase_tail`): per-block factor 2, a 3x3 last-block
    conv and parameter-free activations (a per-channel prelu or swish
    would need re-plumbing into the phase-major layout), on every device.

    Adopted from the same A/B as :func:`upconv_collapse_ok` (NVIDIA H100
    80GB HBM3, 700.00 W): collapsed blocks + the phase tail 107.17 ms per
    1080x1920 tail (spread 0.63 ms) against 113.96 ms collapsed with the
    materialized HR tail, 116.57 ms with the dense phase conv and 129.37
    ms plain, for 7.61 against 5.62 TFLOP: no 64-channel HR pixel shuffle,
    and one merged 256-channel conv per HR conv (``nn/phase.py``).  Tests
    force the materialized tail by patching this predicate."""
    if factor != 2 or up_mode not in ("upconv", "pixelshuffle"):
        return False
    if act_type not in _PHASE_SAFE_ACTS or finalact not in _PHASE_SAFE_ACTS:
        return False
    w = params.get(f"{up_key}.weight")
    return w is not None and w.dim() == 4 and tuple(w.shape[2:]) == (3, 3)


def phase_hr_conv(params: Params, p: torch.Tensor, key: str, r: int = 2,
                  act=None) -> torch.Tensor:
    """One HR 3x3 conv of the tail in phase space, then ``act``: on the
    kernel at the HR conv's own operations where it is fusable, else the
    merged per-phase kernels (``nn/phase.merge_phase_kernels``), built once
    per ParamDict."""
    y = _fused(params, p, key, act, mode="phase", layout="phase", ok=r == 2,
               pack=lambda w: TC.pack_phase(w, params.get(f"{key}.bias")))
    if y is not None:
        return y
    merged, offsets = derived(params, "phase", key,
                              lambda w: PH.merge_phase_kernels(PH.phase_kernels(w, r), r))
    return F.act(act, PH.conv_phases(p, merged, offsets, params.get(f"{key}.bias"), r))


def apply_phase_tail(params: Params, h: torch.Tensor, *, up_key: str, up_mode: str,
                     act_type, hr0: int, finalact, out_prefix: str = "model",
                     hr_conv: bool = True) -> torch.Tensor:
    """The SR tail -- last upsample block, act, HR conv, act, conv_last,
    optional finalact -- evaluated in phase space on the half-resolution
    grid, with one final 3-channel depth-to-space
    (``innfer_tpu/models/common.py:154-191``).  The same taps as the
    materialized tail, summed in another order; no HR-resolution
    activation of nf channels is ever shuffled.  Without ``hr_conv``
    (HAT's pixelshuffle tail) conv_last, at ``hr0``, follows the last
    upsample block."""
    r = 2
    p = _fused(params, h, up_key, act_type, mode=up_mode, layout="phase",
               pack=lambda w: TC.pack_plain(*_phase_major_block(params, up_key, up_mode, w)))
    if p is None:
        b = params.get(f"{up_key}.bias")
        if up_mode == "upconv":
            w2 = derived(params, "phase_upconv", up_key, lambda w: PH.cmajor_to_phase_major(
                collapse_upconv_weight(w, None, r)[0], r))
            p = F.conv2d(h, w2, PH.phase_bias(b, r), padding=1)
        else:  # pixelshuffle: the conv's channels are already per phase
            w2 = derived(params, "phase_shuffle", up_key, lambda w: PH.cmajor_to_phase_major(w, r))
            p = F.conv2d(h, w2, PH.cmajor_bias_to_phase_major(b, r), padding=1)
        p = F.act(act_type, p)
    if hr_conv:
        p = phase_hr_conv(params, p, f"{out_prefix}.{hr0}", r, act=act_type)
        hr0 += 2
    p = phase_hr_conv(params, p, f"{out_prefix}.{hr0}", r, act=finalact)
    return PH.phase_shuffle_out(p, r)


def sr_tail(params: Params, h: torch.Tensor, prefix: str, *, upscale: int, up_mode: str,
            act_type, finalact, start: int = 2, hr_conv: bool = True) -> torch.Tensor:
    """The SR tail of the flattened-sequential skeleton, its modules at
    ``prefix.<i>`` from ``start`` on: the upsample blocks (LR-collapsed
    where :func:`upconv_collapse_ok` says), then either the last block and
    the HR convs in phase space (where :func:`phase_tail_ok` says) or the
    HR convs at full resolution, and ``finalact`` after them.  RRDBNet and
    SRResNet run it at ``model`` (start 2); PPON once per reconstruction
    branch (start 0, no finalact), each branch's phase predicate reading
    only its own last-block weight, so the three agree for every PPON
    state dict; SwinIR at ``tail`` (start 0).  HAT's pixelshuffle tail has
    no HR conv (``hr_conv`` False): conv_last, at the HR conv's position,
    follows the last upsample block, in phase space or at full resolution.
    The one seam of the five models' tails."""
    _n_up, factor = n_upscale_blocks(upscale)
    up_convs, hr0 = upsample_indices(upscale, up_mode, start=start)
    # the act submodule's flat index inside each upsample block:
    # upconv [Up, conv@ci, act@ci+1]; pixelshuffle [conv@ci, PS, act@ci+2]
    act_off = 1 if up_mode == "upconv" else 2
    phase = bool(up_convs) and phase_tail_ok(
        params, f"{prefix}.{up_convs[-1]}", factor=factor, up_mode=up_mode,
        act_type=act_type, finalact=finalact)
    for ci in (up_convs[:-1] if phase else up_convs):
        h = apply_upsample_block(params, h, f"{prefix}.{ci}", mode=up_mode, factor=factor,
                                 act_type=act_type, act_key=f"{prefix}.{ci + act_off}")
    if phase:
        return apply_phase_tail(params, h, up_key=f"{prefix}.{up_convs[-1]}", up_mode=up_mode,
                                act_type=act_type, hr0=hr0, finalact=finalact,
                                out_prefix=prefix, hr_conv=hr_conv)
    if hr_conv:
        h = apply_hr_convs(params, h, prefix, hr0, act_type, act_key=f"{prefix}.{hr0 + 1}")
    else:
        count("tail_convs", 1)
        h = conv3x3(params, h, f"{prefix}.{hr0}")
    if finalact:
        # the final act follows HR_conv1 in the flattened sequential
        # (RRDBNet_arch.py:45-48)
        h = F.act(finalact, h, params=params, key=f"{prefix}.{hr0 + 3}")
    return h


def warn_train_dropout(arch: str) -> None:
    """Loud note that deterministic inference diverges from the reference's
    stochastic train-mode dropout (block.py Dropout(0.5))."""
    import warnings

    warnings.warn(
        f"{arch} generator with use_dropout=True in train mode: the "
        "reference samples Dropout(0.5) stochastically; this framework "
        "is deterministic and treats dropout as identity, so outputs "
        "will differ from the reference's random draws")


def conv_block_layout(mode: str = "CNA", norm_type=None, act_type=None,
                      pad_type: str = "zero") -> List[str]:
    """Positional submodule kinds of a reference ``conv_block``
    (block.py:213-254): CNA/CNAC order [pad?, conv, norm?, act?], NAC order
    [norm?, act?, pad?, conv].  Zero padding is folded into the conv and
    'none' norm adds no module; parameterless modules still take an index."""
    mode = (mode or "CNA").upper()
    if mode not in ("CNA", "NAC", "CNAC"):
        raise NotImplementedError(f"Wrong conv mode [{mode}]")
    has_pad = pad_type not in (None, "zero")
    has_norm = norm_type not in (None, "none")
    has_act = act_type is not None
    if mode == "NAC":
        order = (("norm", has_norm), ("act", has_act), ("pad", has_pad), ("conv", True))
    else:
        order = (("pad", has_pad), ("conv", True), ("norm", has_norm), ("act", has_act))
    return [kind for kind, on in order if on]


def apply_conv_block(params: Params, x: torch.Tensor, key_of, *,
                     mode: str = "CNA", norm_type=None, act_type=None,
                     pad_type: str = "zero", padding: int = 1, stride: int = 1,
                     bn_training: bool = False, neg_slope: float = 0.2) -> torch.Tensor:
    """Apply one reference-semantics conv_block; ``key_of(i)`` maps the
    positional submodule index to its state-dict prefix."""
    for i, kind in enumerate(conv_block_layout(mode, norm_type, act_type, pad_type)):
        k = key_of(i)
        if kind == "pad":
            x = F.pad2d(x, padding, mode=pad_type)
        elif kind == "conv":
            pad = padding if pad_type in (None, "zero") else 0
            x = F.conv2d(x, params[f"{k}.weight"], params.get(f"{k}.bias"),
                         stride=stride, padding=pad)
        elif kind == "norm":
            nt = str(norm_type).lower()
            if nt == "batch":
                x = F.batch_norm(x, params[f"{k}.weight"], params[f"{k}.bias"],
                                 params.get(f"{k}.running_mean"),
                                 params.get(f"{k}.running_var"), training=bn_training)
            elif nt == "instance":
                x = F.instance_norm(x)
            else:
                raise NotImplementedError(f"normalization layer [{norm_type}] is not found")
        else:
            # NAC without norm recreates the act out of place (block.py:247-252),
            # the one inplace=False site
            inplace = not ((mode or "CNA").upper() == "NAC" and norm_type in (None, "none"))
            x = F.act(act_type, x, neg_slope=neg_slope, params=params, key=k,
                      inplace=inplace)
    return x


def _outm(x: torch.Tensor, outm) -> torch.Tensor:
    """Optional output cap (reference RRDBNet_arch.py:50-62):
    scaltanh | tanh | sigmoid | clamp | None."""
    if outm == "scaltanh":
        return (torch.tanh(x) + 1.0) / 2.0
    if outm == "tanh":
        return torch.tanh(x)
    if outm == "sigmoid":
        return torch.sigmoid(x)
    if outm == "clamp":
        return torch.clamp(x, 0.0, 1.0)
    return x
