"""Device resolution for the port's entry points.

The port runs on the CUDA device by default.  With no card an entry point
raises unless the caller asked for the CPU explicitly: nothing falls back
to the CPU by itself, so a run that was meant for the card can never
silently measure or produce CPU results.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means the CUDA device; ``"cpu"`` must be asked for."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' (CLI: -cpu) "
            "to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def set_cudnn_deterministic() -> None:
    """cuDNN picks deterministic algorithms only, as the reference asks
    (run.py:337).  Without it, cuDNN may pick an algorithm whose sums run
    in another order on each call: on the H100, pix2pix's u8 outputs (bf16
    and fp32) and CycleGAN's (fp32) came out one level apart between two
    passes over the same images.

    The reference's other flag, ``benchmark`` (run.py:336), stays off for
    the process: on the H100 its autotuning made a fresh session's first
    fp32 SRResNet image at 1080p take 39.2 s instead of about 1 s, and it
    picks other algorithms for tp shards' convs than for whole ones.  Only
    the transposed convs, whose deterministic heuristic pick is slow, are
    autotuned (``nn/functional.conv_transpose2d``)."""
    torch.backends.cudnn.deterministic = True
