"""Plain PyTorch pieces shared by the references: the seeded weights, the
convolutions in the precision asked for, and the u8 conversions at either
end.  Imports nothing of the program."""
from __future__ import annotations

import contextlib
from typing import Callable, Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as TF

# e4m3's largest finite value: the control scales each tensor onto it
FP8_MAX = 448.0

Forward = Callable[[torch.Tensor], torch.Tensor]


@contextlib.contextmanager
def true_fp32():
    """fp32 convolutions and products without TF32."""
    old = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = old


def quantize(t: torch.Tensor, precision: str) -> torch.Tensor:
    """``t`` as the precision would hold it: unchanged for fp32; rounded to
    bf16 (the configuration's precision, whose rounding sets the scale of
    the comparison); for fp8, scaled per tensor onto e4m3's range, rounded
    to e4m3 and scaled back (the control: the step below bf16)."""
    if precision == "fp32":
        return t
    if precision == "bf16":
        return t.to(torch.bfloat16).float()
    if precision != "fp8":
        raise ValueError(f"unknown precision {precision!r}")
    s = FP8_MAX / t.abs().amax().clamp(min=1e-30)
    return (t * s).to(torch.float8_e4m3fn).float() / s


class Convs:
    """The convolutions of one forward, on a state dict, in ``precision``:
    operands (activations and weights) rounded as :func:`quantize` says,
    sums and biases in fp32."""

    def __init__(self, state: Dict[str, torch.Tensor], precision: str = "fp32"):
        self.state, self.precision = state, precision

    def _wb(self, key: str):
        return (quantize(self.state[f"{key}.weight"], self.precision),
                self.state.get(f"{key}.bias"))

    def conv(self, x: torch.Tensor, key: str, *, stride: int = 1, padding: int = 0):
        w, b = self._wb(key)
        return TF.conv2d(quantize(x, self.precision), w, b, stride=stride, padding=padding)

    def conv_t(self, x: torch.Tensor, key: str, *, stride: int = 2, padding: int = 1,
               output_padding: int = 1):
        w, b = self._wb(key)
        return TF.conv_transpose2d(quantize(x, self.precision), w, b, stride=stride,
                                   padding=padding, output_padding=output_padding)


def seeded_state(shapes: List[Tuple[str, Tuple[int, ...], float, float, int]], seed: int,
                 device) -> Dict[str, torch.Tensor]:
    """A state dict from ``seed``: for each (key, weight shape, weight std,
    bias mean, bias length) a normal weight of that std and a bias of that
    mean with a spread of 0.01, drawn on ``device`` in two calls."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    n_w = sum(int(np.prod(s[1])) for s in shapes)
    n_b = sum(s[4] for s in shapes)
    flat_w = torch.randn(n_w, generator=g, device=device)
    flat_b = torch.randn(n_b, generator=g, device=device)
    state, iw, ib = {}, 0, 0
    for key, shape, std, mean, nb in shapes:
        n = int(np.prod(shape))
        state[f"{key}.weight"] = flat_w[iw:iw + n].view(shape) * std
        state[f"{key}.bias"] = flat_b[ib:ib + nb] * 0.01 + mean
        iw, ib = iw + n, ib + nb
    return state


def probe(seed: int, device, size: int = 128) -> torch.Tensor:
    """A seeded (1, 3, size, size) image in [0, 1] for setting the scale of
    a network's last conv: smooth structure, stripes and noise of 12 levels,
    as the traffic's images have."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) + 1)
    yy = torch.arange(size, device=device, dtype=torch.float32)[:, None]
    xx = torch.arange(size, device=device, dtype=torch.float32)[None, :]
    base = 127 + 90 * torch.sin(xx / 37.0) * torch.cos(yy / 23.0) + 20 * torch.sin(xx / 11.0)
    x = base + 12 * torch.randn((1, 3, size, size), generator=g, device=device)
    return x.clamp(0, 255) / 255


def calibrate_last(state: Dict[str, torch.Tensor], key: str, forward: Forward, x: torch.Tensor,
                   mean: float, std: float) -> None:
    """Scale and bias the conv ``key`` (the network's last) so that its
    output over ``x`` has ``mean`` and ``std`` in each channel: the seeded
    network then gives an image, not a flat field or a clipped one, from
    every seed alike."""
    state[f"{key}.bias"] = torch.zeros_like(state[f"{key}.bias"])
    with torch.no_grad(), true_fp32():
        z = forward(x)
    m, s = z.mean(dim=(0, 2, 3)), z.std(dim=(0, 2, 3)).clamp(min=1e-6)
    w = state[f"{key}.weight"]
    state[f"{key}.weight"] = w * (std / s).view(-1, *([1] * (w.dim() - 1)))
    state[f"{key}.bias"] = mean - m * std / s


def to_input(rgb: np.ndarray, device) -> torch.Tensor:
    """(H, W, 3) u8 RGB -> (1, 3, H, W) fp32 in [0, 1]."""
    return torch.from_numpy(np.ascontiguousarray(rgb)).to(device).permute(2, 0, 1)[None].float() / 255.0


def to_u8(y: torch.Tensor) -> np.ndarray:
    """(1, 3, H, W) in [0, 1] -> (H, W, 3) u8, rounded half to even."""
    return torch.round(torch.clamp(255.0 * y[0], 0, 255)).to(torch.uint8).permute(1, 2, 0).cpu().numpy()


