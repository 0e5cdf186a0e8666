#!/usr/bin/env python3
"""Time the port's fused_rdb kernel at the main-path shape, for A/B runs.

    python3 scripts/time_fused_rdb.py <checkout root> <label>

Imports innfer_tpu_torch from the checkout at <checkout root> (building its
kernel there on first use) and prints one line: the ms per call of
fused_rdb on (1, 1088, 1920, 64) bf16, nf=64, gc=32, over three windows of
five launches (CUDA events, after one warm-up call), with the card's name,
power limit, SM clock and power draw.  To compare two trees, unpack the
other one (git archive) into a git-ignored directory and run both in one
call on one card, in turns: a, b, b, a.
"""
import math
import subprocess
import sys

sys.path.insert(0, sys.argv[1])

import torch  # noqa: E402

from innfer_tpu_torch.ops.rdb import fused_rdb, pack_rdb  # noqa: E402

NF, GC = 64, 32


def main() -> None:
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(4)
    ws = [(torch.randn(GC if c < 4 else NF, NF + c * GC, 3, 3, generator=g)
           / math.sqrt(9 * (NF + c * GC))).to(dev, torch.bfloat16) for c in range(5)]
    bs = [(torch.randn(GC if c < 4 else NF, generator=g) * 0.02).to(dev) for c in range(5)]
    x = torch.randn(1, 1088, 1920, NF, generator=torch.Generator().manual_seed(5)).to(
        dev, torch.bfloat16)
    packed = pack_rdb(ws, bs, None, torch.bfloat16)
    fn = lambda: fused_rdb(x, ws, bs, packed=packed)  # noqa: E731
    fn()
    torch.cuda.synchronize()
    res = []
    for _ in range(3):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(5):
            fn()
        e1.record()
        torch.cuda.synchronize()
        res.append(e0.elapsed_time(e1) / 5)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,power.draw",
         "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    print(f"{sys.argv[2]}: fused_rdb ms per call over 3 windows of 5: "
          f"{', '.join(f'{r:.2f}' for r in res)}; {smi}", flush=True)


if __name__ == "__main__":
    main()
