#!/usr/bin/env python3
"""Time one of the port's kernels at its main-path shape, for A/B runs.

    python3 scripts/time_fused_rdb.py <checkout root> <label> [--kernel rdb|resnet_block]

Imports innfer_tpu_torch from the checkout at <checkout root> (building its
kernel there on first use) and prints one line: the ms per call over three
windows of five launches (CUDA events, after one warm-up call), with the
card's name, power limit, SM clock and power draw.  Kernels and shapes:
  rdb           fused_rdb on (1, 1088, 1920, 64) bf16, nf=64, gc=32 (the
                ESRGAN 1080p trunk canvas);
  resnet_block  fused_resnet_block on (8, 138, 64, 256) bf16 with biases
                (a CycleGAN 1080p tile group).
Weights come from a fixed seed and are packed once, outside the windows.
With --profile it then prints, per CUDA kernel the call launches, its
device ms per call and launches per call from torch.profiler (five calls).
To compare two trees, unpack the other one (git archive) into a
git-ignored directory and run both in one call on one card, in turns:
a, b, b, a.
"""
import argparse
import math
import subprocess
import sys


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("root")
    ap.add_argument("label")
    ap.add_argument("--kernel", choices=("rdb", "resnet_block"), default="rdb")
    ap.add_argument("--profile", action="store_true")
    args = ap.parse_args()
    sys.path.insert(0, args.root)
    import torch

    dev, bf16 = torch.device("cuda"), torch.bfloat16
    g = torch.Generator().manual_seed(4)
    if args.kernel == "rdb":
        from innfer_tpu_torch.ops.rdb import fused_rdb, pack_rdb

        nf, gc = 64, 32
        ws = [(torch.randn(gc if c < 4 else nf, nf + c * gc, 3, 3, generator=g)
               / math.sqrt(9 * (nf + c * gc))).to(dev, bf16) for c in range(5)]
        bs = [(torch.randn(gc if c < 4 else nf, generator=g) * 0.02).to(dev) for c in range(5)]
        x = torch.randn(1, 1088, 1920, nf, generator=torch.Generator().manual_seed(5)).to(dev, bf16)
        packed = pack_rdb(ws, bs, None, bf16)
        fn = lambda: fused_rdb(x, ws, bs, packed=packed)  # noqa: E731
    else:
        from innfer_tpu_torch.ops.resnet_block import fused_resnet_block, pack_resnet_block

        c = 256
        w1, w2 = ((torch.randn(c, c, 3, 3, generator=g) * 0.02).to(dev, bf16) for _ in range(2))
        b1, b2 = ((torch.randn(c, generator=g) * 0.1).to(dev) for _ in range(2))
        x = torch.randn(8, 138, 64, c, generator=torch.Generator().manual_seed(5)).to(dev, bf16)
        packed = pack_resnet_block(w1, b1, w2, b2, bf16)
        fn = lambda: fused_resnet_block(x, w1, b1, w2, b2, packed=packed)  # noqa: E731
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
    name = "fused_rdb" if args.kernel == "rdb" else "fused_resnet_block"
    print(f"{args.label}: {name} ms per call over 3 windows of 5: "
          f"{', '.join(f'{r:.3f}' for r in res)}; {smi}", flush=True)
    if args.profile:
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                fn()
            torch.cuda.synchronize()
        for e in sorted(prof.key_averages(), key=lambda e: -e.device_time_total):
            if e.device_time_total > 0:
                print(f"{args.label}: {e.device_time_total / 5e3:.3f} ms, {e.count // 5} per "
                      f"call: {e.key[:100]}", flush=True)


if __name__ == "__main__":
    main()
