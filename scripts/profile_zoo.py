#!/usr/bin/env python3
"""Where the device time of a zoo image goes, on the card.

    python3 scripts/profile_zoo.py [--family srresnet pan ppon pix2pix wbc wbc_tf]
        [--size 1080x1920] [--dtype bf16|fp32] [--top 8]

For each family, a seeded synthetic state dict at the width and depth
``chip_smoke.py`` `[zoo]` and `[i2i]` use (SRResNet nf=64 nb=16, PAN
nf=40 unf=24 nb=16, PPON nf=64 nb=24, all 4x and auto-detected with
tile_mode="auto"; the pix2pix unet_256 ngf=64 with its preset, so the
image is linear-resized to multiples of 256 first; WBC nf=32, pt or tf,
with its preset and the guided filter), loaded through InferenceSession.
One seeded image of --size runs once to warm up, then once under
torch.profiler.  Prints per family: the host
ms of the profiled image (run_image, ending in a synchronize), the device
ms (the union of the CUDA kernels' intervals), the device's idle share of
the host time, and the --top kernels by device time with their launches
and share.  The card's name and power limit lead the output.
"""
import argparse
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def busy_us(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, None
    for a, b in sorted(intervals):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--family", nargs="+", default=["srresnet", "pan", "ppon"],
                    choices=["srresnet", "pan", "ppon", "pix2pix", "wbc", "wbc_tf"])
    ap.add_argument("--size", default="1080x1920")
    ap.add_argument("--dtype", choices=("bf16", "fp32"), default="bf16")
    ap.add_argument("--top", type=int, default=8)
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs
    from innfer_tpu_torch.pipeline import InferenceSession

    if not torch.cuda.is_available():
        sys.exit("needs an NVIDIA GPU")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    h, w = (int(v) for v in args.size.split("x"))
    img = cs.synth_image(h, w, seed=11)
    # family -> (state dict maker, checkpoint name, session arguments)
    make = {"srresnet": (cs.synth_srresnet_state, "4x_srresnet.pth", {}),
            "pan": (cs.synth_pan_state, "4x_pan.pth", {}),
            "ppon": (cs.synth_ppon_state, "4x_ppon.pth", {}),
            "pix2pix": (cs.synth_unet_state, "p2p_unet256.pth", {"arch": "unet_256"}),
            "wbc": (cs.synth_wbc_state, "wbc_synth.pth", {}),
            "wbc_tf": (cs.synth_wbc_state, "wbc_tf_synth.pth", {})}
    dtype = torch.bfloat16 if args.dtype == "bf16" else torch.float32
    with tempfile.TemporaryDirectory() as work, torch.no_grad():
        for i, family in enumerate(args.family):
            fn, name, kw = make[family]
            ckpt = os.path.join(work, name)
            torch.save(fn(torch, seed=50 + i), ckpt)
            sess = InferenceSession(ckpt, compute_dtype=dtype, tile_mode="auto", **kw)
            sess.run_image(img)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                sess.run_image(img)
                torch.cuda.synchronize()
                host_ms = (time.perf_counter() - t0) * 1e3
            kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
            dev_ms = busy_us([(e.time_range.start, e.time_range.end) for e in kernels]) / 1e3
            by_name = {}
            for e in kernels:
                t, n = by_name.get(e.name, (0.0, 0))
                by_name[e.name] = (t + e.time_range.elapsed_us() / 1e3, n + 1)
            total = sum(t for t, _ in by_name.values())
            runner = sess.stages[0].runner
            mode = runner.last_mode if runner is not None else "whole image"
            print(f"[{family}] {args.size} {args.dtype}, mode {mode}: "
                  f"host {host_ms:.1f} ms, device {dev_ms:.1f} ms, idle "
                  f"{100 * (1 - dev_ms / host_ms):.1f}%, {len(kernels)} kernel launches",
                  flush=True)
            for name, (t, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:args.top]:
                print(f"  {t:9.2f} ms {100 * t / total:5.1f}% x{n:<5d} {name[:110]}", flush=True)


if __name__ == "__main__":
    main()
