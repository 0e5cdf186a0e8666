"""Command-line entry point of the PyTorch/CUDA port.

    python -m innfer_tpu_torch.cli -m 4x_model.pth [-a infer] [-i ./input]
        [-o ./output] [-s N] [-cpu] [-no_fp16] [--tile N] [--overlap N]
        [--tile-mode auto|uniform|hybrid|none] [--tile-batch N]

``-a infer`` (the default) detects ESRGAN/ESRGAN+/mESRGAN, SRResNet/SRGAN,
PAN and PPON state dicts and TorchScript archives; ``-a`` also takes an
architecture alias (esrgan, esrgan-lite, mesrgan, srgan, srresnet, pan,
ppon, resnet_6blocks, resnet_9blocks, ...) with library defaults, and
``-a ts`` a TorchScript archive, which runs in fp32.  Runs on the CUDA
device (bf16 compute) and raises with no card unless ``-cpu`` is given;
``-cpu`` and ``-no_fp16`` compute in fp32.  The flags are the JAX CLI's
(innfer_tpu/cli.py) that this slice of the port supports.
"""
from __future__ import annotations

import argparse
import sys

import torch


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="innfer-tpu-torch", description=__doc__)
    p.add_argument("-models", "-m", type=str, required=True, help="Path to the model.")
    p.add_argument("-arch", "-a", type=str, default="infer",
                   help="Model architecture: infer (auto-detect), ts (TorchScript) "
                   "or an alias such as esrgan, srgan, pan, ppon, resnet_9blocks.")
    p.add_argument("-input", "-i", type=str, default="./input", help="Path to read input images.")
    p.add_argument("-output", "-o", type=str, default="./output", help="Path to save output images.")
    p.add_argument("-scale", "-s", type=int, default=None, help="Model scaling factor.")
    p.add_argument("-cpu", dest="cpu", action="store_true", help="Run on the CPU.")
    p.add_argument("-no_fp16", dest="no_lowp", action="store_true",
                   help="Disable bf16 compute (use fp32).")
    p.add_argument("--tile", type=int, default=256, help="Tile size (input pixels).")
    p.add_argument("--overlap", type=int, default=16, help="Tile overlap (input pixels).")
    p.add_argument("--tile-mode", choices=["auto", "uniform", "hybrid", "none"],
                   default="auto", help="Tiling strategy; 'auto' grid-fits the "
                   "tiles and, on the card, runs the trunk on the whole image "
                   "(hybrid); 'uniform' uses the fixed --tile grid; 'none' "
                   "forces whole-image forwards.")
    p.add_argument("--tile-batch", type=int, default=8, help="Tiles per forward.")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from innfer_tpu_torch.pipeline import InferenceSession, select_presets

    presets = select_presets(args.arch, args.models)
    if args.tile_mode == "none":
        presets.chop = False
    session = InferenceSession(
        args.models,
        arch=args.arch,
        presets=presets,
        compute_dtype=torch.float32 if (args.no_lowp or args.cpu) else torch.bfloat16,
        tile=args.tile,
        overlap=args.overlap,
        tile_mode=args.tile_mode if args.tile_mode != "none" else "uniform",
        tile_batch=args.tile_batch,
        scale=args.scale,
        device="cpu" if args.cpu else None,
    )
    session.process(args.input, args.output)
    return 0


if __name__ == "__main__":
    sys.exit(main())
