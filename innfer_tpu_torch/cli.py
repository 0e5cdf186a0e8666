"""Command-line entry point of the PyTorch/CUDA port.

    python -m innfer_tpu_torch.cli -m 4x_model.pth [-a infer] [-i ./input]
        [-o ./output] [-s N] [-cf] [-comp] [-cpu] [-no_fp16] [-norm]
        [--models-dir DIR] [--tile N] [--overlap N]
        [--tile-mode auto|uniform|hybrid|none] [--tile-batch N]

``-m`` takes one model or a chain joined with ``+`` or ``>``, run one
stage after another.  ``-a infer`` (the default) detects ESRGAN/ESRGAN+/
mESRGAN, SRResNet/SRGAN, PAN, PPON and WBC state dicts and TorchScript
archives; ``-a`` also takes an architecture alias with library defaults
(esrgan, esrgan-lite, mesrgan, srgan, srresnet, pan, ppon, resnet_6blocks,
resnet_9blocks, unet_128, unet_256, p2p_128, p2p_256, wbcunet, wbcunet_tf,
...), and ``-a ts`` a TorchScript archive, which runs in fp32.  A model
name holding "wbc" selects the WBC preset (modcrop, guided filter).  Runs
on the CUDA device (bf16 compute) and raises with no card unless ``-cpu``
is given; ``-cpu`` and ``-no_fp16`` compute in fp32.  The flags are the
JAX CLI's (innfer_tpu/cli.py) that this slice of the port supports.
"""
from __future__ import annotations

import argparse
import sys

import torch


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="innfer-tpu-torch", description=__doc__)
    p.add_argument("-models", "-m", type=str, required=True,
                   help="Path to models (chain with + or >).")
    p.add_argument("-arch", "-a", type=str, default="infer",
                   help="Model architecture: infer (auto-detect), ts (TorchScript) "
                   "or an alias such as esrgan, srgan, pan, ppon, resnet_9blocks, "
                   "unet_128, unet_256, p2p_256, wbcunet, wbcunet_tf.")
    p.add_argument("-input", "-i", type=str, default="./input", help="Path to read input images.")
    p.add_argument("-output", "-o", type=str, default="./output", help="Path to save output images.")
    p.add_argument("-scale", "-s", type=int, default=None, help="Model scaling factor.")
    p.add_argument("-cf", action="store_true", help="Use color correction if enabled.")
    p.add_argument("-comp", action="store_true", help="Save as comparison images if enabled.")
    p.add_argument("-cpu", dest="cpu", action="store_true", help="Run on the CPU.")
    p.add_argument("-no_fp16", dest="no_lowp", action="store_true",
                   help="Disable bf16 compute (use fp32).")
    p.add_argument("-norm", action="store_true", help="Normalize images to [-1,1].")
    p.add_argument("--models-dir", type=str, default="./models",
                   help="Directory searched for partial model names.")
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

    presets = select_presets(args.arch, args.models, norm_flag=args.norm)
    if args.tile_mode == "none":
        presets.chop = False
    session = InferenceSession(
        args.models,
        arch=args.arch,
        models_dir=args.models_dir,
        presets=presets,
        compute_dtype=torch.float32 if (args.no_lowp or args.cpu) else torch.bfloat16,
        tile=args.tile,
        overlap=args.overlap,
        tile_mode=args.tile_mode if args.tile_mode != "none" else "uniform",
        tile_batch=args.tile_batch,
        scale=args.scale,
        device="cpu" if args.cpu else None,
    )
    session.process(args.input, args.output, use_color_fix=args.cf, comp=args.comp)
    return 0


if __name__ == "__main__":
    sys.exit(main())
