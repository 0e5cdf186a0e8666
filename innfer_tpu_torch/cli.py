"""Command-line entry point of the PyTorch/CUDA port.

    python -m innfer_tpu_torch.cli -m 4x_model.pth [-a infer] [-i ./input]
        [-o ./output] [-s N] [-cf] [-comp] [-cpu] [-no_fp16] [-norm]
        [--models-dir DIR] [--tile N] [--overlap N]
        [--tile-mode auto|uniform|reference|hybrid|none] [--tile-batch N]
        [--batch N] [--fused-chain] [--timing] [--profile DIR]
        [--metrics DIR] [--shard-index I --num-shards N]
        [--dp N] [--tp N] [--spatial]
        [--coordinator HOST:PORT --num-processes N --process-id R]

``-m`` takes one model or a chain joined with ``+`` or ``>``, run one
stage after another (``--fused-chain``: one tile pass through every
stage).  ``-a infer`` (the default) detects ESRGAN/ESRGAN+/mESRGAN,
SRResNet/SRGAN, PAN, PPON, SwinIR (real-world x4), HAT and WBC state dicts and
TorchScript archives; ``-a`` also takes an architecture alias with library
defaults (esrgan, esrgan-lite, mesrgan, srgan, srresnet, pan, ppon, swinir, hat,
resnet_6blocks, resnet_9blocks, unet_128, unet_256, p2p_128, p2p_256,
wbcunet, wbcunet_tf, ...), and ``-a ts`` a TorchScript archive, which runs
in fp32.  A model name holding "wbc" selects the WBC preset (modcrop,
guided filter).
``--batch`` stacks same-shape images into one forward; its default, 0,
sizes the groups by the memory budget for the pix2pix, CycleGAN and WBC
presets and runs other families one image at a time.  Runs on the CUDA
device (bf16 compute) and raises with no card unless ``-cpu`` is given;
``-cpu`` and ``-no_fp16`` compute in fp32.

``--dp N`` splits the tile groups (and whole-image stacks) over N local
devices, ``--tp N`` shards conv output channels over N, and ``--spatial``
runs each image's forward H-sharded over the ``--dp`` devices with halo
exchange (``parallel/``).  ``--coordinator``/``--num-processes``/
``--process-id`` join a multi-process run (torch.distributed, gloo over
TCP); ``--shard-index``/``--num-shards`` default to its rank and world
size, so each process writes its own stripe of the directory.

The flags are the JAX CLI's (innfer_tpu/cli.py) less ``--bucket``, which
pads XLA compile shapes, which eager PyTorch does not have.
"""
from __future__ import annotations

import argparse
import sys

import torch


def resolve_batch(batch: int, presets, spatial: bool = False) -> int:
    """``--batch 0`` (auto): the image-to-image families (pix2pix,
    CycleGAN, WBC) take groups sized by ``InferenceSession.auto_batch``
    (0); every other family runs one image at a time (1) unless the user
    asks.  ``--spatial`` asks for an execution strategy that batching
    would bypass, so it runs one image at a time and refuses an explicit
    batch.  The JAX package's rule (innfer_tpu/cli.py:22-49)."""
    if spatial:
        if batch > 1:
            raise SystemExit(
                "--batch and --spatial are incompatible: batched groups "
                "run stacked forwards, bypassing the H-sharded spatial "
                "runner you asked for")
        return 1
    if batch:
        return batch
    return 0 if presets.family in ("pix2pix", "cyclegan", "wbc") else 1


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="innfer-tpu-torch", description=__doc__)
    p.add_argument("-models", "-m", type=str, required=True,
                   help="Path to models (chain with + or >).")
    p.add_argument("-arch", "-a", type=str, default="infer",
                   help="Model architecture: infer (auto-detect), ts (TorchScript) "
                   "or an alias such as esrgan, srgan, pan, ppon, swinir, hat, resnet_9blocks, "
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
    p.add_argument("--tile-mode", choices=["auto", "uniform", "reference", "hybrid", "none"],
                   default="auto", help="Tiling strategy; 'auto' grid-fits the "
                   "tiles and, on the card, runs the trunk on the whole image "
                   "(hybrid); 'uniform' uses the fixed --tile grid; 'reference' "
                   "matches the original chop grid (200 px patches, step 0.5); "
                   "'none' forces whole-image forwards.")
    p.add_argument("--tile-batch", type=int, default=8, help="Tiles per forward.")
    p.add_argument("--batch", type=int, default=0,
                   help="Group N same-shape images into one stacked forward: "
                   "whole-image where the stack fits the memory budget, else "
                   "their tiles share dispatch groups (tiled presets), else "
                   "one by one.  0 = auto: groups of up to INNFER_MAX_BATCH "
                   "(32) sized by the budget for the pix2pix, CycleGAN and "
                   "WBC presets, 1 otherwise.")
    p.add_argument("--fused-chain", action="store_true",
                   help="Run a model chain as one tile pass through every "
                   "stage (intermediate images never materialize); outputs "
                   "may differ near tile borders within the chain's "
                   "receptive field.  Opt-in; the default runs the stages "
                   "one after another.")
    p.add_argument("--no-fused-chain", action="store_true",
                   help="Deprecated no-op: the sequential path is the default.")
    p.add_argument("--profile", type=str, default="",
                   help="Write a torch.profiler Chrome trace, with the program's spans, "
                        "to this directory and log the spans' and counters' summary.")
    p.add_argument("--timing", action="store_true",
                   help="Log per-stage wall-clock timings.")
    p.add_argument("--metrics", type=str, default="",
                   help="Ground-truth dir: compute PSNR/SSIM per output.")
    p.add_argument("--shard-index", type=int, default=None,
                   help="This process's shard of the image list (defaults to "
                   "its rank in a multi-process run, else 0).")
    p.add_argument("--num-shards", type=int, default=None,
                   help="Processes striping the image list (defaults to the "
                   "multi-process run's world size, else 1).")
    p.add_argument("--dp", type=int, default=0,
                   help="Data-parallel: split the tile groups over this many "
                   "local devices (-1 = all devices not used by --tp; 0 or 1 "
                   "= no mesh).")
    p.add_argument("--tp", type=int, default=1,
                   help="Tensor-parallel: shard conv output channels over "
                   "this many devices.")
    p.add_argument("--spatial", action="store_true",
                   help="Whole-image forwards H-sharded over the --dp devices "
                   "(halo-exchange convs) instead of tiling; for images too "
                   "large to tile-batch.  Not combinable with --tp.")
    p.add_argument("--coordinator", type=str, default=None,
                   help="Multi-process rendezvous address, host:port "
                   "(torch.distributed, gloo over TCP).")
    p.add_argument("--num-processes", type=int, default=None,
                   help="Processes of the multi-process run.")
    p.add_argument("--process-id", type=int, default=None,
                   help="This process's rank in the multi-process run.")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from innfer_tpu_torch.parallel.multihost import init_distributed, shutdown_distributed

    # join the processes first: their rank and world size set the stripes
    rank, world = init_distributed(args.coordinator, args.num_processes, args.process_id)
    try:
        return _run(args, rank, world)
    finally:
        shutdown_distributed()


def _run(args, rank: int, world: int) -> int:
    from innfer_tpu_torch.observability import TRACER, StageTimers, profile_trace
    from innfer_tpu_torch.parallel.mesh import local_devices, make_mesh
    from innfer_tpu_torch.pipeline import InferenceSession, select_presets

    shard_index = rank if args.shard_index is None else args.shard_index
    num_shards = world if args.num_shards is None else args.num_shards
    mesh = None
    if args.dp not in (0, 1) or args.tp > 1:
        # --dp 0/1 means no data parallelism (a 1-wide data axis); only the
        # explicit -1 asks for every device not used by --tp
        n_data = None if args.dp == -1 else max(1, args.dp)
        mesh = make_mesh(n_data=n_data, n_model=args.tp,
                         devices=local_devices("cpu" if args.cpu else "cuda"))
    if args.spatial and mesh is None:
        raise SystemExit("--spatial requires a device mesh; add --dp N")

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
        fused_chain=args.fused_chain,
        mesh=mesh,
        spatial=args.spatial,
    )
    timers = StageTimers() if args.timing else None
    with profile_trace(args.profile):
        session.process(args.input, args.output, use_color_fix=args.cf, comp=args.comp,
                        shard_index=shard_index, num_shards=num_shards,
                        metrics_dir=args.metrics or None, timers=timers,
                        batch=resolve_batch(args.batch, presets, spatial=args.spatial))
    if timers is not None:
        timers.log_report()
    if args.profile:
        TRACER.log_summary()
    return 0


if __name__ == "__main__":
    sys.exit(main())
