"""Checkpoint conversion CLI: remap key layouts and convert dtypes.

    python -m innfer_tpu_torch.tools.convert in.pth out.pth [--remap PASS ...]
        [--dtype keep|fp32|fp16|bf16]

Passes (applied in order):
  swa          SWA AveragedModel unwrap        (utils/utils.py:701-720)
  mod2normal   mesrgan -> flattened esrgan     (utils/utils.py:666-698)
  normal2mod   flattened esrgan -> mesrgan     (utils/utils.py:629-663)

The port's counterpart of ``innfer_tpu/tools/convert.py``, with its flags,
pass order and closing line.  The checkpoint is read with
``torch.load(weights_only=True)`` (``checkpoint/detect.load_checkpoint``)
and written with ``torch.save``.  ``--dtype`` converts every floating
tensor, biases included.  Useful for normalizing model-database
checkpoints once instead of remapping at every load.
"""
from __future__ import annotations

import argparse
import sys

import torch

from innfer_tpu_torch.checkpoint.detect import load_checkpoint
from innfer_tpu_torch.checkpoint.remaps import mod_to_normal, normal_to_mod, swa_to_normal

PASSES = {"swa": swa_to_normal, "mod2normal": mod_to_normal, "normal2mod": normal_to_mod}
DTYPES = {"fp32": torch.float32, "fp16": torch.float16, "bf16": torch.bfloat16}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="innfer-tpu-torch-convert", description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("input")
    ap.add_argument("output")
    ap.add_argument("--remap", action="append", default=[], choices=list(PASSES),
                    help="Remap passes to apply, in order (repeatable).")
    ap.add_argument("--dtype", choices=["keep", *DTYPES], default="keep",
                    help="Convert floating tensors.")
    args = ap.parse_args(argv)

    state = load_checkpoint(args.input)
    for name in args.remap:
        state = PASSES[name](state)
    if args.dtype != "keep":
        target = DTYPES[args.dtype]
        state = {k: v.to(target) if torch.is_tensor(v) and v.is_floating_point() else v
                 for k, v in state.items()}
    torch.save(state, args.output)
    n = sum(v.numel() for v in state.values() if torch.is_tensor(v))
    print(f"{args.input} -> {args.output}: {len(state)} tensors, {n} params")
    return 0


if __name__ == "__main__":
    sys.exit(main())
