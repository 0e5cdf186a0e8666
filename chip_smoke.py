#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (innfer_tpu_torch) through its paths on one
NVIDIA GPU, and hold each of its CUDA kernels against the kernel's plain
version.

    python3 chip_smoke.py

Phases, each printing its lines (any failure exits non-zero, and without
the final result line):
  1. device   the card's name, the device count and nvidia-smi's name and
              power limit; the image codec the port uses (its native
              codec, PNG on zlib and JPEG on libjpeg where built in;
              OpenCV or its stdlib PNG codec) and whether cv2 and rawpy
              import, with their versions; whether the native host
              runtime (runtime/native.py) built with g++ on this machine
              from the checkout's sources, its version() (zlib's version
              and the formats), its build time, and otherwise why not;
              and whether zlib.h and jpeglib.h are on g++'s include path.
              It fails where g++ and zlib.h are present and the library
              still does not build or load;
  2. build    the five kernel libraries (ops/csrc/rdb.cu, tail_conv.cu
              and dilated_block.cu with ops/csrc/conv3x3_tma.cuh,
              resnet_block.cu, all with the shared ops/csrc/conv3x3_tc.cuh;
              instance_norm.cu, no conv)
              built at once with nvcc (sm_90a); for each, ptxas' registers
              and spills of every tensor-core conv instantiation (rdb's
              conv_tma, resnet_block's conv_wgmma, one per N tile,
              tail_conv's conv_tail, one per N tile and mode,
              dilated_block's dilated_block_c1 and dilated_block_rates) with
              its dynamic shared memory, and the counts of HGMMA (wgmma)
              and UTMALDG (TMA tensor load) instructions in the library's
              SASS (cuobjdump): HGMMA must be above 0 in all but
              instance_norm's, UTMALDG in all but resnet_block's and
              instance_norm's, and no TMA conv may spill (but the
              16 B of tail_conv's HR conv, TMA_SPILL_B);
  3. kernel   fused_rdb against rdb_reference at nf=64, gc=32 on
              (1, 64, 1920, 64) strips, bf16 and fp32, with and without the
              ESRGAN+ plus; then timed with CUDA events at the main-path
              shape (1, 1088, 1920, 64) bf16 beside its bound, the plain
              version and the cuDNN conv chain (the library yardstick,
              which the port never calls), with the achieved TFLOP/s and
              the share of the bound; then each of its five conv
              launches' device ms (torch.profiler, three calls) beside the
              conv's floor (scripts/time_fused_rdb.py's): the larger of its
              operations at 989 TFLOP/s and the workspace bytes it reads
              and writes at 3.35 TB/s.  Then tail_conv
              (ops/tail_conv.py) at the four convs of the main-path
              cell's tail group (4 tiles of 576x256 LR pixels, nf=64: the
              upsample block written pixel-shuffled, the phase tail's
              first conv written phase-major, the HR conv and conv_last on
              the phase-major grid), each within one bf16 ulp of its plain
              composition (at least 97% equal), timed beside its bound,
              the plain composition and cuDNN's bf16 conv alone.  Then
              [dilated]: fused_dilated_block (ops/dilated_block.py, PPON's
              _ResBlock_32, nf=64) at the PPON cell's trunk shape (1, 576,
              960, 64), plain and with the RRBlock's residual, within one
              bf16 ulp of the model's plain bf16 path (at least 99.9%
              equal), timed beside its bound, that plain path and cuDNN's
              bf16 convs of the block alone, with each of its three
              launches' device ms (torch.profiler), TFLOP/s and share of
              its own bound (its operations, or the bytes it reads and
              writes), the rates kernel's registers and spill, and the
              bytes it stages into shared memory a call;
  4. main     a seeded synthetic 4x ESRGAN (nb=23, nf=64, gc=32, upconv)
              saved with torch.save, and seeded 540x960 and 1080x1920
              PNGs, run through InferenceSession.process in bf16 with
              tile_mode="auto" (auto-detection, auto -> hybrid): exactly
              69 fused_rdb launches per image and 4 tail_conv launches per
              tail group, and no other, 4x PNGs read back, and the
              same images inside ops.plain_path at >= 40 dB, with the
              kernel run's tiling asked for (tile_mode="hybrid": a trunk
              of plain ops keeps the auto grid);
  5. tail     the A/B of the JAX package's exact tail rewrites on the main
              path's 1080x1920 image: its trunk once, then the session's
              own runner (hybrid_apply's tile groups) runs the tail in four
              forms, forced through models/common.py's predicates, on the
              plain composition (no port kernel): (a) the plain
              materialized tail, (b) LR-collapsed upconv blocks, (c)
              collapsed blocks + the phase tail (the JAX default), (d) (c)
              with the dense phase conv; and (k), (c) as the session runs
              it, on tail_conv (4 launches per tile group); CUDA events in
              turns a b c d k k d c b a, three times; each form's median
              ms, spread, FLOPs and PSNR against (a) (bf16 at 1080p >= 35
              dB, fp32 on a crop of the trunk output >= 80 dB).  A form is
              adopted only if its median beats (a) by more than the spread
              of its own reps; the fastest adopted form must be the one the
              predicates encode, and (k) must beat it likewise.
              Then the per-phase HR conv at one tail group's shape: the
              package's merged conv, the JAX split with a TF.pad per phase,
              and one pad with views;
  6. chain    at the main-path shape (1, 1088, 1920, 64) bf16: one
              fused_rdb_padded call (with the RRDB residual) against its
              plain version; the nb=23 fused_rrdb_trunk (69 chain-mode
              launches) against its plain version (PSNR >= 40 dB, peak
              max|ref|: the synthetic trunk grows to |x| ~ 300, where one
              bf16 ulp is 2) and against 23 RRDBs of per-RDB fused_rdb plus
              the residual (equal to the last bit: the same conv code and
              the same rounding steps); both timed beside their bounds, the
              plain versions and cuDNN, with TFLOP/s and share of the bound;
              then the main path's images again
              through InferenceSession with INNFER_RDB_CHAIN=1: 69
              fused_rdb_padded launches per image, none of fused_rdb, and
              >= 40 dB against the main path's PNGs;
  7. resnet_block  fused_resnet_block against resnet_block_reference at
              the CycleGAN path's shape (8, 138, 64, 256) and on a ragged
              slab (3, 37, 29, 256), bf16 and fp32, with and without bias
              (fp32: max-abs 1e-4; bf16: PSNR >= 55 dB and every value
              within 2^-7 (|ref| + |ref - x| + 1), one bf16 ulp of the sum,
              of h2 and of IN's unit scale); then timed beside its bound,
              the plain version and cuDNN convs + F.instance_norm, with
              TFLOP/s and share of the bound; and at the batched path's
              shapes (8, 128, 128, 256) and (32, 66, 36, 256), bf16,
              against the plain version, timed beside the bound;
     Then [instance_norm]: fused_instance_norm (ops/instance_norm.py) at
              the CycleGAN cell's three norm shapes (a group of 8 tiles of
              552x256 at 64, 128 and 256 channels) on a bias-shifted fp32
              accumulator, within one bf16 ulp of its plain composition and
              at least 99.9% equal, timed beside its byte bound, the plain
              composition and F.instance_norm + torch.relu on bf16;
  8. cyclegan a seeded synthetic CycleGAN resnet_9blocks (ngf=64) state
              dict with legacy InstanceNorm running-stat keys, and seeded
              512x512 and 1080x1920 PNGs, through InferenceSession with the
              cyclegan preset (non-strict load, [-1, 1]) in bf16,
              tile_mode="auto": 9 fused_resnet_block and 5
              fused_instance_norm launches per tile group, 1x PNGs, >= 40 dB against ops.plain_path, and fp32
              kernel path vs torch path >= 80 dB on a small input;
     Then [window_attn]: window_attn (ops/window_attn.py) at the SwinIR
              cell's canvas (1, 544, 960), 6 heads of 30, shifted and not:
              >= 99.9% equal to its plain version, all within two bf16
              ulps, over both shifts at least as often equal to the float64
              version as the plain version; timed beside its byte bound,
              the plain version and scaled_dot_product_attention on
              pre-partitioned windows (a yardstick); its registers and
              spills; fused_layer_norm (ops/layer_norm.py) at the cell's
              tokens beside its bound and F.layer_norm; [token_gemm]:
              token_linear (ops/token_gemm.py) as a Swin layer runs proj
              and fc2 with the residual and fc1 with GELU at the cell's
              544x960 tokens, >= 99.9% equal to its plain version and
              within one ulp of y plus one of the result, timed beside its
              byte bound, the plain composition and torch.addmm + add or
              GELU (a yardstick); and [swinir]: SwinIR-M x4 at its
              published widths (the benchmark's seeded weights) through
              InferenceSession with arch infer on a 540x960 frame: hybrid
              on 544x960, 36 window_attn, 74 fused_layer_norm, 108
              token_linear and 4 tail conv launches a frame, >= 40 dB
              against ops.plain_path; [hat_attn]: hat_window_attn (shifts 0
              and 8) and overlap_attn (ops/hat_attn.py) at the HAT cell's
              canvas, 6 heads of 30: >= 99.8% equal to the plain versions,
              all within two bf16 ulps, >= 99.7% equal to the float64
              versions; timed beside the byte bound, the plain versions and
              scaled_dot_product_attention on windows cut beforehand (a
              yardstick); and [hat]: Real-HAT-GAN x4 at its published
              widths (the benchmark's seeded weights) through
              InferenceSession with arch infer on a 540x960 frame: hybrid
              on 544x960, 36 hat_window_attn, 6 overlap_attn, 86
              fused_layer_norm, 126 token_linear and 3 tail conv launches a
              frame, >= 40 dB against ops.plain_path;
  9. zoo      seeded synthetic SRResNet 4x (nf=64, nb=16, pixelshuffle,
              relu, CNA), PAN 4x (nf=40, unf=24, nb=16, self-attention)
              and PPON 4x (nf=64, nb=24) state dicts, the reference
              defaults, through InferenceSession.process with
              auto-detection, tile_mode="auto", on the main path's PNGs:
              the runner's mode (SRResNet must not go hybrid), ms per
              image between CUDA events, wall, u8 PSNR of bf16 against the
              fp32 session (>= 30 dB) and fp32 on the card against fp32
              on the CPU on a 64x64 crop (>= 80 dB); in bf16 tail_conv
              launches a multiple of one forward's (SRResNet's 4: its 2x
              upsample block and phase tail; PPON's 12, that in each of
              its three branches; none for PAN), fused_dilated_block
              launches a multiple of PPON's 84 a forward (its auto run
              goes hybrid), and no other kernel runs, none in fp32;
              for PAN the auto plan's tile and the attention scores' bytes
              per tile group.  Then the ESRGAN variants (batch norm CNA and
              NAC, instance norm, prelu, swish; nf=64, gc=32, nb=2) fp32
              card vs CPU at >= 80 dB with 0 fused_rdb launches; an
              instance-norm ESRGAN's runner in auto mode stays on the tile
              grid, while the main path's leakyrelu ESRGAN went hybrid;
 10. ts       a TorchScript archive traced from a 4x SRResNet nn.Module
              (nf=64, nb=16) defined here, through InferenceSession with
              arch "ts" on the card: probed scale 4, the tiled output
              against the eager module's whole-image fp32 forward >= 40
              dB (u8), the whole-image stage >= 80 dB, ms per image;
 11. i2i      the image-to-image families, whole image, bf16 and fp32, no
              kernel launched: a seeded synthetic pix2pix unet_256 (ngf=64,
              batch norm with running stats and num_batches_tracked,
              deconv) through InferenceSession(arch="unet_256") with the
              pix2pix preset (linear_resize to multiples of 256, train-mode
              BN, [-1, 1]) on the main path's PNGs and a 256x256 one; WBC
              nf=32 checkpoints named wbc_*.pth (pt) and wbc_tf_*.pth (tf)
              through the wbc preset (modcrop, the guided filter) on the
              main path's PNGs; a wbc+wbc chain at 540x960 (two stages, a
              guided filter after each); -cf on the [zoo] SRResNet at
              540x960 against color_fix on the CPU of [zoo]'s PNG (u8
              within 1 level in >= 99.9%).  Each session processes its
              images twice and prints both passes' ms per image (the
              first carries cuDNN's set-up of new shapes).  Bars: bf16 vs fp32 u8 >= 30
              dB, fp32 card vs CPU >= 80 dB (64x64 crop; UNet 256x256).
              Then guided_filter, color_fix and linear_resize alone, card
              vs CPU: fp32 >= 80 dB, u8 within 1 level in >= 99.9%, with
              their times;
 12. batch    the batched directory path at full width, bf16, each
              directory processed twice (both passes' wall ms per image
              and CUDA-event ms per image of the forwards are printed,
              with the second pass's StageTimers per image):
              pix2pix unet_256 on 16 seeded 256x256 PNGs and 4 of 540x960
              (resized to 768x1024) with the CLI's default batch (auto:
              the groups auto_batch chose are printed) against batch=1,
              u8 within one level in 100% of values (train-mode batch norm
              is per image), and 64 of 256x256 in groups of 16
              (INNFER_MAX_BATCH=16) the same way; WBC nf=32 on 8 PNGs of 540x960 the same way
              (the guided filter batched); CycleGAN resnet_9blocks ngf=64
              on 8 PNGs of 512x512 with the default batch, one
              whole-image stack (9 fused_resnet_block launches at
              (8,128,128,256)), against the images one at a time whole
              image (a chop=False session): bf16 >= 40 dB (cuDNN's convs
              and PyTorch's reductions sum a stack in another order than
              one image, and instance norm carries a bf16 flip on), fp32
              within one level in 100%; against batch=1's tiled runs
              (another computation: per-tile instance norm; printed);
              the stage's TiledRunner on the 8-image stack (64 tiles in
              groups of 32: 18 launches against 72) against the
              per-image tiled runs, the same bars (each line names the
              image codec, on which the walls depend); then the CLI with --metrics against the pix2pix
              batch=1 outputs (PSNR >= 48.1 dB on every row, the PSNR of
              every value one level off, or inf), --timing, and --profile
              (a Chrome trace file must exist);
 13. evsrgan  a seeded synthetic 4x evsrgan (RRDBNet with Conv3d, nb=23,
              nf=64, gc=32, leakyrelu) saved with torch.save, through
              load_model -> model.apply on a clip of 5 frames of 270x480 in
              bf16 and fp32: ms between CUDA events and TFLOP/s, bf16 vs
              fp32 >= 30 dB, fp32 card vs CPU on a (1,3,16,16,3) clip at
              full depth >= 80 dB, 0 kernel launches, and
              InferenceSession refusing it with the Conv3D ValueError;
 14. convert  a seeded synthetic 4x mESRGAN (nb=23) checkpoint in the
              RRDB_trunk.* layout converted by innfer_tpu_torch.tools.convert
              --remap mod2normal, then the main path's 540x960 PNG through
              InferenceSession from both files in bf16: identical u8
              outputs, 69 fused_rdb launches each;
 15. codec    the native host codec against OpenCV on seeded synthetic
              images, each timing the median of 5 in turns after one warm
              call each: decode of a 1080x1920 PNG, native and
              read_img(use_native=False), both arrays equal to the image
              written; a 1080x1920 JPEG (quality 95), natively only where
              libjpeg is built in (else a line says JPEG goes through
              OpenCV on this host); encode of the main path's 4320x7680
              output, native (UP filter, Z_RLE, level 1) and cv2.imwrite,
              ms and MB, each file read back through both decoders to the
              array written.  It fails where g++ and zlib.h are present
              and the library still did not build; where one is missing
              it says so and times OpenCV alone;
 16. stages   after an untimed warm-up pass (the session's first forwards
              pack the kernel's weights), the main path's two ESRGAN
              images, then the same two three times over, through
              process with StageTimers,
              INNFER_ENCODE_THREADS=2 and then 0, each with the native
              codec and then with OpenCV (native.get_lib patched to None
              for the run), in turns: each stage's total,
              count and mean (read, image, fetch, encode; "image" times
              the host's enqueue, within it the forward's enqueue and the
              pinned copy's start apart; "fetch" waits for the card), the
              wall, 69 fused_rdb launches per image; then one 4320x7680
              output encoded alone through io.images.save_img, with the
              codec's name, and through cv2.imwrite;
 17. parallel the device mesh on the one card, on virtual meshes that
              repeat cuda:0 (each halo copy and per-device slice of the
              real path runs; times are the mesh code's overhead on one
              card, not scaling): (a) make_mesh(n_data=2) raises on a
              one-card machine (its message printed), make_mesh() is 1x1
              of cuda:0; (b) halo_conv2d on 4 shards at (1,1088,1920,64)
              -> 64 against F.conv2d, fp32 max-abs <= 1e-4 x max|ref|,
              bf16 >= 40 dB, both timed; (c) the main path's ESRGAN
              through build_spatial_apply on 4 shards against its
              whole-image forward with the plain tail forced (the form the
              spatial path computes): bf16 1080x1920 u8 >= 40 dB, fp32
              540x960 >= 80 dB, ms between CUDA events, 0 kernel
              launches; [zoo]'s SRResNet through SpatialRunner on 8 shards
              of 540x960 (padded to 544 rows) in fp32, the exact output
              shape and >= 80 dB on rows away from the padding; (d) the
              main path's PNGs through InferenceSession(spatial=True) on 4
              shards, >= 40 dB against (c)'s whole-image outputs, and PAN
              refused with the JAX package's reason; (e) dp tiles: the
              main path's session on 2 data slices, tile_mode="auto"
              (which stays on the tile grid), on the 540x960 PNG: 69
              fused_rdb and 4 tail_conv launches per slice run, u8
              against a mesh-free
              TiledRunner on the same plan >= 40 dB and >= 99.9% within
              one level; fp32 on a 64x64 crop max-abs <= 1e-5 against a
              mesh-free runner whose groups have the slices' composition
              (which isolates the mesh code) and <= 5e-4 against one at
              the same tile_batch (cuDNN's fp32 convs are not
              batch-invariant; about 10x the 4.58e-05 the H100 showed);
              ms against the mesh-free runner; (f) tp
              on (2 data x 2 model): 69
              launches per slice on gathered weights, >= 40 dB against
              (e), fp32 whole model on the crop max-abs <= 1e-5 against
              replicated params; (g) run_batch on 2 data slices against no
              mesh: pix2pix unet_256 on 8 of [batch]'s 256x256 PNGs (100%
              within one level) and CycleGAN on its 8 of 512x512 (9
              fused_resnet_block launches per slice of (4,128,128,256);
              bf16 >= 40 dB, fp32 100% within one level);
 18. multiproc two CLI processes (innfer_tpu_torch.cli run as __main__)
              share cuda:0, joined with --coordinator 127.0.0.1:<free
              port> --num-processes 2 --process-id r over gloo, on 4
              seeded 540x960 PNGs through the main path's checkpoint: each
              writes only its stripe, and their union equals a
              single-process CLI run (bar 100% within one level); each
              process's wall and fused_rdb launches (69 per image);
 19. determinism  C4: a pix2pix unet_256 (ngf=64) on a batch of 8 seeded
              256x256 images and a CycleGAN resnet_9blocks (ngf=64) on a
              512x512 one, [i2i]'s and [cyclegan]'s checkpoints, bf16 and
              fp32: two passes on one session and one on a second session
              (their upsampling runs F.conv_transpose2d, a cuDNN
              backward-data conv); each pair's share of equal u8 values
              and largest difference; any difference fails;
 20. bench    bench_torch.py's ten configs (bench.py's) at their defaults
              with --iters 3 (INNFER_E2E_IMGS=2: two 1080x1920 PNGs per
              _e2e pass), through bench_torch.main: each prints its
              JSON line (output MP/s at the median, set-up, launches per
              step, fidelity against its bar, which exits 1 on a miss);
              launches per step 69 fused_rdb for esrgan, 138 for chain, 69
              per image for esrgan_e2e, fused_resnet_block in nines for
              cyclegan, none elsewhere;
 21. result   the kernels line (each kernel also with "tflops", its
              achieved rate, and "bound_share", bound_ms / ms), the card
              line and, last,
              {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Each path (main, chain, cyclegan, zoo, ts, i2i, batch, evsrgan, convert,
stages, each of parallel's and multiproc's, and each bench config's timed
window) runs with
every kernel's launch count set to 0 just before it and read just after;
launches made to compare a kernel with its plain version are not counted.
"""
from __future__ import annotations

import contextlib
import ctypes
import io
import json
import math
from concurrent.futures import ThreadPoolExecutor
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
PEAK_BF16 = 989e12      # H100 SXM dense bf16 tensor rate, FLOP/s
HBM_BPS = 3.35e12       # H100 SXM HBM3, bytes/s
NF, GC = 64, 32
BF16_TOL, FP32_TOL = 0.05, 1e-4   # max-abs bars for kernel vs plain
MIN_PSNR_DB = 40.0                # kernel path vs torch path, u8 outputs
RB_PSNR_DB = 55.0                 # bf16 fused_resnet_block vs its plain version
NB = 23                           # RRDBs of the main-path ESRGAN
CG_BLOCKS, CG_NGF = 9, 64         # CycleGAN resnet_9blocks at its published width
CG_NORMS = 5                      # its instance norms outside the blocks, a forward
ZOO_BF16_DB, ZOO_FP32_DB = 30.0, 80.0   # bf16 vs fp32 session (u8); fp32 card vs CPU
LIBS = ("rdb", "resnet_block", "tail_conv", "dilated_block", "instance_norm", "window_attn",
        "layer_norm", "token_gemm", "hat_attn")
# no tensor-core conv: no HGMMA or UTMALDG to count (window_attn's and
# hat_attn's products run on mma.sync)
NO_CONV_LIBS = ("instance_norm", "window_attn", "layer_norm", "hat_attn")
# Spill bytes a TMA conv instantiation may have: none, but for tail_conv's
# HR conv (N=256 a phase-major tile of 1 row), whose 16 B were there when
# it was first measured on the H100; more fails the build phase.
TMA_SPILL_B = {"conv_tail N=256 cpad=64 phase": 16}
DILATED_SHAPE = (1, 576, 960, 64)   # the PPON cell's hybrid trunk canvas, nf 64
# the CycleGAN cell's norm shapes, a group of 8 tiles of 552x256: the head
# and the last up (64 channels), the downs' and ups' 128, the last down's 256
IN_SHAPES = ((8, 552, 256, 64), (8, 276, 128, 128), (8, 138, 64, 256))
# the SwinIR cell's trunk canvas (540 x 960 reflected to the window's
# multiple): 6 heads of 30, tokens of 180 channels
SWIN_CANVAS, SWIN_HEADS, SWIN_HD = (1, 544, 960), 6, 30
SWIN_FRAME = (540, 960)
# a Swin layer's linears on the token GEMM: (K in, N, epilogue); K is read
# 184 wide where the LayerNorm or the attention pads 180 channels
TOKEN_SITES = {"proj": (180, 180, "residual"), "fc1": (180, 360, "gelu"),
               "fc2": (360, 180, "residual")}
# the HAT cell's canvas is SwinIR's (544 x 960, 6 heads of 30); its
# attentions: the HAB's window attention (16 x 16, shifted by 0 and 8) and
# the OCA (16 x 16 queries against 24 x 24 keys)
HAT_SITES = {"sa0": dict(window=16, shift=0), "sa8": dict(window=16, shift=8),
             "oca": dict(window=16, kwin=24)}


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def psnr(a, b, peak: float) -> float:
    import numpy as np

    mse = float(np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2))
    return math.inf if mse == 0 else 10 * math.log10(peak ** 2 / mse)


def cuda_ms(fn, reps: int, warm: bool = True) -> float:
    import torch

    if warm:
        fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def rdb_params(torch, dev, dtype, plus, seed):
    g = torch.Generator().manual_seed(seed)
    ws, bs = [], []
    for c in range(5):
        cin, cout = NF + c * GC, (GC if c < 4 else NF)
        ws.append((torch.randn(cout, cin, 3, 3, generator=g) / math.sqrt(9 * cin)).to(dev, dtype))
        bs.append((torch.randn(cout, generator=g) * 0.02).to(dev))
    w1 = (torch.randn(GC, NF, 1, 1, generator=g) / 8).to(dev, dtype) if plus else None
    return ws, bs, w1


def rdb_work(b, h, w, dtype_bytes, plus):
    """Operations and bytes one RDB call needs: each input read once and
    each output written once."""
    macs_px = 9 * sum((NF + c * GC) * (GC if c < 4 else NF) for c in range(5))
    if plus:
        macs_px += NF * GC
    px = b * h * w
    weights = sum(9 * (NF + c * GC) * (GC if c < 4 else NF) for c in range(5))
    nbytes = 2 * px * NF * dtype_bytes + weights * dtype_bytes + (4 * GC + NF) * 4
    return 2 * macs_px * px, nbytes


def cudnn_chain(torch, x, ws, bs):
    """The library yardstick: the same RDB as five cuDNN convs on
    channels-last bf16 (cat, bias, LReLU, 0.2 residual)."""
    F = torch.nn.functional
    feats = [x.permute(0, 3, 1, 2)]
    for c in range(4):
        feats.append(F.leaky_relu(F.conv2d(torch.cat(feats, 1), ws[c], bs[c].to(x.dtype),
                                           padding=1), 0.2))
    out = F.conv2d(torch.cat(feats, 1), ws[4], bs[4].to(x.dtype), padding=1)
    return out * 0.2 + feats[0]


def synth_esrgan_state(torch, seed, nb=23, nf=NF, gc=GC):
    """A seeded random-init 4x ESRGAN state dict in the reference's
    flattened key layout (OIHW), as a checkpoint holds it.  Uniform init
    with variance 1/fan_in keeps the signal's scale through the 23 blocks
    and the tail, so the output is an image rather than a constant."""
    g = torch.Generator().manual_seed(seed)
    state = {}

    def conv(key, o, i, k=3):
        std = math.sqrt(3.0 / (i * k * k))
        state[f"{key}.weight"] = (torch.rand(o, i, k, k, generator=g) * 2 - 1) * std
        state[f"{key}.bias"] = (torch.rand(o, generator=g) * 2 - 1) * 0.01

    conv("model.0", nf, 3)
    for i in range(nb):
        for j in (1, 2, 3):
            for c in range(1, 6):
                conv(f"model.1.sub.{i}.RDB{j}.conv{c}.0", gc if c < 5 else nf, nf + (c - 1) * gc)
    conv(f"model.1.sub.{nb}", nf, nf)
    conv("model.3", nf, nf)
    conv("model.6", nf, nf)
    conv("model.8", nf, nf)
    conv("model.10", 3, nf)
    return state


def synth_image(h, w, seed):
    import numpy as np

    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    chans = [128 + 70 * np.sin(xx / (23 + 9 * k) + k) * np.cos(yy / (31 + 7 * k))
             for k in range(3)]
    img = np.stack(chans, -1) + rng.normal(0, 10, (h, w, 3))
    return np.clip(img, 0, 255).astype(np.uint8)


def phase_device():
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs an NVIDIA GPU")
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    from innfer_tpu_torch.io import images as iio

    libs = []
    for mod in ("cv2", "rawpy"):
        try:
            m = __import__(mod)
            libs.append(f"{mod} {getattr(m, '__version__', '(no version)')}")
        except ImportError:
            libs.append(f"{mod} does not import")
    from innfer_tpu_torch.runtime import native

    t0 = time.perf_counter()
    built = native.available()
    built_s = time.perf_counter() - t0
    missing = native.missing_headers()
    print(f"[device] {kind}; device count {count}; nvidia-smi: {smi}; "
          f"torch {torch.__version__} cuda {torch.version.cuda}; image codec "
          f"{iio.codec_name()}; {', '.join(libs)}", flush=True)
    print(f"[device] native host codec: "
          + (f"built and loaded in {built_s:.2f} s ({native.version()}; "
             f"{os.path.relpath(native.library_path(), HERE)})" if built else
             f"did not build: {native.unavailable_reason()}")
          + "; on g++'s include path: " + ", ".join(
              f"{h} {'no' if h in missing else 'yes'}" for h in native.HEADERS), flush=True)
    if not built and shutil.which(native.CXX) and not set(native.REQUIRED) & set(missing):
        fail(f"g++ and {', '.join(native.REQUIRED)} are here, yet the native host codec "
             f"did not build or load: {native.unavailable_reason()}")
    return kind, count, smi


def ptxas_kernels(report: str) -> dict:
    """Per kernel in nvcc's -Xptxas -v report: registers, spill-store bytes
    and static shared memory."""
    out, func = {}, None
    for line in report.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            func = m.group(1)
            out[func] = {"regs": 0, "spill": 0, "smem": 0}
            continue
        if func is None:
            continue
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            out[func]["spill"] = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[func]["regs"] = int(m.group(1))
            m = re.search(r"(\d+) bytes smem", line)
            out[func]["smem"] = int(m.group(1)) if m else 0
    return out


def sass_count(path: str, opcode: str) -> int:
    """How many instructions of ``opcode`` the library's SASS holds."""
    from innfer_tpu_torch.ops import _build

    tool = os.path.join(os.path.dirname(_build.nvcc_path()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", path], capture_output=True, text=True,
                          check=True).stdout
    return len(re.findall(rf"\b{opcode}\b", sass))


def conv_lines(lib, kernels: dict) -> tuple:
    """Per tensor-core conv instantiation of a library's ptxas report
    (conv_tma for rdb, conv_wgmma for resnet_block, conv_tail for
    tail_conv, dilated_block_c1 and _rates for dilated_block): its registers, spill
    bytes and dynamic shared memory; and the other kernels.  The TMA convs'
    spills past TMA_SPILL_B are summed."""
    lines, spills, others = [], 0, []
    for func, k in kernels.items():
        m = re.search(r"conv_(tma|wgmma)ILi(\d+)E", func)
        t = re.search(r"conv_tailILi(\d+)ELi(\d+)ELb([01])E", func)
        d = re.search(r"dilated_block_(c1|rates)", func)
        if d:
            kind = "dilated"
            smem = lib.innfer_dilated_block_smem_bytes(0 if d.group(1) == "c1" else 8)
            label = f"dilated_block_{d.group(1)}"
        elif m:
            kind, nt = m.group(1), int(m.group(2))
            smem = (lib.innfer_conv_tma_smem_bytes if kind == "tma"
                    else lib.innfer_conv_tc_smem_bytes)(nt)
            label = f"conv_{kind} N={nt}"
        elif t:
            kind, nt, ph = "tail", int(t.group(1)), t.group(3) == "1"
            # the entry point's column count: mode PH's NT, or plain mode's 4 cpad
            smem = lib.innfer_tail_conv_smem_bytes(nt if ph else 4 * int(t.group(2)), int(ph))
            label = f"conv_tail N={nt} cpad={t.group(2)} {'phase' if ph else 'plain'}"
        else:
            others.append(k)
            continue
        lines.append((label, f"{label}: {k['regs']} regs, {k['spill']} B spilled, "
                             f"{smem} B dynamic smem"))
        if kind in ("tma", "tail", "dilated"):
            spills += max(0, k["spill"] - TMA_SPILL_B.get(label, 0))
    return [t for _, t in sorted(lines)], spills, others


def phase_build() -> dict:
    """Build the libraries at once and report each; returns each built
    library's ptxas report per kernel (``ptxas_kernels``)."""
    from innfer_tpu_torch.ops import _build

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(LIBS)) as pool:  # one nvcc per source, at once
        built = dict(zip(LIBS, pool.map(_build.build, LIBS)))
    reports = {}
    for name, b in built.items():
        where = os.path.relpath(b.path, HERE)
        hgmma = sass_count(b.path, "HGMMA")
        utmaldg = sass_count(b.path, "UTMALDG")
        counts = f"HGMMA in SASS: {hgmma}, UTMALDG: {utmaldg}"
        if not b.ptxas:
            print(f"[build] {where} was already built; {counts}", flush=True)
        else:
            reports[name] = ptxas_kernels(b.ptxas)
            lines, spills, others = conv_lines(_build.library(name), reports[name])
            rest = (f"registers {min(k['regs'] for k in others)}-"
                    f"{max(k['regs'] for k in others)}, spills "
                    f"{sum(k['spill'] for k in others)} B" if others else "")
            print(f"[build] {where}: nvcc {b.seconds:.1f} s; tensor-core convs: "
                  f"{'; '.join(lines)}; other kernels: {len(others)}{', ' if rest else ''}"
                  f"{rest}; {counts}", flush=True)
            if spills:
                fail(f"{where}: the TMA convs spill {spills} B of registers past "
                     f"TMA_SPILL_B")
            if name == "token_gemm":
                token_gemm_lines(_build.library(name), reports[name])
        if name in NO_CONV_LIBS:
            continue
        if hgmma == 0:
            fail(f"{where} holds no HGMMA instruction: the bf16 conv is not on the tensor cores")
        if name != "resnet_block" and utmaldg == 0:
            fail(f"{where} holds no UTMALDG instruction: its convs do not load through TMA")
    print(f"[build] {len(LIBS)} libraries in {time.perf_counter() - t0:.1f} s", flush=True)
    return reports


def token_gemm_lines(lib, kernels: dict) -> None:
    """Per token_gemm instantiation of its library's ptxas report: (K, N,
    epilogue), registers, spill bytes and dynamic shared memory; a spill
    fails the build phase."""
    for func, k in kernels.items():
        m = re.search(r"token_gemmILi(\d+)ELi(\d+)ELi(\d+)ELi(\d+)ELi([01])E", func)
        if not m:
            continue
        kk, n0, n1, n, gelu = (int(v) for v in m.groups())
        epi = "gelu" if gelu else "residual"
        print(f"[build] token_gemm K={kk} N={n} ({n0} + {n1} a consumer) {epi}: {k['regs']} "
              f"registers, {k['spill']} B spilled, {lib.innfer_token_gemm_smem_bytes(kk, n, gelu)} B "
              f"of shared memory", flush=True)
        if k["spill"]:
            fail(f"token_gemm K={kk} N={n} {epi} spills {k['spill']} B of registers")


def kernel_counters():
    from innfer_tpu_torch.ops.dilated_block import fused_dilated_block
    from innfer_tpu_torch.ops.hat_attn import hat_window_attn, overlap_attn
    from innfer_tpu_torch.ops.instance_norm import fused_instance_norm
    from innfer_tpu_torch.ops.layer_norm import fused_layer_norm
    from innfer_tpu_torch.ops.window_attn import window_attn
    from innfer_tpu_torch.ops.rdb import fused_rdb, fused_rdb_padded, fused_rrdb_trunk
    from innfer_tpu_torch.ops.resnet_block import fused_resnet_block
    from innfer_tpu_torch.ops.tail_conv import tail_conv
    from innfer_tpu_torch.ops.token_gemm import token_linear

    return {f.__name__: f for f in (fused_rdb, fused_rdb_padded, fused_rrdb_trunk,
                                    fused_resnet_block, tail_conv, fused_dilated_block,
                                    fused_instance_norm, window_attn, fused_layer_norm,
                                    token_linear, hat_window_attn, overlap_attn)}


def reset_counts() -> None:
    for f in kernel_counters().values():
        f.launches = 0


def read_counts() -> dict:
    return {name: f.launches for name, f in kernel_counters().items()}


def phase_kernel(dev):
    import torch

    from innfer_tpu_torch.ops.rdb import fused_rdb, pack_rdb, rdb_reference

    for dtype, tol in ((torch.bfloat16, BF16_TOL), (torch.float32, FP32_TOL)):
        for plus in (False, True):
            ws, bs, w1 = rdb_params(torch, dev, dtype, plus, seed=1 + plus)
            x = torch.randn(1, 64, 1920, NF, generator=torch.Generator().manual_seed(3)).to(dev, dtype)
            out = fused_rdb(x, ws, bs, plus=plus, conv1x1_w=w1)
            torch.cuda.synchronize()
            ref = rdb_reference(x, ws, bs, plus=plus, conv1x1_w=w1)
            err = (out.float() - ref.float()).abs().max().item()
            db = psnr(out.float().cpu(), ref.float().cpu(), ref.float().abs().max().item())
            ok = err <= tol and torch.isfinite(out.float()).all().item()
            print(f"[kernel] strip (1,64,1920,64) {str(dtype)[6:]} plus={plus}: "
                  f"max_abs {err:.3g} (bar {tol}), PSNR {db:.1f} dB", flush=True)
            if not ok:
                fail(f"fused_rdb disagrees with rdb_reference ({dtype}, plus={plus})")

    shape = (1, 1088, 1920, NF)
    ws, bs, _ = rdb_params(torch, dev, torch.bfloat16, False, seed=4)
    x = torch.randn(*shape, generator=torch.Generator().manual_seed(5)).to(dev, torch.bfloat16)
    packed = pack_rdb(ws, bs, None, torch.bfloat16)
    out = fused_rdb(x, ws, bs, packed=packed)
    ref = rdb_reference(x, ws, bs)
    err = (out.float() - ref.float()).abs().max().item()
    del out, ref
    if err > BF16_TOL:
        fail(f"fused_rdb disagrees with rdb_reference at {shape}: max_abs {err}")
    ms = cuda_ms(lambda: fused_rdb(x, ws, bs, packed=packed), reps=5)
    plain_ms = cuda_ms(lambda: rdb_reference(x, ws, bs), reps=3)
    library_ms = cuda_ms(lambda: cudnn_chain(torch, x, ws, bs), reps=5)
    flops, nbytes = rdb_work(*shape[:3], 2, plus=False)
    t_ops, t_bytes = flops / PEAK_BF16 * 1e3, nbytes / HBM_BPS * 1e3
    bound_ms = max(t_ops, t_bytes)
    bound_by = "operations" if t_ops >= t_bytes else "bytes"
    row = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
           "bound_by": bound_by, "library_ms": library_ms, **rates(flops, ms, bound_ms)}
    print(f"[kernel] {shape} bf16: kernel {ms:.3f} ms, bound {bound_ms:.3f} ms "
          f"({bound_by}; {flops / 1e12:.3f} TFLOP, {nbytes / 1e9:.3f} GB), "
          f"plain {plain_ms:.3f} ms, cuDNN chain {library_ms:.3f} ms, "
          f"max_abs {err:.3g}, {row['tflops']:.1f} TFLOP/s achieved, "
          f"{100 * row['bound_share']:.1f}% of the bound", flush=True)
    from torch.profiler import ProfilerActivity, profile

    from scripts.time_fused_rdb import conv_floors_ms, launches_in_order

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            fused_rdb(x, ws, bs, packed=packed)
        torch.cuda.synchronize()
    convs = [t for name, t in launches_in_order(prof) if "conv" in name]
    if len(convs) != 15:
        fail(f"the profile of 3 fused_rdb calls holds {len(convs)} conv launches, not 15")
    per = [sum(convs[c::5]) / 3 for c in range(5)]
    floors = conv_floors_ms(shape[0] * shape[1] * shape[2], NF, GC)
    print("[kernel] per conv, device ms (floor ms, share): " + ", ".join(
        f"conv{c + 1} {m:.3f} ({f:.3f}, {100 * f / m:.0f}%)" for c, (m, f) in enumerate(zip(per, floors)))
        + f"; sum {sum(per):.3f} ({sum(floors):.3f})", flush=True)
    return row


TAIL_GROUP = (4, 576, 256)   # the main-path cell's tail group: 4 tiles of 576x256 LR pixels
TAIL_CONVS = ("up_shuffle", "phase_first", "hr_conv", "conv_last")


def within_one_ulp(out, ref) -> bool:
    """Every value within one bf16 ulp of the plain version's (plus 1e-3 of
    its peak for values near 0) and at least 97% equal: the fp32 sums are
    taken in another order, so a rounding may flip, and no more."""
    out, ref = out.float(), ref.float()
    tol = 2 ** -7 * ref.abs() + 1e-3 * max(1.0, ref.abs().max().item())
    return (out.shape == ref.shape and bool(((out - ref).abs() <= tol).all())
            and (out == ref).float().mean().item() >= 0.97)


def phase_tail_conv(dev):
    """The tail conv kernel (ops/tail_conv.py) at the four convs of the
    main-path cell's tail group (TAIL_GROUP, nf 64): the upsample block
    written pixel-shuffled, the phase tail's first conv written
    phase-major, the HR conv and conv_last on the phase-major grid.  Each
    against its plain composition (the route the tail takes off the
    kernel: the bias route's conv, the activation, pixel_shuffle or the
    merged phase conv) within one bf16 ulp, then timed with CUDA events
    beside its bound, the plain composition and cuDNN's bf16 conv of the
    same operations alone (the library yardstick: no activation, no
    layout; the HR convs at HR resolution)."""
    import torch
    import torch.nn.functional as TF

    from innfer_tpu_torch.models import common as C
    from innfer_tpu_torch.nn import functional as F
    from innfer_tpu_torch.nn import phase as PH
    from innfer_tpu_torch.ops import tail_conv as TC

    bf16, lrelu = torch.bfloat16, "leakyrelu"
    b, h, w = TAIL_GROUP
    g = torch.Generator().manual_seed(95)

    def rand(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g) * scale).to(dev)

    def nchw(x):  # the channels-last NCHW view cuDNN takes
        return x.permute(0, 3, 1, 2)

    wu, whr, wl = (rand(o, NF, 3, 3, scale=(9 * NF) ** -0.5).to(bf16) for o in (NF, NF, 3))
    bu, bhr, bl = (rand(o, scale=0.05) for o in (NF, NF, 3))
    w2 = C.collapse_upconv_weight(wu, None, 2)[0].to(bf16)
    b2 = bu.repeat_interleave(4)
    up = TC.pack_plain(PH.cmajor_to_phase_major(w2), PH.phase_bias(bu))
    hr_pk, last_pk = TC.pack_phase(whr, bhr), TC.pack_phase(wl, bl)
    hr_m = PH.merge_phase_kernels(PH.phase_kernels(whr, 2), 2)
    last_m = PH.merge_phase_kernels(PH.phase_kernels(wl, 2), 2)
    lr = rand(b, h, w, NF).to(bf16)
    x2 = rand(b, 2 * h, 2 * w, NF).to(bf16)
    ph = rand(b, 2 * h, 2 * w, 4 * NF).to(bf16)
    x4 = rand(b, 4 * h, 4 * w, NF).to(bf16)
    conv = lambda cin, cout, px: 2 * 9 * cin * cout * px  # noqa: E731
    px = b * h * w
    cases = {  # kernel, plain, library, FLOP, bytes (input read and output written once)
        "up_shuffle": (
            lambda: TC.tail_conv(lr, up, act=lrelu, layout="shuffle"),
            lambda: F.act(lrelu, F.pixel_shuffle(F.conv2d(lr, w2, b2, padding=1), 2)),
            lambda: TF.conv2d(nchw(lr), w2, b2.to(bf16), padding=1),
            conv(NF, 4 * NF, px), 2 * (NF + 4 * NF) * px),
        "phase_first": (
            lambda: TC.tail_conv(x2, up, act=lrelu, layout="phase"),
            lambda: F.act(lrelu, F.conv2d(x2, PH.cmajor_to_phase_major(w2), PH.phase_bias(bu),
                                          padding=1)),
            lambda: TF.conv2d(nchw(x2), w2, b2.to(bf16), padding=1),
            conv(NF, 4 * NF, 4 * px), 2 * (NF + 4 * NF) * 4 * px),
        "hr_conv": (
            lambda: TC.tail_conv(ph, hr_pk, act=lrelu, layout="phase"),
            lambda: F.act(lrelu, PH.conv_phases(ph, *hr_m, bhr, 2)),
            lambda: TF.conv2d(nchw(x4), whr, bhr.to(bf16), padding=1),
            conv(NF, NF, 16 * px), 2 * (NF + NF) * 16 * px),
        "conv_last": (
            lambda: TC.tail_conv(ph, last_pk, act=None, layout="phase"),
            lambda: PH.conv_phases(ph, *last_m, bl, 2),
            lambda: TF.conv2d(nchw(x4), wl, bl.to(bf16), padding=1),
            conv(NF, 3, 16 * px), 2 * (NF + 3) * 16 * px),
    }
    rows = {}
    for name, (kern, plain, lib, flops, nbytes) in cases.items():
        before = TC.tail_conv.launches
        out, ref = kern(), plain()
        torch.cuda.synchronize()
        if TC.tail_conv.launches != before + 1:
            fail(f"tail_conv {name}: the wrapper did not launch the kernel")
        err = (out.float() - ref.float()).abs().max().item()
        equal = (out == ref).float().mean().item()
        ok = within_one_ulp(out, ref)
        del out, ref
        if not ok:
            fail(f"tail_conv {name} is not within one bf16 ulp of its plain composition: "
                 f"max_abs {err:.3g}, {100 * equal:.2f}% equal")
        ms = cuda_ms(kern, reps=10)
        plain_ms = cuda_ms(plain, reps=3)
        library_ms = cuda_ms(lib, reps=5)
        row = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
               **bound(flops, nbytes)}
        row.update(rates(flops, ms, row["bound_ms"]))
        rows[name] = row
        print(f"[tail_conv] {name} {tuple(TAIL_GROUP)} LR px nf {NF}: kernel {ms:.3f} ms, "
              f"bound {row['bound_ms']:.3f} ms ({row['bound_by']}; {flops / 1e12:.3f} TFLOP, "
              f"{nbytes / 1e9:.3f} GB), plain {plain_ms:.3f} ms, cuDNN bf16 conv alone "
              f"{library_ms:.3f} ms, {row['tflops']:.1f} TFLOP/s achieved, "
              f"{100 * row['bound_share']:.1f}% of the bound; max_abs {err:.3g}, "
              f"{100 * equal:.3f}% equal (within one bf16 ulp)", flush=True)
    del lr, x2, ph, x4
    return rows


def phase_dilated(dev, kernels=None, shape=DILATED_SHAPE):
    """fused_dilated_block (ops/dilated_block.py) at the PPON cell's trunk
    shape: against the model's plain bf16 path (models/ppon.py's
    composition, off the kernel) within one bf16 ulp and at least 99.9%
    equal, plain and with the RRBlock's residual; then timed with CUDA
    events beside its bound (the block's operations at the unpadded rows of
    the cell's frame, the input and output once and the weights), the
    plain path and cuDNN's bf16 convs of the block alone (c1, the eight
    dilated convs, c2: no epilogue, no cascade, no concat); and each of its
    launches' device ms (torch.profiler) beside that launch's own bound at
    the same rows (its operations, or the bytes it reads and writes once:
    c1 x, h and its weights; the rates h, the 256-channel workspace and
    theirs; c2 the workspace, x, its output and weights).  ``kernels``:
    the dilated_block library's ptxas report (``ptxas_kernels``), for the
    rates kernel's registers and spill."""
    import numpy as np
    import torch
    import torch.nn.functional as TF

    from innfer_tpu_torch.models import ppon as PP
    from innfer_tpu_torch.models.base import ParamDict, cast_params
    from innfer_tpu_torch.ops import dilated_block as DB
    from innfer_tpu_torch.ops import plain_path
    from innfer_tpu_torch.tools import synth_params as SP

    state = SP.ppon_state(nb=1, nf=NF, scale=4, seed=97)
    params = cast_params(ParamDict({k: torch.from_numpy(np.asarray(v)).to(dev)
                                    for k, v in state.items()}), torch.bfloat16)
    prefix = "CFEM.1.sub.0.RB3"
    w, b = PP._block_params(params, prefix)
    packed = DB.pack_block(w, b)
    g = torch.Generator().manual_seed(96)
    x = torch.randn(*shape, generator=g).to(dev, torch.bfloat16)
    res = torch.randn(*shape, generator=g).to(dev, torch.bfloat16)
    kern = lambda r=None: DB.fused_dilated_block(x, w, b, res=r, packed=packed)  # noqa: E731

    def plain(r=None):
        with plain_path():
            return PP._res_block_32(params, x, prefix, res=r)

    for r in (None, res):
        before = DB.fused_dilated_block.launches
        out, ref = kern(r), plain(r)
        torch.cuda.synchronize()
        if DB.fused_dilated_block.launches != before + 1:
            fail("fused_dilated_block: the wrapper did not launch the kernel")
        err = (out.float() - ref.float()).abs().max().item()
        equal = (out == ref).float().mean().item()
        if not within_one_ulp(out, ref) or equal < 0.999:
            fail(f"fused_dilated_block (res {r is not None}) is not within one bf16 ulp of the "
                 f"plain path at >= 99.9% equal: max_abs {err:.3g}, {100 * equal:.3f}% equal")
        print(f"[dilated] check {tuple(shape)} res {r is not None}: max_abs {err:.3g}, "
              f"{100 * equal:.3f}% equal to the plain bf16 path (within one bf16 ulp)",
              flush=True)
    nchw = lambda t: t.permute(0, 3, 1, 2)  # noqa: E731
    cat = torch.randn(shape[0], shape[1], shape[2], 4 * NF, generator=g).to(dev, torch.bfloat16)
    wb = [t.to(torch.bfloat16) for t in w]
    bb = [t.to(torch.bfloat16) for t in b]

    def library():
        h = TF.conv2d(nchw(x), wb[0], bb[0], padding=1)
        for r in range(1, 9):
            TF.conv2d(h, wb[r], bb[r], padding=r, dilation=r)
        TF.conv2d(nchw(cat), wb[9], bb[9])

    ms = cuda_ms(kern, reps=20)
    plain_ms = cuda_ms(plain, reps=3)
    library_ms = cuda_ms(library, reps=10)
    h_px = min(shape[1], 540) * shape[2] * shape[0]   # the cell's unpadded rows
    macs = 9 * NF * NF + 8 * 9 * NF * NF // 2 + 4 * NF * NF
    flops, nbytes = 2 * macs * h_px, 2 * 2 * NF * h_px + 2 * macs + 4 * 6 * NF
    row = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
           **bound(flops, nbytes)}
    row.update(rates(flops, ms, row["bound_ms"]))
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            kern()
        torch.cuda.synchronize()
    per = [(e.key, e.device_time_total / 1e3 / e.count) for e in prof.key_averages()
           if e.device_time_total > 0 and "dilated_block_" in e.key]
    print(f"[dilated] fused_dilated_block {tuple(shape)}: kernel {ms:.3f} ms, bound "
          f"{row['bound_ms']:.3f} ms ({row['bound_by']}; {flops / 1e12:.3f} TFLOP, "
          f"{nbytes / 1e9:.3f} GB at the cell's 540 rows), plain {plain_ms:.3f} ms, cuDNN bf16 "
          f"convs alone {library_ms:.3f} ms, {row['tflops']:.1f} TFLOP/s, "
          f"{100 * row['bound_share']:.1f}% of the bound", flush=True)
    w_bytes = {"c1": 2 * 9 * NF * NF, "rates": 2 * 8 * 9 * NF * GC, "fuse": 2 * 4 * NF * NF}
    work = {"c1": (9 * NF * NF, 2 * (NF + NF)),            # MACs, bytes a pixel
            "rates": (8 * 9 * NF * GC, 2 * (NF + 4 * NF)),
            "fuse": (4 * NF * NF, 2 * (4 * NF + NF + NF))}
    if len(per) != 3 or any(sum(f"dilated_block_{k}" in n for n, _ in per) != 1 for k in work):
        fail(f"[dilated] want one dilated_block_c1, _rates and _fuse launch a call, got "
             f"{[n for n, _ in per]}")
    for k, (macs_px, bytes_px) in work.items():
        t = next(t for n, t in per if f"dilated_block_{k}" in n)
        f_k = 2 * macs_px * h_px
        b_k = bound(f_k, bytes_px * h_px + w_bytes[k])
        r_k = rates(f_k, t, b_k["bound_ms"])
        print(f"[dilated] dilated_block_{k}: {t:.4f} ms, bound {b_k['bound_ms']:.4f} ms "
              f"({b_k['bound_by']}), {r_k['tflops']:.1f} TFLOP/s, "
              f"{100 * r_k['bound_share']:.1f}% of its bound", flush=True)
    from innfer_tpu_torch.ops import _build

    lib = _build.dilated_block_library()
    lib.innfer_dilated_block_staged_bytes.argtypes = [ctypes.c_int] * 4
    lib.innfer_dilated_block_staged_bytes.restype = ctypes.c_longlong
    halo, wts = [lib.innfer_dilated_block_staged_bytes(shape[0], shape[1], shape[2], part)
                 for part in (0, 1)]
    rk = next((v for f, v in (kernels or {}).items() if "dilated_block_rates" in f), None)
    print(f"[dilated] dilated_block_rates: "
          + (f"{rk['regs']} registers, {rk['spill']} B spilled; " if rk else
             "no ptxas report (library already built); ")
          + f"stages a call {halo / 1e9:.4f} GB of halo in {halo / (2 * NF) / 1e6:.3f} M "
          f"128-byte box rows and {wts / 1e9:.4f} GB of weights", flush=True)
    del x, res, cat
    return row


def phase_main(dev, work):
    import numpy as np
    import torch

    from innfer_tpu_torch.io import images as iio
    from innfer_tpu_torch.ops import plain_path
    from innfer_tpu_torch.ops.rdb import fused_rdb
    from innfer_tpu_torch.pipeline import InferenceSession

    ckpt = os.path.join(work, "4x_synth_esrgan.pth")
    torch.save(synth_esrgan_state(torch, seed=0), ckpt)
    in_dir = os.path.join(work, "in")
    os.makedirs(in_dir)
    sizes = {"a_540x960": (540, 960), "b_1080x1920": (1080, 1920)}
    for i, (name, (h, w)) in enumerate(sizes.items()):
        iio.save_img(synth_image(h, w, seed=10 + i), os.path.join(in_dir, f"{name}.png"))

    sess = InferenceSession(ckpt, compute_dtype=torch.bfloat16, tile_mode="auto")
    cfg = sess.stages[0].model.cfg
    if (cfg["nb"], cfg["nf"], cfg["gc"], sess.stages[0].model.scale) != (23, NF, GC, 4):
        fail(f"auto-detection read the checkpoint as {cfg}")
    runner = sess.stages[0].runner
    per_image = []  # one {"trunk": [...], "tail": [...]} of CUDA event pairs per image

    def timed(fn, key):
        def run(params, x):
            if key == "trunk":
                per_image.append({"trunk": [], "tail": []})
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            out = fn(params, x)
            e1.record()
            per_image[-1][key].append((e0, e1))
            return out
        return run

    runner.trunk_fn = timed(runner.trunk_fn, "trunk")
    runner.tail_fn = timed(runner.tail_fn, "tail")

    out_dir = os.path.join(work, "out_kernel")
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    written = sess.process(in_dir, out_dir, verbose=False)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    launches = counts["fused_rdb"]
    if runner.last_mode != "hybrid":
        fail(f"tile_mode auto ran {runner.last_mode!r}, not hybrid, on the card")
    want = 69 * len(sizes)
    if launches != want:
        fail(f"fused_rdb launched {launches} times for {len(sizes)} images; expected {want}")
    # the tail: 4 tail_conv launches a tile group (the upsample block, the
    # phase tail's first conv, its HR conv and conv_last)
    groups = sum(len(im["tail"]) for im in per_image)
    if counts != {**dict.fromkeys(counts, 0), "fused_rdb": launches, "tail_conv": 4 * groups}:
        fail(f"the default ESRGAN path launched {counts}; expected {want} fused_rdb and "
             f"{4 * groups} tail_conv ({groups} tile groups)")
    device_ms = [{k: sum(a.elapsed_time(b) for a, b in v) for k, v in im.items()}
                 for im in per_image]

    # the plain path, in the kernel run's tiling, to compare the kernels alone
    ref_sess = InferenceSession(ckpt, compute_dtype=torch.bfloat16, tile_mode="hybrid")
    ref_dir = os.path.join(work, "out_torch")
    t0 = time.perf_counter()
    with plain_path():
        ref_sess.process(in_dir, ref_dir, verbose=False)
    torch.cuda.synchronize()
    ref_wall = time.perf_counter() - t0
    if read_counts() != counts:
        fail("the plain path launched a kernel")

    dbs = []
    for (name, (h, w)), path in zip(sizes.items(), sorted(written)):
        out = iio.read_img(path)
        ref = iio.read_img(os.path.join(ref_dir, os.path.basename(path)))
        if out is None or out.shape != (4 * h, 4 * w, 3) or out.dtype != np.uint8:
            fail(f"{path}: expected a ({4 * h}, {4 * w}, 3) uint8 PNG, read "
                 f"{None if out is None else (out.shape, out.dtype)}")
        if out.std() < 1.0:
            fail(f"{path}: the output is flat (std {out.std():.3f})")
        dbs.append(psnr(out, ref, 255.0))
    times = "; ".join(f"{n} trunk {t['trunk']:.1f} ms, tail {t['tail']:.1f} ms"
                      for n, t in zip(sizes, device_ms))
    print(f"[main] {len(sizes)} images in bf16, mode {runner.last_mode}: fused_rdb "
          f"launches {launches} (69 per image), tail_conv {counts['tail_conv']} (4 per tile "
          f"group, {groups} groups); wall {wall:.3f} s for both "
          f"(plain path, tile_mode='hybrid' {ref_wall:.3f} s); CUDA events: {times}; "
          f"PSNR vs the plain path {', '.join(f'{d:.1f}' for d in dbs)} dB", flush=True)
    if min(dbs) < MIN_PSNR_DB:
        fail(f"kernel path vs torch path PSNR {min(dbs):.1f} dB < {MIN_PSNR_DB}")

    # fp32 on a small input: the kernel path is true fp32 end to end
    small = torch.rand(1, 40, 56, 3, generator=torch.Generator().manual_seed(7)).to(dev)
    model, params = sess.stages[0].model, sess.stages[0].params
    p32 = {k: v.float() for k, v in params.items()}
    with torch.no_grad():
        a = model.apply(p32, small)
        with plain_path():
            b = model.apply(p32, small)
    db32 = psnr(a.cpu(), b.cpu(), 1.0)
    print(f"[main] fp32 (1,40,56,3): kernel path vs torch path PSNR {db32:.1f} dB", flush=True)
    if db32 < 80.0 or not torch.isfinite(a).all():
        fail(f"fp32 kernel path vs torch path PSNR {db32:.1f} dB < 80")
    return {"launches": launches, "tail_groups": groups, "ckpt": ckpt, "in_dir": in_dir,
            "out_dir": out_dir, "n_images": len(sizes), "sizes": sizes,
            "mode": runner.last_mode}


TAIL_FORMS = {"a": "plain materialized tail", "b": "collapsed upconv, materialized HR tail",
              "c": "collapsed upconv, phase tail split per phase",
              "d": "collapsed upconv, phase tail as one dense conv",
              "k": "(c) on the tail conv kernel"}
TAIL_BF16_DB, TAIL_FP32_DB = 35.0, 80.0   # each tail form vs the plain tail


def tail_flops(h, w, nf=NF, out_nc=3) -> dict:
    """Operations of each tail form of the 4x upconv ESRGAN on an h x w LR
    image: up1 at 2x, up2, the HR conv and conv_last at 4x (3x3 convs; the
    collapse keeps the FLOPs).  The phase tail runs the HR conv and
    conv_last on 16 of 36 tap-slots per 4 output phases (16/9 of the HR
    conv), the dense form on all 36 (4x), the kernel on 9 (the HR conv's
    own)."""
    conv = lambda cin, cout, px: 2 * 9 * cin * cout * px  # noqa: E731
    px = h * w
    up1, up2 = conv(nf, nf, 4 * px), conv(nf, nf, 16 * px)
    hr, last = conv(nf, nf, 16 * px), conv(nf, out_nc, 16 * px)
    plain = up1 + up2 + hr + last
    return {"a": plain, "b": plain, "c": up1 + up2 + (hr + last) * 16 / 9,
            "d": up1 + up2 + (hr + last) * 4, "k": plain}


@contextlib.contextmanager
def tail_form(form: str):
    """Force one tail form by patching the predicates of models/common.py
    to False, as the tests do (the predicates hold the eligibility of the
    collapse and the phase tail); form d also swaps the per-phase HR conv
    for the dense phase conv (its kernel cached on the ParamDict like the
    package's).  Forms a-d run on the plain composition (inside
    ``ops.plain_path``), as the JAX package's rewrites; form k is (c) as
    the session runs it, its convs on the tail conv kernel where the gate
    holds."""
    from unittest import mock

    from innfer_tpu_torch.models import common as C
    from innfer_tpu_torch.nn import functional as F
    from innfer_tpu_torch.nn import phase as PH
    from innfer_tpu_torch.ops import plain_path

    def dense_hr_conv(params, p, key, r=2, act=None):
        k = C.derived(params, "phase_dense", key, lambda w: PH.dense_phase_kernel(w, r))
        return F.act(act, F.conv2d(p, k, PH.phase_bias(params.get(f"{key}.bias"), r), padding=1))

    false = lambda *a, **k: False  # noqa: E731
    with contextlib.ExitStack() as stack:
        if form == "a":
            stack.enter_context(mock.patch.object(C, "upconv_collapse_ok", false))
        if form in "ab":
            stack.enter_context(mock.patch.object(C, "phase_tail_ok", false))
        if form == "d":
            stack.enter_context(mock.patch.object(C, "phase_hr_conv", dense_hr_conv))
        if form != "k":
            stack.enter_context(plain_path())
        yield


def policy_form(params) -> str:
    """The tail form the package's predicates pick for the main path's
    ESRGAN (4x upconv: blocks at model.3 and model.6)."""
    from innfer_tpu_torch.models import common as C

    collapse = C.upconv_collapse_ok(params, "model.3", factor=2)
    phase = C.phase_tail_ok(params, "model.6", factor=2, up_mode="upconv",
                            act_type="leakyrelu", finalact=None)
    return {(False, False): "a", (True, False): "b", (True, True): "c"}.get(
        (collapse, phase), f"collapse={collapse}, phase={phase}")


def phase_tail(dev, work, main):
    """The A/B of the JAX package's exact tail rewrites on the main path's
    1080p image, and of the tail conv kernel: the trunk runs once, then the
    session's own runner (hybrid_apply's tile groups) runs the tail in each
    form, forced through the predicates, in turns a b c d k k d c b a,
    three times; median ms per tail, the spread of each form's reps, FLOPs,
    PSNR against the plain tail (bf16 at 1080p, fp32 on a crop of the trunk
    output).  Forms a-d run on the plain composition and launch no port
    kernel; form k launches tail_conv 4 times a tile group.  A form is
    adopted only if its median beats (a) by more than the spread of its
    own reps; the fastest adopted form must be the one the predicates
    encode, and form k must beat it likewise.  Then the per-phase conv at
    one tail group's shape, the package's merged conv against the JAX
    package's split with asymmetric pads (a TF.pad per phase) and against
    one pad with views."""
    import torch

    from innfer_tpu_torch.io import images as iio
    from innfer_tpu_torch.models import common as C
    from innfer_tpu_torch.nn import functional as F
    from innfer_tpu_torch.nn import phase as PH
    from innfer_tpu_torch.pipeline import InferenceSession, np2tensor
    from innfer_tpu_torch.tiling.engine import _pad_to

    bf16 = torch.bfloat16
    name, (h, w) = list(main["sizes"].items())[-1]
    sess = InferenceSession(main["ckpt"], compute_dtype=bf16, tile_mode="auto")
    stage = sess.stages[0]
    model, params, runner = stage.model, stage.params, stage.runner
    x = np2tensor(iio.read_img(os.path.join(main["in_dir"], f"{name}.png")), device=dev)
    plan = runner.plan_for(h, w, on_cuda=True)
    if runner.mode_for(h, w, on_cuda=True) != "hybrid":
        fail("the [tail] runner is not hybrid")
    trunk = model.apply_trunk(params, _pad_to(x, plan.pad_h, plan.pad_w).to(bf16))
    runner.trunk_fn = lambda p, t: trunk  # noqa: E731  (the tail alone from here)
    groups = [0]
    tail_fn = runner.tail_fn

    def counted(p, t):
        groups[0] += 1
        return tail_fn(p, t)

    runner.tail_fn = counted
    flops = tail_flops(h, w)
    outs, times = {}, {f: [] for f in TAIL_FORMS}
    reset_counts()
    launched = {f: [] for f in TAIL_FORMS}  # (tail_conv launches, tile groups) a run

    def run(form):
        before, g0 = read_counts()["tail_conv"], groups[0]
        out = runner(params, x)
        launched[form].append((read_counts()["tail_conv"] - before, groups[0] - g0))
        return out

    for form in TAIL_FORMS:  # a first pass per form: derived weights, cuDNN set-up
        with tail_form(form):
            outs[form] = run(form)
    for _ in range(3):
        for form in "abcdkkdcba":
            with tail_form(form):
                torch.cuda.synchronize()
                e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                e0.record()
                run(form)
                e1.record()
                torch.cuda.synchronize()
                times[form].append(e0.elapsed_time(e1))
    runner.tail_fn = tail_fn
    wrong = {f: runs for f, runs in launched.items()
             if any(n != (4 * g if f == "k" else 0) or g == 0 for n, g in runs)}
    if wrong or any(v for k, v in read_counts().items() if k != "tail_conv"):
        fail(f"the tail forms' tail_conv launches and tile groups {wrong} (4 a group in "
             f"form k, none in a-d), all launches {read_counts()}")
    ref = outs["a"].float()
    peak = max(1.0, ref.abs().max().item())
    db16 = {f: (math.inf if (o.float() - ref).square().mean().item() == 0 else
                10 * math.log10(peak ** 2 / (o.float() - ref).square().mean().item()))
            for f, o in outs.items()}
    del outs, ref
    # fp32 on a crop of the trunk output: each form against the plain tail
    p32 = {k: v.float() for k, v in params.items()}
    crop = trunk[:, :68, :120].float()
    out32 = {}
    for form in TAIL_FORMS:
        with tail_form(form):
            out32[form] = model.apply_tail(type(params)(p32), crop).cpu()
    db32 = {f: psnr(o, out32["a"], max(1.0, out32["a"].abs().max().item()))
            for f, o in out32.items()}
    stats = {}
    for f, t in times.items():
        t = sorted(t)
        stats[f] = {"median": (t[2] + t[3]) / 2, "spread": t[-1] - t[0]}
    adopted = [f for f in "bcd" if stats["a"]["median"] - stats[f]["median"] > stats[f]["spread"]]
    best = min(adopted, key=lambda f: stats[f]["median"]) if adopted else "a"
    kernel_gain = stats[best]["median"] - stats["k"]["median"]
    for f, label in TAIL_FORMS.items():
        st = stats[f]
        print(f"[tail] ({f}) {label}: median {st['median']:.2f} ms per {h}x{w} tail (spread "
              f"{st['spread']:.2f} ms over {len(times[f])} reps: "
              f"{', '.join(f'{t:.2f}' for t in times[f])}), {flops[f] / 1e12:.3f} TFLOP, "
              f"{flops[f] / st['median'] / 1e9:.1f} TFLOP/s; PSNR vs (a) bf16 {db16[f]:.1f} dB "
              f"(bar {TAIL_BF16_DB}), fp32 (1,68,120,{NF}) {db32[f]:.1f} dB (bar {TAIL_FP32_DB})",
              flush=True)
    encoded = policy_form(params)
    print(f"[tail] adoption rule (median beats (a) by more than the form's spread): "
          f"{', '.join(adopted) or 'none'} beat (a); adopted ({best}); the predicates encode "
          f"({encoded}); the kernel (k) beats ({best}) by {kernel_gain:.2f} ms (its spread "
          f"{stats['k']['spread']:.2f} ms); (tail_conv launches, tile groups) a run of (k) "
          f"{sorted(set(launched['k']))}", flush=True)
    if min(db16.values()) < TAIL_BF16_DB or min(db32.values()) < TAIL_FP32_DB:
        fail(f"a tail form disagrees with the plain tail: bf16 {db16}, fp32 {db32}")
    if encoded != best:
        fail(f"the measured policy ({best}) is not the one the predicates encode ({encoded})")
    if kernel_gain <= stats["k"]["spread"]:
        fail(f"the tail conv kernel (k) does not beat ({best}) by more than its spread")

    # the per-phase HR conv at one tail group's shape, three ways
    chunk = plan.chunk or min(runner.tile_batch, plan.n_tiles)
    g = torch.Generator().manual_seed(90)
    p = torch.randn(chunk, 2 * plan.tile_h, 2 * plan.tile_w, 4 * NF, generator=g).to(dev, bf16)
    wt = params["model.8.weight"]
    bt = params["model.8.bias"]
    kernels = PH.phase_kernels(wt, 2)
    merged, offsets = PH.merge_phase_kernels(kernels, 2)

    def split_pad_each():
        return torch.cat([F.conv2d(p, k, bt, padding=list(pad)) for k, pad in kernels], -1)

    def split_pad_once():
        pp = F.pad2d(p, 1)
        hg, wg = p.shape[1], p.shape[2]
        return torch.cat([F.conv2d(pp[:, 1 - t: 1 + hg + bo, 1 - le: 1 + wg + ri], k, bt)
                          for k, ((t, bo), (le, ri)) in kernels], -1)

    ways = {"merged (the package's)": lambda: PH.conv_phases(p, merged, offsets, bt, 2),
            "split, TF.pad per phase": split_pad_each, "split, one pad and views": split_pad_once}
    base = ways["merged (the package's)"]().float()
    parts = []
    for label, fn in ways.items():
        err = (fn().float() - base).abs().max().item()
        parts.append(f"{label} {cuda_ms(fn, reps=5):.3f} ms (max_abs vs merged {err:.3g})")
    print(f"[tail] phase HR conv at one tail group {tuple(p.shape)} bf16: {'; '.join(parts)}",
          flush=True)
    del p, trunk
    return {"stats": stats, "best": best, "db16": db16, "db32": db32}


def trunk_params(torch, dev, dtype, seed):
    """The 23 x 3 RDBs of a seeded synthetic ESRGAN trunk: [r][c][5]
    weights (OIHW) and fp32 biases."""
    state = synth_esrgan_state(torch, seed=seed)
    key = lambda i, j, c, leaf: state[f"model.1.sub.{i}.RDB{j}.conv{c}.0.{leaf}"]  # noqa: E731
    ws = [[[key(i, j, c, "weight").to(dev, dtype) for c in range(1, 6)] for j in (1, 2, 3)]
          for i in range(NB)]
    bs = [[[key(i, j, c, "bias").to(dev) for c in range(1, 6)] for j in (1, 2, 3)]
          for i in range(NB)]
    return ws, bs


def phase_chain(dev, work, main):
    """Rows 2 and 3 of the kernel table: fused_rdb_padded and
    fused_rrdb_trunk at the main-path shape, then the chain through the
    session."""
    import numpy as np
    import torch

    from innfer_tpu_torch.io import images as iio
    from innfer_tpu_torch.ops.rdb import (fused_rdb, fused_rdb_padded, fused_rrdb_trunk,
                                          pack_rdb, rdb_padded_reference,
                                          rrdb_trunk_reference, res_scale)
    from innfer_tpu_torch.pipeline import InferenceSession

    bf16 = torch.bfloat16
    shape = (1, 1088, 1920, NF)
    ws, bs = trunk_params(torch, dev, bf16, seed=20)
    packed = [[pack_rdb(w, b, None, bf16) for w, b in zip(wr, br)] for wr, br in zip(ws, bs)]
    g = torch.Generator().manual_seed(21)
    x = torch.randn(*shape, generator=g).to(dev, bf16)
    s = res_scale(bf16)

    # one chain-mode call with the RRDB residual
    wsp = torch.empty(shape[:3] + (NF + 4 * GC,), dtype=bf16, device=dev)
    out_ws, res_ws, ref_ws = (torch.empty_like(wsp) for _ in range(3))
    wsp[..., :NF] = x
    res_ws[..., :NF] = torch.randn(*shape, generator=g).to(dev, bf16)
    call = lambda: fused_rdb_padded(wsp, ws[0][0], bs[0][0], out_ws, res=res_ws,  # noqa: E731
                                    packed=packed[0][0])
    before = fused_rdb_padded.launches
    call()
    torch.cuda.synchronize()
    if fused_rdb_padded.launches != before + 1:
        fail("fused_rdb_padded did not count its launch")
    plain = lambda: rdb_padded_reference(wsp, ws[0][0], bs[0][0], ref_ws, res=res_ws)  # noqa: E731
    plain()
    pad_err = (out_ws[..., :NF].float() - ref_ws[..., :NF].float()).abs().max().item()
    print(f"[chain] fused_rdb_padded {shape} bf16 with res: max_abs {pad_err:.3g} "
          f"(bar {BF16_TOL})", flush=True)
    if pad_err > BF16_TOL or not torch.isfinite(out_ws[..., :NF].float()).all():
        fail(f"fused_rdb_padded disagrees with rdb_padded_reference: max_abs {pad_err}")
    pad_ms = cuda_ms(call, reps=5)
    pad_plain_ms = cuda_ms(plain, reps=3)
    pad_lib_ms = cuda_ms(lambda: cudnn_chain(torch, x, ws[0][0], bs[0][0]).permute(0, 2, 3, 1)
                         * s + res_ws[..., :NF], reps=5)
    flops, nbytes = rdb_work(*shape[:3], 2, plus=False)
    nbytes += shape[0] * shape[1] * shape[2] * NF * 2  # the residual read
    pad = {"max_abs_err": pad_err, "ms": pad_ms, "plain_ms": pad_plain_ms,
           "library_ms": pad_lib_ms, **bound(flops, nbytes)}
    pad.update(rates(flops, pad_ms, pad["bound_ms"]))
    print(f"[chain] fused_rdb_padded: kernel {pad_ms:.3f} ms, bound {pad['bound_ms']:.3f} ms "
          f"({pad['bound_by']}), plain {pad_plain_ms:.3f} ms, cuDNN chain + residual "
          f"{pad_lib_ms:.3f} ms, {pad['tflops']:.1f} TFLOP/s, "
          f"{100 * pad['bound_share']:.1f}% of the bound", flush=True)
    del wsp, out_ws, res_ws, ref_ws

    # the trunk: 69 chain-mode launches, vs its plain version and the per-RDB path
    trunk = lambda: fused_rrdb_trunk(x, ws, bs, nb=NB, nr=3, gc=GC, packed=packed)  # noqa: E731

    def per_rdb():
        z0 = x
        for r in range(NB):
            z = z0
            for c in range(3):
                z = fused_rdb(z, ws[r][c], bs[r][c], packed=packed[r][c])
            z0 = z * s + z0
        return z0

    def cudnn_trunk():
        z0 = x
        for r in range(NB):
            z = z0
            for c in range(3):
                z = cudnn_chain(torch, z, ws[r][c], bs[r][c]).permute(0, 2, 3, 1)
            z0 = z * s + z0
        return z0

    before = fused_rdb_padded.launches
    out = trunk()
    torch.cuda.synchronize()
    per_trunk = fused_rdb_padded.launches - before
    if per_trunk != NB * 3:
        fail(f"fused_rrdb_trunk launched fused_rdb_padded {per_trunk} times; expected {NB * 3}")
    ref = rrdb_trunk_reference(x, ws, bs, nb=NB, nr=3)
    err = (out.float() - ref.float()).abs().max().item()
    peak = ref.float().abs().max().item()
    db = psnr(out.float().cpu(), ref.float().cpu(), peak)
    del ref
    same = per_rdb()
    mismatched = (out != same).sum().item()
    print(f"[chain] fused_rrdb_trunk nb={NB} {shape} bf16: {per_trunk} fused_rdb_padded "
          f"launches; vs plain max_abs {err:.3g} at max|ref| {peak:.1f}, PSNR {db:.1f} dB "
          f"(bar {MIN_PSNR_DB}); vs per-RDB fused_rdb + residual: {mismatched} of "
          f"{out.numel()} values differ (bar 0)", flush=True)
    if db < MIN_PSNR_DB or not torch.isfinite(out.float()).all():
        fail(f"fused_rrdb_trunk vs rrdb_trunk_reference PSNR {db:.1f} dB < {MIN_PSNR_DB}")
    if mismatched:
        fail(f"fused_rrdb_trunk differs from the per-RDB path in {mismatched} values")
    del out, same
    trunk_ms = cuda_ms(trunk, reps=2, warm=False)
    per_rdb_ms = cuda_ms(per_rdb, reps=1, warm=False)
    trunk_plain_ms = cuda_ms(lambda: rrdb_trunk_reference(x, ws, bs, nb=NB, nr=3), reps=1)
    trunk_lib_ms = cuda_ms(cudnn_trunk, reps=1)
    wbytes = rdb_work(1, 1, 1, 2, plus=False)[1] - 2 * NF * 2
    trunk_row = {"max_abs_err": err, "ms": trunk_ms, "plain_ms": trunk_plain_ms,
                 "library_ms": trunk_lib_ms,
                 **bound(NB * 3 * flops, 2 * x.numel() * 2 + NB * 3 * wbytes)}
    trunk_row.update(rates(NB * 3 * flops, trunk_ms, trunk_row["bound_ms"]))
    print(f"[chain] fused_rrdb_trunk: {trunk_ms:.1f} ms per trunk, bound "
          f"{trunk_row['bound_ms']:.1f} ms ({trunk_row['bound_by']}), per-RDB fused_rdb path "
          f"{per_rdb_ms:.1f} ms, plain {trunk_plain_ms:.1f} ms, cuDNN chains "
          f"{trunk_lib_ms:.1f} ms, {trunk_row['tflops']:.1f} TFLOP/s, "
          f"{100 * trunk_row['bound_share']:.1f}% of the bound", flush=True)
    del x

    # the chain through the session, on the main path's images
    os.environ["INNFER_RDB_CHAIN"] = "1"
    try:
        sess = InferenceSession(main["ckpt"], compute_dtype=bf16, tile_mode="auto")
        chain_dir = os.path.join(work, "out_chain")
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        written = sess.process(main["in_dir"], chain_dir, verbose=False)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = read_counts()
    finally:
        del os.environ["INNFER_RDB_CHAIN"]
    n = main["n_images"]
    want = {"fused_rdb": 0, "fused_rdb_padded": NB * 3 * n, "fused_rrdb_trunk": n,
            "fused_resnet_block": 0, "tail_conv": 4 * main["tail_groups"],
            "fused_dilated_block": 0, "fused_instance_norm": 0, "window_attn": 0,
            "fused_layer_norm": 0, "token_linear": 0,
            "hat_window_attn": 0, "overlap_attn": 0}
    if counts != want:
        fail(f"INNFER_RDB_CHAIN=1 session launches {counts}; expected {want}")
    dbs = []
    for path in sorted(written):
        out = iio.read_img(path)
        ref = iio.read_img(os.path.join(main["out_dir"], os.path.basename(path)))
        if out is None or ref is None or out.shape != ref.shape or out.dtype != np.uint8:
            fail(f"{path}: the chain path wrote no PNG of the main path's shape")
        dbs.append(psnr(out, ref, 255.0))
    print(f"[chain] {n} images through InferenceSession with INNFER_RDB_CHAIN=1: launches "
          f"{counts}; wall {wall:.3f} s; PSNR vs the default kernel path "
          f"{', '.join(f'{d:.1f}' for d in dbs)} dB (bar {MIN_PSNR_DB})", flush=True)
    if min(dbs) < MIN_PSNR_DB:
        fail(f"chain path vs default path PSNR {min(dbs):.1f} dB < {MIN_PSNR_DB}")
    pad["launches"] = counts["fused_rdb_padded"]
    trunk_row["launches"] = counts["fused_rrdb_trunk"]
    return pad, trunk_row


def bound(flops: float, nbytes: float) -> dict:
    """The least time the card needs: operations at the bf16 tensor rate or
    bytes at the HBM rate, whichever is longer."""
    t_ops, t_bytes = flops / PEAK_BF16 * 1e3, nbytes / HBM_BPS * 1e3
    return {"bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def rates(flops: float, ms: float, bound_ms: float) -> dict:
    """Achieved TFLOP/s and the share of the bound of a kernel time."""
    return {"tflops": flops / ms / 1e9, "bound_share": bound_ms / ms}


def block_params(torch, dev, dtype, c, bias, seed):
    g = torch.Generator().manual_seed(seed)
    w1, w2 = ((torch.randn(c, c, 3, 3, generator=g) * 0.02).to(dev, dtype) for _ in range(2))
    b1, b2 = ((torch.randn(c, generator=g) * 0.1).to(dev) if bias else None for _ in range(2))
    return w1, b1, w2, b2


def cudnn_resnet_block(torch, x, w1, b1, w2, b2):
    """The library yardstick: reflect pad + cuDNN conv + F.instance_norm +
    ReLU + pad + conv + F.instance_norm + add, channels-last bf16."""
    F = torch.nn.functional
    t = x.permute(0, 3, 1, 2)
    h = F.conv2d(F.pad(t, (1, 1, 1, 1), mode="reflect"), w1, b1.to(x.dtype))
    h = F.relu(F.instance_norm(h))
    h = F.conv2d(F.pad(h, (1, 1, 1, 1), mode="reflect"), w2, b2.to(x.dtype))
    return t + F.instance_norm(h)


def phase_resnet_block(dev):
    """Row 4 of the kernel table at the CycleGAN path's slab shape."""
    import torch

    from innfer_tpu_torch.ops.resnet_block import (fused_resnet_block, pack_resnet_block,
                                                   resnet_block_reference)

    main_shape = (8, 138, 64, 4 * CG_NGF)
    main_err = None
    for shape in (main_shape, (3, 37, 29, 4 * CG_NGF)):
        for dtype in (torch.bfloat16, torch.float32):
            for bias in (True, False):
                p = block_params(torch, dev, dtype, shape[-1], bias, seed=30 + bias)
                x = torch.randn(*shape, generator=torch.Generator().manual_seed(31)).to(dev, dtype)
                out = fused_resnet_block(x, *p)
                torch.cuda.synchronize()
                ref = resnet_block_reference(x, *p).float()
                d = (out.float() - ref).abs()
                err = d.max().item()
                ok = bool(torch.isfinite(out.float()).all())
                if dtype == torch.float32:
                    ok = ok and err <= FP32_TOL
                    note = f"bar {FP32_TOL}"
                else:
                    bar = 2.0 ** -7 * (ref.abs() + (ref - x.float()).abs() + 1)
                    db = psnr(out.float().cpu(), ref.cpu(), ref.abs().max().item())
                    worst = (d / bar).max().item()
                    ok = ok and worst <= 1.0 and db >= RB_PSNR_DB
                    note = f"{worst:.2f} of the ulp bar, PSNR {db:.1f} dB (bar {RB_PSNR_DB})"
                print(f"[resnet_block] {shape} {str(dtype)[6:]} bias={bias}: max_abs {err:.3g}, "
                      f"{note}", flush=True)
                if not ok:
                    fail(f"fused_resnet_block disagrees with resnet_block_reference at {shape} "
                         f"{dtype} bias={bias}")
                if shape == main_shape and dtype == torch.bfloat16 and bias:
                    main_err = err
    w1, b1, w2, b2 = block_params(torch, dev, torch.bfloat16, main_shape[-1], True, seed=32)
    x = torch.randn(*main_shape, generator=torch.Generator().manual_seed(33)).to(dev, torch.bfloat16)
    packed = pack_resnet_block(w1, b1, w2, b2, torch.bfloat16)
    ms = cuda_ms(lambda: fused_resnet_block(x, w1, b1, w2, b2, packed=packed), reps=10)
    plain_ms = cuda_ms(lambda: resnet_block_reference(x, w1, b1, w2, b2), reps=3)
    library_ms = cuda_ms(lambda: cudnn_resnet_block(torch, x, w1, b1, w2, b2), reps=10)
    c = main_shape[-1]
    px = main_shape[0] * main_shape[1] * main_shape[2]
    flops = 2 * 2 * 9 * c * c * px
    row = {"max_abs_err": main_err, "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
           **bound(flops, 2 * px * c * 2 + 2 * 9 * c * c * 2 + 2 * c * 4)}
    row.update(rates(flops, ms, row["bound_ms"]))
    print(f"[resnet_block] {main_shape} bf16: kernel {ms:.3f} ms, bound {row['bound_ms']:.3f} ms "
          f"({row['bound_by']}; {flops / 1e9:.1f} GFLOP), plain {plain_ms:.3f} ms, cuDNN + "
          f"F.instance_norm {library_ms:.3f} ms, {row['tflops']:.1f} TFLOP/s achieved, "
          f"{100 * row['bound_share']:.1f}% of the bound", flush=True)

    # the batched path's shapes: a whole-image stack of eight 512x512
    # images, and a cross-image group of 32 tiles of 264x144
    for shape in ((8, 128, 128, c), (32, 66, 36, c)):
        x = torch.randn(*shape, generator=torch.Generator().manual_seed(34)).to(dev, torch.bfloat16)
        out = fused_resnet_block(x, w1, b1, w2, b2, packed=packed)
        ref = resnet_block_reference(x, w1, b1, w2, b2).float()
        bar = 2.0 ** -7 * (ref.abs() + (ref - x.float()).abs() + 1)
        worst = ((out.float() - ref).abs() / bar).max().item()
        db = psnr(out.float().cpu(), ref.cpu(), ref.abs().max().item())
        del out, ref, bar
        t = cuda_ms(lambda: fused_resnet_block(x, w1, b1, w2, b2, packed=packed), reps=10)
        n_px = shape[0] * shape[1] * shape[2]
        f = 2 * 2 * 9 * c * c * n_px
        bd = bound(f, 2 * n_px * c * 2 + 2 * 9 * c * c * 2 + 2 * c * 4)
        print(f"[resnet_block] {shape} bf16 (the batched path): {worst:.2f} of the ulp bar, PSNR "
              f"{db:.1f} dB (bar {RB_PSNR_DB}); kernel {t:.3f} ms, bound {bd['bound_ms']:.3f} ms, "
              f"{f / t / 1e9:.1f} TFLOP/s, {100 * bd['bound_ms'] / t:.1f}% of the bound",
              flush=True)
        if worst > 1.0 or db < RB_PSNR_DB:
            fail(f"fused_resnet_block disagrees with resnet_block_reference at {shape}")
    return row


def exact_stats_norm(torch, acc):
    """relu(instance norm) of bf16(acc) as the plain composition computes
    it, but with float64 statistics rounded once to fp32."""
    x = acc.to(torch.bfloat16)
    x64 = x.double()
    mean = x64.mean(dim=(1, 2), keepdim=True)
    var = (x64 - mean).square().mean(dim=(1, 2), keepdim=True)
    return torch.relu(((x.float() - mean.float()) * torch.rsqrt(var.float() + 1e-5))
                      .to(torch.bfloat16))


def phase_instance_norm(dev):
    """Row 7 of the kernel table: fused_instance_norm (ops/instance_norm.py)
    at the CycleGAN cell's three norm shapes on an accumulator shifted by a
    bias (per-channel means about 40, spread 1): within one bf16 ulp of its
    plain composition, and at least 99.9% equal to that composition with
    float64 statistics and at least as often as the plain composition (whose
    fp32 mean over 141,312 pixels strays by a few ulps); then timed with CUDA events
    beside its bound (the fp32 accumulator read once and the bf16 output
    written once), the plain composition (the model's path off the kernel:
    the rounding, ``nn/functional.instance_norm``, ReLU) and PyTorch's
    ``F.instance_norm`` + ``torch.relu`` alone on the rounded bf16 tensor
    (the library yardstick)."""
    import torch
    import torch.nn.functional as TF

    from innfer_tpu_torch.ops import instance_norm as IN

    rows = []
    for shape in IN_SHAPES:
        g = torch.Generator().manual_seed(sum(shape))
        acc = (torch.randn(*shape, generator=g) + 40 + torch.randn(shape[-1], generator=g))
        acc = acc.to(dev)
        before = IN.fused_instance_norm.launches
        out = IN.fused_instance_norm(acc)
        plain = IN.instance_norm_reference(acc)
        torch.cuda.synchronize()
        if IN.fused_instance_norm.launches != before + 1:
            fail("fused_instance_norm: the wrapper did not launch the kernel")
        err = (out.float() - plain.float()).abs().max().item()
        exact = exact_stats_norm(torch, acc)
        equal, e_out, e_plain = ((a == b).float().mean().item()
                                 for a, b in ((out, plain), (out, exact), (plain, exact)))
        del exact
        if not within_one_ulp(out, plain) or e_out < 0.999 or e_out < e_plain:
            fail(f"fused_instance_norm {shape}: max_abs {err:.3g} against the plain composition "
                 f"({100 * equal:.4f}% equal); {100 * e_out:.4f}% equal to the float64-statistics "
                 f"composition, the plain composition {100 * e_plain:.4f}%")
        x = acc.to(torch.bfloat16)
        nchw = x.permute(0, 3, 1, 2)
        ms = cuda_ms(lambda: IN.fused_instance_norm(acc), reps=20)
        plain_ms = cuda_ms(lambda: IN.instance_norm_reference(acc), reps=5)
        library_ms = cuda_ms(lambda: torch.relu(TF.instance_norm(nchw)), reps=10)
        n = acc.numel()
        row = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
               **bound(0.0, 4 * n + 2 * n)}
        row.update(rates(0.0, ms, row["bound_ms"]))
        print(f"[instance_norm] {shape}: max_abs {err:.3g}, {100 * equal:.4f}% equal to the plain "
              f"composition (within one bf16 ulp); equal to the float64-statistics composition "
              f"{100 * e_out:.4f}% (the plain composition {100 * e_plain:.4f}%); kernel {ms:.4f} ms, bound {row['bound_ms']:.4f} "
              f"ms (bytes: {6 * n / 1e6:.1f} MB), {100 * row['bound_share']:.1f}% of the bound, "
              f"{10 * n / ms / 1e6:.0f} GB/s moved (2 fp32 reads, 1 bf16 write); "
              f"plain {plain_ms:.4f} ms, F.instance_norm + torch.relu on bf16 {library_ms:.4f} ms",
              flush=True)
        rows.append(row)
        del acc, out, plain, x, nchw
    return rows[0]


def phase_window_attn(dev, kernels=None):
    """Row 8 of the kernel table: window_attn (ops/window_attn.py) at the
    SwinIR cell's canvas, 6 heads of 30, shifted and not: >= 99.9% equal
    to its plain version and every value within two bf16 ulps of it (P is
    rounded to bf16 before P v: one flipped P moves an output by up to
    2^-9 |v|), >= 99.9% equal to that version in float64, and over both
    shifts at least as often as the plain version is (one draw's two shares
    differ by a handful of values either way); then timed
    with CUDA events beside its bound (q, k, v read once and the output
    written once, unpadded: 1,440 B a token), the plain version, and
    PyTorch's scaled_dot_product_attention on windows partitioned
    beforehand (a yardstick only: the port never calls it).  Then
    fused_layer_norm at the cell's tokens beside its bound and PyTorch's
    LayerNorm with the affine in bf16.  ``kernels``: the libraries' ptxas
    reports, for registers and spills."""
    import torch
    import torch.nn.functional as TF

    from innfer_tpu_torch.ops import layer_norm as LNK
    from innfer_tpu_torch.ops import window_attn as WA

    b, hp, wp = SWIN_CANVAS
    heads, hd = SWIN_HEADS, SWIN_HD
    c = heads * hd
    g = torch.Generator().manual_seed(81)
    wq = torch.randn(3 * c, c, generator=g) / c ** 0.5
    wpk, bpk = WA.pack_qkv(wq, torch.randn(3 * c, generator=g) * 0.1, heads, WA.padded(c))
    x = TF.pad(torch.randn(b, hp, wp, c, generator=g) * 1.5, (0, WA.padded(c) - c)).to(dev)
    qkv = (x @ wpk.to(dev).t() + bpk.to(dev)).to(torch.bfloat16)
    del x
    bias = WA.gather_bias(torch.randn(225, heads, generator=g).to(dev), 8)
    row, pooled = None, [0.0, 0.0]
    for shift in (0, 4):
        kw = dict(heads=heads, head_dim=hd, window=8, shift=shift)
        before = WA.window_attn.launches
        out = WA.window_attn(qkv, bias, **kw)
        plain = WA.window_attn_reference(qkv, bias, **kw)
        exact = WA.window_attn_reference(qkv, bias, acc=torch.float64, **kw)
        torch.cuda.synchronize()
        if WA.window_attn.launches != before + 1:
            fail("window_attn: the wrapper did not launch the kernel")
        err = (out.float() - plain.float()).abs().max().item()
        equal, e_out, e_plain = ((u == v).float().mean().item()
                                 for u, v in ((out, plain), (out, exact), (plain, exact)))
        del exact
        ulp = 2 ** -7 * plain.float().abs() + 1e-3 * max(1.0, plain.float().abs().max().item())
        two_ulps = bool(((out.float() - plain.float()).abs() <= 2 * ulp).all())
        pooled[0] += e_out
        pooled[1] += e_plain
        if not two_ulps or equal < 0.999 or e_out < 0.999:
            fail(f"window_attn shift {shift}: max_abs {err:.3g}, {100 * equal:.4f}% equal to the "
                 f"plain version; {100 * e_out:.4f}% equal to the float64 version, the plain "
                 f"version {100 * e_plain:.4f}%")
        ms = cuda_ms(lambda: WA.window_attn(qkv, bias, **kw), reps=20)
        plain_ms = cuda_ms(lambda: WA.window_attn_reference(qkv, bias, **kw), reps=3)
        n = b * hp * wp
        row = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
               **bound(4.0 * 64 * c * n, 8 * c * n)}
        row.update(rates(4.0 * 64 * c * n, ms, row["bound_ms"]))
        print(f"[window_attn] {SWIN_CANVAS} shift {shift}: max_abs {err:.3g}, {100 * equal:.4f}% "
              f"equal to the plain version (all within two bf16 ulps); equal to the float64 "
              f"version "
              f"{100 * e_out:.4f}% (the plain version {100 * e_plain:.4f}%); kernel {ms:.4f} ms, "
              f"bound {row['bound_ms']:.4f} ms ({row['bound_by']}: {8 * c * n / 1e6:.1f} MB), "
              f"{100 * row['bound_share']:.1f}% of the bound; plain {plain_ms:.3f} ms",
              flush=True)
        del out, plain
    if pooled[0] < pooled[1]:
        fail(f"window_attn: over both shifts {50 * pooled[0]:.5f}% equal to the float64 version, "
             f"the plain version {50 * pooled[1]:.5f}%")
    win = qkv.reshape(b, hp // 8, 8, wp // 8, 8, 3, heads, WA.HEAD_STRIDE)[..., :hd]
    q, k, v = win.permute(5, 0, 1, 3, 6, 2, 4, 7).reshape(3, -1, heads, 64, hd).unbind(0)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    mask = bias.to(torch.bfloat16)[None]
    row["library_ms"] = cuda_ms(lambda: TF.scaled_dot_product_attention(q, k, v, attn_mask=mask),
                                reps=10)
    reg = {name: next((r for f, r in (kernels or {}).get(name, {}).items() if key in f), None)
           for name, key in (("window_attn", "winattn_fwd"), ("layer_norm", "lnorm_rows"))}
    print(f"[window_attn] winattn_fwd: "
          + (f"{reg['window_attn']['regs']} registers, {reg['window_attn']['spill']} B spilled; "
             if reg["window_attn"] else "no ptxas report (library already built); ")
          + f"scaled_dot_product_attention on windows partitioned beforehand (no roll, no "
          f"reverse; the yardstick) {row['library_ms']:.4f} ms", flush=True)
    del q, k, v, win, qkv
    t = (torch.randn(b, hp, wp, c, generator=g) * 2 + torch.randn(c, generator=g)).to(
        dev, torch.bfloat16)
    w = (1 + 0.3 * torch.randn(c, generator=g)).to(dev)
    bb = (0.2 * torch.randn(c, generator=g)).to(dev)
    out = LNK.fused_layer_norm(t, w, bb, out_width=WA.padded(c))
    plain = LNK.layer_norm_reference(t, w, bb, out_width=WA.padded(c))
    equal = (out == plain).float().mean().item()
    if equal < 0.999:
        fail(f"fused_layer_norm: {100 * equal:.4f}% equal to its plain version")
    ms = cuda_ms(lambda: LNK.fused_layer_norm(t, w, bb, out_width=WA.padded(c)), reps=20)
    lib_ms = cuda_ms(lambda: TF.layer_norm(t, (c,), w.to(torch.bfloat16), bb.to(torch.bfloat16)),
                     reps=20)
    ln_bound = 4 * c * b * hp * wp / HBM_BPS * 1e3
    print(f"[window_attn] fused_layer_norm {tuple(t.shape)} -> {WA.padded(c)}: "
          f"{100 * equal:.4f}% equal to its plain version; {ms:.4f} ms, bound {ln_bound:.4f} ms, "
          f"{100 * ln_bound / ms:.1f}% of it; "
          + (f"{reg['layer_norm']['regs']} registers, {reg['layer_norm']['spill']} B spilled; "
             if reg["layer_norm"] else "")
          + f"F.layer_norm with a bf16 affine {lib_ms:.4f} ms", flush=True)
    return row


def phase_token_gemm(dev, kernels=None) -> dict:
    """Row 10 of the kernel table: token_linear (ops/token_gemm.py) at the
    SwinIR cell's tokens (544 x 960), as a layer runs proj and fc2 with the
    residual and fc1 with GELU, on weights packed as ``swin_layer`` packs
    them: >= 99.9% equal to its plain version and every value within one
    bf16 ulp of the linear's output plus one of the result; then timed with
    CUDA events beside its bound (the tokens read once at the width they
    are stored, the residual read once, the output and the weight once),
    the plain composition (``token_linear_reference``) and the library pair
    as the yardstick (torch.addmm, then torch.add or GELU: the port never
    calls it so).  ``kernels``: the libraries' ptxas reports.  Returns a
    row per linear."""
    import torch
    import torch.nn.functional as TF

    from innfer_tpu_torch.nn import functional as NF
    from innfer_tpu_torch.ops import token_gemm as TG

    n_tok = math.prod(SWIN_CANVAS)
    g = torch.Generator(device=dev).manual_seed(91)
    rn = lambda *shape: torch.randn(*shape, generator=g, device=dev)  # noqa: E731
    reg = {f: r for f, r in (kernels or {}).get("token_gemm", {}).items()}
    rows = {}
    for site, (kin, n, epilogue) in TOKEN_SITES.items():
        k = kin if site == "fc2" else kin + 4
        x = TF.pad(TF.gelu(rn(n_tok, kin)) if site == "fc2" else rn(n_tok, kin),
                   (0, k - kin)).to(torch.bfloat16)
        scale = 0.4 if epilogue == "residual" else 1.0
        w = TF.pad(rn(n, kin) * scale / kin ** 0.5, (0, k - kin)).to(torch.bfloat16)
        b = (rn(n) * 0.1).to(torch.bfloat16)
        res = (rn(n_tok, n) * 2).to(torch.bfloat16) if epilogue == "residual" else None
        kw = dict(epilogue=epilogue, residual=res)
        before = TG.token_linear.launches
        out = TG.token_linear(x, w, b, **kw)
        plain = TG.token_linear_reference(x, w, b, **kw)
        y = NF.linear(x, w, b)
        torch.cuda.synchronize()
        if TG.token_linear.launches != before + 1:
            fail(f"token_linear {site}: the wrapper did not launch the kernel")
        ref = plain.float()
        err = (out.float() - ref).abs()
        tol = 2 ** -7 * (ref.abs() + y.float().abs()) + 1e-3 * max(1.0, ref.abs().max().item())
        within = bool((err <= tol).all())
        equal = (out == plain).float().mean().item()
        if not within or equal < 0.999:
            fail(f"token_linear {site}: {100 * equal:.4f}% equal to its plain version, within "
                 f"one ulp of y plus one of the result: {within}")
        del y, tol, plain, ref
        ms = cuda_ms(lambda: TG.token_linear(x, w, b, **kw), reps=20)
        plain_ms = cuda_ms(lambda: TG.token_linear_reference(x, w, b, **kw), reps=10)
        wt = w.t()
        if epilogue == "residual":
            lib_ms = cuda_ms(lambda: torch.add(res, torch.addmm(b, x, wt)), reps=10)
        else:
            lib_ms = cuda_ms(lambda: TF.gelu(torch.addmm(b, x, wt)), reps=10)
        nbytes = 2 * (n_tok * k + n_tok * n * (2 if res is not None else 1) + n * k + n)
        row = {"max_abs_err": err.max().item(), "ms": ms, "plain_ms": plain_ms,
               "library_ms": lib_ms, **bound(2.0 * n_tok * k * n, nbytes)}
        row.update(rates(2.0 * n_tok * k * n, ms, row["bound_ms"]))
        r = next((r for f, r in reg.items() if re.search(
            rf"token_gemmILi{k}ELi\d+ELi\d+ELi{n}ELi{int(epilogue == 'gelu')}E", f)), None)
        print(f"[token_gemm] {site} ({n_tok}, {k}) -> {n} with the {epilogue}: "
              f"{100 * equal:.4f}% equal to the plain version, all within one ulp of y plus one; "
              f"kernel {ms:.4f} ms, bound {row['bound_ms']:.4f} ms ({row['bound_by']}: "
              f"{nbytes / 1e6:.1f} MB), {100 * row['bound_share']:.1f}% of the bound; plain "
              f"{plain_ms:.4f} ms; torch.addmm + {'add' if res is not None else 'GELU'} "
              f"{lib_ms:.4f} ms"
              + (f"; {r['regs']} registers, {r['spill']} B spilled" if r else ""), flush=True)
        rows[site] = row
        del x, w, b, res, out, err
    total = sum(r["ms"] for r in rows.values())
    floor = sum(r["bound_ms"] for r in rows.values())
    print(f"[token_gemm] a layer's three: {total:.4f} ms against a bound of {floor:.4f} ms "
          f"({100 * floor / total:.1f}%); 36 layers a SwinIR-M frame: {36 * total:.2f} ms",
          flush=True)
    return rows


def phase_swinir(dev, work):
    """SwinIR-M real-world x4 at its published widths (the benchmark's
    seeded weights, ``innbench/reference/swinir.py``) through
    InferenceSession with ``arch: infer`` in bf16, auto -> hybrid on the
    544 x 960 canvas, on a seeded 540 x 960 frame: 36 window_attn, 74
    fused_layer_norm, 108 token_linear (proj, fc1 and fc2 of 36 layers) and
    4 tail conv launches a frame, the frame's ms, and >= 40 dB against
    ``ops.plain_path``."""
    import json as _json

    import numpy as np
    import torch

    from innbench.reference import swinir as SR
    from innfer_tpu_torch.ops import plain_path
    from innfer_tpu_torch.pipeline import InferenceSession, select_presets

    with open(os.path.join(HERE, "innbench", "configs", "swinir_m_x4.json")) as f:
        model = _json.load(f)["model"]
    ckpt = os.path.join(work, "4x_swinir_m_x4.pth")
    state = SR.make_state(model, 22, dev)
    torch.save({"params_ema": {k: v.cpu() for k, v in state.items()}}, ckpt)
    del state
    sess = InferenceSession(ckpt, arch="infer", presets=select_presets("infer", ckpt),
                            compute_dtype=torch.bfloat16, tile=256, overlap=16,
                            tile_mode="auto", tile_batch=8)
    frame = synth_image(*SWIN_FRAME, seed=23)
    sess.run_image(frame)
    torch.cuda.synchronize()
    reset_counts()
    reps = 3
    t0 = time.perf_counter()
    for _ in range(reps):
        out = sess.run_image(frame)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / reps * 1e3
    counts = {k: v / reps for k, v in read_counts().items() if v}
    with plain_path():
        plain = sess.run_image(frame)
    runner = sess.stages[0].runner
    plan = runner.plan_for(*SWIN_FRAME, True)
    db = psnr(out, plain, 255.0)
    print(f"[swinir] SwinIR-M x4 {SWIN_FRAME[0]}x{SWIN_FRAME[1]} bf16: {runner.last_mode} on "
          f"{plan.pad_h}x{plan.pad_w}, {plan.n_tiles} tail tiles; {ms:.2f} ms a frame; launches "
          f"a frame {counts}; {db:.2f} dB against ops.plain_path", flush=True)
    want = {"window_attn": 36, "fused_layer_norm": 74, "tail_conv": 4, "token_linear": 108}
    if runner.last_mode != "hybrid" or (plan.pad_h, plan.pad_w) != (544, 960) or \
            counts != want or db < MIN_PSNR_DB or out.shape != (2160, 3840, 3):
        fail(f"[swinir] want hybrid on 544x960, launches {want} and >= {MIN_PSNR_DB} dB")
    return counts


def phase_hat_attn(dev, kernels=None) -> dict:
    """Rows 11 and 12 of the kernel table: hat_window_attn and overlap_attn
    (ops/hat_attn.py) at the HAT cell's canvas (1, 544, 960), 6 heads of 30,
    the HAB's at shifts 0 and 8: >= 99.8% equal to the plain version, every
    value within two bf16 ulps of it (P is rounded to bf16 before P v: a
    flipped P moves an output by up to 2^-9 |v|), >= 99.7% equal to the
    plain version in float64 (the tensor cores' fp32 sums and the SFU's
    exp2 each flip a rounding now and then); then timed with CUDA events
    beside the bound (q, k, v read once and the output written once,
    unpadded: 1,440 B a token), the plain version, and PyTorch's
    scaled_dot_product_attention on windows partitioned beforehand with
    the gathered bias as its mask (a yardstick: the port never calls it).
    ``kernels``: the libraries' ptxas reports.  Returns a row per site."""
    import torch
    import torch.nn.functional as TF

    from innfer_tpu_torch.ops import hat_attn as HA
    from innfer_tpu_torch.ops import window_attn as WA

    b, hp, wp = SWIN_CANVAS
    heads, hd = SWIN_HEADS, SWIN_HD
    c = heads * hd
    g = torch.Generator().manual_seed(84)
    wq = torch.randn(3 * c, c, generator=g) / c ** 0.5
    wpk, bpk = WA.pack_qkv(wq, torch.randn(3 * c, generator=g) * 0.1, heads, WA.padded(c))
    x = TF.pad(torch.randn(b, hp, wp, c, generator=g) * 1.5, (0, WA.padded(c) - c)).to(dev)
    qkv = (x @ wpk.to(dev).t() + bpk.to(dev)).to(torch.bfloat16)
    del x
    reg = {f: r for f, r in (kernels or {}).get("hat_attn", {}).items()}
    n = b * hp * wp
    rows = {}
    for site, kw in HAT_SITES.items():
        oca = "kwin" in kw
        fn, ref = ((HA.overlap_attn, HA.overlap_attn_reference) if oca else
                   (HA.hat_window_attn, HA.hat_window_attn_reference))
        rows_t = (16 + 24 - 1) ** 2 if oca else 31 ** 2
        table = torch.randn(rows_t, heads, generator=g).to(dev)
        kw = dict(heads=heads, head_dim=hd, **kw)
        before = fn.launches
        out = fn(qkv, table, **kw)
        plain = ref(qkv, table, **kw)
        exact = ref(qkv, table, acc=torch.float64, **kw)
        torch.cuda.synchronize()
        if fn.launches != before + 1:
            fail(f"{fn.__name__}: the wrapper did not launch the kernel")
        err = (out.float() - plain.float()).abs().max().item()
        equal, e_out, e_plain = ((u == v).float().mean().item()
                                 for u, v in ((out, plain), (out, exact), (plain, exact)))
        del exact
        ulp = 2 ** -7 * plain.float().abs() + 1e-3 * max(1.0, plain.float().abs().max().item())
        two_ulps = bool(((out.float() - plain.float()).abs() <= 2 * ulp).all())
        pad_zero = bool((out[..., c:] == 0).all())
        if not two_ulps or not pad_zero or equal < 0.998 or e_out < 0.997:
            fail(f"{fn.__name__} {site}: max_abs {err:.3g}, {100 * equal:.4f}% equal to the "
                 f"plain version, within two ulps {two_ulps}, padding zero {pad_zero}; "
                 f"{100 * e_out:.4f}% equal to the float64 version (the plain version "
                 f"{100 * e_plain:.4f}%)")
        ms = cuda_ms(lambda: fn(qkv, table, **kw), reps=20)
        plain_ms = cuda_ms(lambda: ref(qkv, table, **kw), reps=2)
        keys = (24 if oca else 16) ** 2
        row = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
               **bound(4.0 * keys * c * n * 540 / 544, 8 * c * n * 540 / 544)}
        row.update(rates(4.0 * keys * c * n * 540 / 544, ms, row["bound_ms"]))
        # the yardstick: SDPA on windows (and unfolded key windows) cut beforehand
        q, k, v = HA._heads(qkv, heads, hd)
        q = HA._partition(q, 16)
        if oca:
            k, v = (TF.unfold(t.flatten(3).permute(0, 3, 1, 2), 24, padding=4, stride=16)
                    .reshape(b, heads, hd, 576, -1).permute(0, 4, 1, 3, 2)
                    .reshape(-1, heads, 576, hd) for t in (k, v))
            idx = HA.oca_index(16, 24, dev)
        else:
            k, v = HA._partition(k, 16), HA._partition(v, 16)
            idx = HA.sa_index(16, dev)
        mask = HA._bias(table, idx, torch.float32).to(torch.bfloat16)[None]
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        row["library_ms"] = cuda_ms(
            lambda: TF.scaled_dot_product_attention(q, k, v, attn_mask=mask), reps=5)
        del q, k, v, mask
        r = next((r for f, r in reg.items() if ("hatattn_oca" if oca else "hatattn_sa") in f),
                 None)
        print(f"[hat_attn] {fn.__name__} {site} {SWIN_CANVAS}: max_abs {err:.3g}, "
              f"{100 * equal:.4f}% equal to the plain version (all within two bf16 ulps); equal "
              f"to the float64 version {100 * e_out:.4f}% (the plain version "
              f"{100 * e_plain:.4f}%); kernel {ms:.4f} ms, bound {row['bound_ms']:.4f} ms "
              f"({row['bound_by']}: {8 * c * n * 540 / 544 / 1e6:.1f} MB unpadded), "
              f"{100 * row['bound_share']:.1f}% of the bound; plain {plain_ms:.3f} ms; "
              f"scaled_dot_product_attention on windows cut beforehand {row['library_ms']:.4f} "
              f"ms" + (f"; {r['regs']} registers, {r['spill']} B spilled" if r else ""),
              flush=True)
        rows[site] = row
        del out, plain, table
    return rows


def phase_hat(dev, work):
    """Real-HAT-GAN x4 at its published widths (the benchmark's seeded
    weights, ``innbench/reference/hat.py``) through InferenceSession with
    ``arch: infer`` in bf16, auto -> hybrid on the 544 x 960 canvas, on a
    seeded 540 x 960 frame: 36 hat_window_attn, 6 overlap_attn, 86
    fused_layer_norm, 126 token_linear and 3 tail conv launches a frame, the
    frame's ms, and >= 40 dB against ``ops.plain_path``."""
    import json as _json

    import torch

    from innbench.reference import hat as HR
    from innfer_tpu_torch.ops import plain_path
    from innfer_tpu_torch.pipeline import InferenceSession, select_presets

    with open(os.path.join(HERE, "innbench", "configs", "hat_x4.json")) as f:
        model = _json.load(f)["model"]
    ckpt = os.path.join(work, "4x_hat_x4.pth")
    state = HR.make_state(model, 24, dev)
    torch.save({"params_ema": {k: v.cpu() for k, v in state.items()}}, ckpt)
    del state
    sess = InferenceSession(ckpt, arch="infer", presets=select_presets("infer", ckpt),
                            compute_dtype=torch.bfloat16, tile=256, overlap=16,
                            tile_mode="auto", tile_batch=8)
    frame = synth_image(*SWIN_FRAME, seed=25)
    sess.run_image(frame)
    torch.cuda.synchronize()
    reset_counts()
    reps = 3
    t0 = time.perf_counter()
    for _ in range(reps):
        out = sess.run_image(frame)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / reps * 1e3
    counts = {k: v / reps for k, v in read_counts().items() if v}
    with plain_path():
        plain = sess.run_image(frame)
    runner = sess.stages[0].runner
    plan = runner.plan_for(*SWIN_FRAME, True)
    db = psnr(out, plain, 255.0)
    print(f"[hat] Real-HAT-GAN x4 {SWIN_FRAME[0]}x{SWIN_FRAME[1]} bf16: {runner.last_mode} on "
          f"{plan.pad_h}x{plan.pad_w}, {plan.n_tiles} tail tiles; {ms:.2f} ms a frame; launches "
          f"a frame {counts}; {db:.2f} dB against ops.plain_path", flush=True)
    want = {"hat_window_attn": 36, "overlap_attn": 6, "fused_layer_norm": 86, "tail_conv": 3,
            "token_linear": 126}
    if runner.last_mode != "hybrid" or (plan.pad_h, plan.pad_w) != (544, 960) or \
            counts != want or db < MIN_PSNR_DB or out.shape != (2160, 3840, 3):
        fail(f"[hat] want hybrid on 544x960, launches {want} and >= {MIN_PSNR_DB} dB")
    return counts


def synth_cyclegan_state(torch, seed, n_blocks=CG_BLOCKS, ngf=CG_NGF):
    """A seeded random-init CycleGAN resnet generator state dict in the
    reference's key layout (a copy of tools/synth_params.py's
    cyclegan_state layout), plus the running-stat keys a pre-0.4
    InstanceNorm checkpoint carries, which non-strict loading drops."""
    g = torch.Generator().manual_seed(seed)
    state = {}

    def conv(key, o, i, k=3, transposed=False):
        std = 1.0 / math.sqrt(i * k * k)
        shape = (i, o, k, k) if transposed else (o, i, k, k)
        state[f"{key}.weight"] = (torch.rand(*shape, generator=g) * 2 - 1) * std
        state[f"{key}.bias"] = (torch.rand(o, generator=g) * 2 - 1) * 0.01

    def legacy_norm(key, c):
        state[f"{key}.running_mean"] = torch.zeros(c)
        state[f"{key}.running_var"] = torch.ones(c)

    conv("model.1", ngf, 3, k=7)
    legacy_norm("model.2", ngf)
    conv("model.4", ngf * 2, ngf)
    legacy_norm("model.5", ngf * 2)
    conv("model.7", ngf * 4, ngf * 2)
    legacy_norm("model.8", ngf * 4)
    for i in range(n_blocks):
        for j in (1, 5):
            conv(f"model.{10 + i}.conv_block.{j}", ngf * 4, ngf * 4)
            legacy_norm(f"model.{10 + i}.conv_block.{j + 1}", ngf * 4)
    conv(f"model.{10 + n_blocks}", ngf * 2, ngf * 4, transposed=True)
    legacy_norm(f"model.{11 + n_blocks}", ngf * 2)
    conv(f"model.{13 + n_blocks}", ngf, ngf * 2, transposed=True)
    legacy_norm(f"model.{14 + n_blocks}", ngf)
    conv(f"model.{17 + n_blocks}", 3, ngf, k=7)
    return state


def time_stage(torch, sess) -> list:
    """Wrap the session's forward (its stages, and the guided filter where
    the preset runs it) with CUDA events; returns the list that gets one
    (start, end) pair per image."""
    forward, events = sess.forward, []

    def timed(x, **kw):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        out = forward(x, **kw)
        e1.record()
        events.append((e0, e1))
        return out

    sess.forward = timed
    return events


def phase_cyclegan(dev, work):
    """Path 1: the CycleGAN resnet_9blocks through the session."""
    import numpy as np
    import torch

    from innfer_tpu_torch.io import images as iio
    from innfer_tpu_torch.models import resnet as resnet_model
    from innfer_tpu_torch.ops import plain_path
    from innfer_tpu_torch.pipeline import InferenceSession, select_presets

    ckpt = os.path.join(work, "cyclegan9_synth.pth")
    torch.save(synth_cyclegan_state(torch, seed=40), ckpt)
    in_dir = os.path.join(work, "cg_in")
    os.makedirs(in_dir)
    sizes = {"a_512x512": (512, 512), "b_1080x1920": (1080, 1920)}
    for i, (name, (h, w)) in enumerate(sizes.items()):
        iio.save_img(synth_image(h, w, seed=41 + i), os.path.join(in_dir, f"{name}.png"))
    presets = select_presets("resnet_9blocks")
    kw = dict(arch="resnet_9blocks", presets=presets, compute_dtype=torch.bfloat16,
              tile_mode="auto")
    sess = InferenceSession(ckpt, **kw)
    cfg, params = sess.stages[0].model.cfg, sess.stages[0].params
    if (cfg["n_blocks"], params["model.1.weight"].shape[0]) != (CG_BLOCKS, CG_NGF):
        fail(f"the session built {cfg} with ngf {params['model.1.weight'].shape[0]}")
    if presets.strict or any("running_" in k for k in params):
        fail("the cyclegan preset did not drop the legacy InstanceNorm keys")
    model, runner = sess.stages[0].model, sess.stages[0].runner
    groups = {}
    for name, (h, w) in sizes.items():
        plan = runner.plan_for(h, w, on_cuda=True)
        chunk = plan.chunk or min(runner.tile_batch, plan.n_tiles)
        groups[name] = (-(-plan.n_tiles // chunk), plan.tile_h, plan.tile_w, plan.n_tiles, chunk)
    events = time_stage(torch, sess)
    blocks = []  # (image index, CUDA events) of each fused_resnet_block call

    def timed_block(*args, **kw):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        out = block_fn(*args, **kw)
        e1.record()
        blocks.append((len(events), e0, e1))
        return out

    block_fn = resnet_model.fused_resnet_block
    resnet_model.fused_resnet_block = timed_block
    out_dir = os.path.join(work, "cg_out_kernel")
    try:
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        written = sess.process(in_dir, out_dir, verbose=False)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = read_counts()
    finally:
        resnet_model.fused_resnet_block = block_fn
    n_groups = sum(g[0] for g in groups.values())
    want = {"fused_rdb": 0, "fused_rdb_padded": 0, "fused_rrdb_trunk": 0, "tail_conv": 0,
            "fused_dilated_block": 0, "fused_resnet_block": CG_BLOCKS * n_groups,
            "fused_instance_norm": CG_NORMS * n_groups, "window_attn": 0, "fused_layer_norm": 0,
            "token_linear": 0, "hat_window_attn": 0, "overlap_attn": 0}
    if runner.last_mode != "auto":
        fail(f"tile_mode auto ran {runner.last_mode!r} for the CycleGAN")
    if counts != want:
        fail(f"CycleGAN session launches {counts}; expected {want} (plans {groups})")
    device_ms = [a.elapsed_time(b) for a, b in events]
    block_ms = [sum(a.elapsed_time(b) for i, a, b in blocks if i == k) for k in range(len(sizes))]

    ref_sess = InferenceSession(ckpt, **kw)
    ref_events = time_stage(torch, ref_sess)
    ref_dir = os.path.join(work, "cg_out_torch")
    t0 = time.perf_counter()
    with plain_path():
        ref_sess.process(in_dir, ref_dir, verbose=False)
    torch.cuda.synchronize()
    ref_wall = time.perf_counter() - t0
    if read_counts() != counts:
        fail("the plain path launched a kernel")
    dbs = []
    for (name, (h, w)), path in zip(sizes.items(), sorted(written)):
        out = iio.read_img(path)
        ref = iio.read_img(os.path.join(ref_dir, os.path.basename(path)))
        if out is None or out.shape != (h, w, 3) or out.dtype != np.uint8:
            fail(f"{path}: expected a ({h}, {w}, 3) uint8 PNG, read "
                 f"{None if out is None else (out.shape, out.dtype)}")
        if out.std() < 1.0:
            fail(f"{path}: the output is flat (std {out.std():.3f})")
        dbs.append(psnr(out, ref, 255.0))
    plans = "; ".join(f"{n} {g[3]} tiles of {g[1]}x{g[2]}, chunk {g[4]}, {g[0]} groups"
                      for n, g in groups.items())
    times = ", ".join(
        f"{n} {t:.1f} ms ({b:.1f} ms in the blocks' kernels, {t - b:.1f} ms outside them; "
        f"plain path {a.elapsed_time(z):.1f} ms)"
        for n, t, b, (a, z) in zip(sizes, device_ms, block_ms, ref_events))
    print(f"[cyclegan] resnet_9blocks ngf={CG_NGF}, {len(sizes)} images in bf16, mode "
          f"{runner.last_mode} ({plans}): fused_resnet_block launches "
          f"{counts['fused_resnet_block']}, fused_instance_norm {counts['fused_instance_norm']}; wall {wall:.3f} s for both (plain path "
          f"{ref_wall:.3f} s); CUDA events per image: {times}; PSNR vs the plain path "
          f"{', '.join(f'{d:.1f}' for d in dbs)} dB (bar {MIN_PSNR_DB})", flush=True)
    if min(dbs) < MIN_PSNR_DB:
        fail(f"CycleGAN kernel path vs torch path PSNR {min(dbs):.1f} dB < {MIN_PSNR_DB}")

    # fp32 on a small input: the kernel path is true fp32 end to end
    small = (torch.rand(1, 64, 96, 3, generator=torch.Generator().manual_seed(42)) * 2 - 1).to(dev)
    p32 = {k: v.float() for k, v in params.items()}
    a = model.apply(p32, small)
    with plain_path():
        b = model.apply(p32, small)
    db32 = psnr(a.cpu(), b.cpu(), 1.0)
    print(f"[cyclegan] fp32 (1,64,96,3): kernel path vs torch path PSNR {db32:.1f} dB (bar 80)",
          flush=True)
    if db32 < 80.0 or not torch.isfinite(a).all():
        fail(f"fp32 CycleGAN kernel path vs torch path PSNR {db32:.1f} dB < 80")
    return counts


class SynthState:
    """Seeded random-init tensors in a reference key layout: a copy of
    tools/synth_params.py's _Maker, in torch (convs uniform with variance
    1/(3 fan_in), biases and scalars small)."""

    def __init__(self, torch, seed):
        self.torch, self.g, self.state = torch, torch.Generator().manual_seed(seed), {}

    def _uniform(self, shape, bound):
        return (self.torch.rand(*shape, generator=self.g) * 2 - 1) * bound

    def conv(self, key, o, i, k=3, bias=True, dims=2, gain=1.0):
        shape = (o, i) + (k,) * dims
        self.state[f"{key}.weight"] = self._uniform(shape, gain / math.sqrt(i * k ** dims))
        if bias:
            self.state[f"{key}.bias"] = self._uniform((o,), 0.01)

    def deconv(self, key, i, o, k, bias=True):
        """A ConvTranspose2d weight, (I, O, k, k) as torch stores it."""
        self.state[f"{key}.weight"] = self._uniform((i, o, k, k), 1.0 / math.sqrt(i * k * k))
        if bias:
            self.state[f"{key}.bias"] = self._uniform((o,), 0.01)

    def conv1d(self, key, o, i):
        self.conv(key, o, i, k=1, dims=1)

    def batch_norm(self, key, c):
        self.state[f"{key}.weight"] = 1 + self._uniform((c,), 0.1)
        self.state[f"{key}.bias"] = self._uniform((c,), 0.1)
        self.state[f"{key}.running_mean"] = self._uniform((c,), 0.1)
        self.state[f"{key}.running_var"] = 1 + self._uniform((c,), 0.1)

    def scalar(self, key, v):
        self.state[key] = self.torch.full((1,), v)


def synth_srresnet_state(torch, seed, nb=16, nf=64):
    """tools/synth_params.py's srresnet_state at 4x: CNA, relu, no norm,
    pixelshuffle (the reference sr_resnet defaults)."""
    m = SynthState(torch, seed)
    m.conv("model.0", nf, 3)
    for i in range(nb):
        m.conv(f"model.1.sub.{i}.res.0", nf, nf)
        m.conv(f"model.1.sub.{i}.res.2", nf, nf)
    m.conv(f"model.1.sub.{nb}", nf, nf)
    for idx in (2, 5):
        m.conv(f"model.{idx}", nf * 4, nf)  # pixelshuffle conv
    m.conv("model.8", nf, nf)
    m.conv("model.10", 3, nf)
    return m.state


def synth_ppon_state(torch, seed, nb=24, nf=64):
    """tools/synth_params.py's ppon_state at 4x."""
    m = SynthState(torch, seed)

    def rrblock(prefix):
        for rb in ("RB1", "RB2", "RB3"):
            m.conv(f"{prefix}.{rb}.c1", nf, nf)
            for r in range(1, 9):
                m.conv(f"{prefix}.{rb}.d{r}", nf // 2, nf)
            m.conv(f"{prefix}.{rb}.c2", nf, nf * 4, k=1)

    m.conv("CFEM.0", nf, 3)
    for i in range(nb):
        rrblock(f"CFEM.1.sub.{i}")
    m.conv(f"CFEM.1.sub.{nb}", nf, nf)
    for i in range(2):
        rrblock(f"SFEM.{i}")
        rrblock(f"PFEM.{i}")
    for mod in ("CRM", "SRM", "PRM"):
        for u in range(2):
            m.conv(f"{mod}.{3 * u + 1}", nf, nf)
        m.conv(f"{mod}.6", nf, nf)
        m.conv(f"{mod}.8", 3, nf)
    return m.state


def synth_pan_state(torch, seed, nb=16, nf=40, unf=24):
    """tools/synth_params.py's pan_state at 4x with self-attention."""
    m = SynthState(torch, seed)
    m.conv("conv_first", nf, 3)
    gw = nf // 2
    for i in range(nb):
        p = f"SCPA_trunk.{i}"
        m.conv(f"{p}.conv1_a", gw, nf, k=1, bias=False)
        m.conv(f"{p}.conv1_b", gw, nf, k=1, bias=False)
        m.conv(f"{p}.k1.0", gw, gw, bias=False)
        m.conv(f"{p}.PACnv.k2", gw, gw, k=1)
        m.conv(f"{p}.PACnv.k3", gw, gw, bias=False)
        m.conv(f"{p}.PACnv.k4", gw, gw, bias=False)
        m.conv(f"{p}.conv3", nf, nf, k=1, bias=False)
    m.conv("trunk_conv", nf, nf)
    m.conv1d("FSA.conv_f", nf // 8, nf)
    m.conv1d("FSA.conv_g", nf // 8, nf)
    m.conv1d("FSA.conv_h", nf, nf)
    m.scalar("FSA.gamma", 0.1)
    cin = nf
    for u in range(2):  # 4x: two pa_upconv blocks of 5 modules
        m.conv(f"upsample.{5 * u + 1}", unf, cin)
        m.conv(f"upsample.{5 * u + 2}.conv", unf, unf, k=1)
        m.conv(f"upsample.{5 * u + 4}", unf, unf)
        cin = unf
    m.conv("conv_last", 3, unf)
    return m.state


def synth_esrgan_variant_state(torch, seed, *, norm, mode, act, nb=2, nf=NF, gc=GC):
    """A 4x ESRGAN state dict of a conv_block variant (norm layers, NAC,
    prelu or swish), its keys laid out by the port's conv_block_layout:
    RDB conv blocks are CNA, the LR conv block follows ``mode``, and the
    acts of the upsample blocks and the first HR conv carry parameters."""
    from innfer_tpu_torch.models.common import conv_block_layout

    m = SynthState(torch, seed)

    def act_params(key):
        if act == "prelu":
            m.scalar(f"{key}.weight", 0.25)
        elif act == "swish":
            m.state[f"{key}.beta"] = torch.tensor(1.0)

    def block(key_of, o, i, block_mode, block_act):
        for j, kind in enumerate(conv_block_layout(block_mode, norm, block_act)):
            if kind == "conv":
                m.conv(key_of(j), o, i)
            elif kind == "norm" and norm == "batch":
                m.batch_norm(key_of(j), i if block_mode == "NAC" else o)
            elif kind == "act":
                act_params(key_of(j))

    m.conv("model.0", nf, 3)
    for i in range(nb):
        for j in (1, 2, 3):
            for c in range(1, 6):
                block(lambda k, c=c: f"model.1.sub.{i}.RDB{j}.conv{c}.{k}",
                      gc if c < 5 else nf, nf + (c - 1) * gc, "CNA", act if c < 5 else None)
    block(lambda k: f"model.1.sub.{nb + k}", nf, nf, mode, None)
    for ci in (3, 6, 8):  # upconv convs and the first HR conv, each with its act
        m.conv(f"model.{ci}", nf, nf)
        act_params(f"model.{ci + 1}")
    m.conv("model.10", 3, nf)
    return m.state


def run_session(torch, sess, in_dir, out_dir, **kw):
    """Process a directory (``kw``: process's options) with the launch
    counts set to 0 just before; returns (written paths, wall s,
    CUDA-event ms per image, counts)."""
    events = time_stage(torch, sess)
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    written = sess.process(in_dir, out_dir, verbose=False, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return sorted(written), wall, [a.elapsed_time(b) for a, b in events], read_counts()


def card_vs_cpu_db(torch, model, params, x):
    """fp32 on the card against fp32 on the CPU, PSNR (peak max(1, |ref|));
    fails if the card's forward launched a kernel."""
    p_cpu = {k: v.float().cpu() for k, v in params.items()}
    p_dev = {k: v.float() for k, v in params.items()}
    pick = (lambda o: o) if model.output_index is None else (lambda o: o[model.output_index])
    reset_counts()
    a = pick(model.apply(p_dev, x.float())).cpu()
    if any(read_counts().values()):
        fail(f"{model.name} launched a kernel: {read_counts()}")
    b = pick(model.apply(p_cpu, x.float().cpu()))
    if not torch.isfinite(a).all():
        fail(f"{model.name}: non-finite fp32 output on the card")
    return psnr(a, b, max(1.0, b.abs().max().item()))


def phase_zoo(dev, work, main):
    """SRResNet, PAN and PPON through the session; the ESRGAN variants
    card vs CPU; the auto -> hybrid gate."""
    import numpy as np
    import torch

    from innfer_tpu_torch.config.defaults import get_network_config
    from innfer_tpu_torch.io import images as iio
    from innfer_tpu_torch.models import convert_state, get_network
    from innfer_tpu_torch.pipeline import InferenceSession, np2tensor
    from innfer_tpu_torch.tiling.engine import TiledRunner

    zoo = {"srresnet": (synth_srresnet_state, "sr_resnet", {"nf": 64, "nb": 16}),
           "pan": (synth_pan_state, "pan_net", {"nf": 40, "unf": 24, "nb": 16,
                                                "self_attention": True}),
           "ppon": (synth_ppon_state, "ppon", {"nf": 64, "nb": 24})}
    crop = iio.read_img(sorted(os.path.join(main["in_dir"], f)
                               for f in os.listdir(main["in_dir"]))[0])[:64, :64]
    rows = {}
    for i, (name, (make, kind, want)) in enumerate(zoo.items()):
        ckpt = os.path.join(work, f"4x_synth_{name}.pth")
        torch.save(make(torch, seed=50 + i), ckpt)
        sess = InferenceSession(ckpt, compute_dtype=torch.bfloat16, tile_mode="auto")
        model, runner = sess.stages[0].model, sess.stages[0].runner
        got = {k: model.cfg.get(k) for k in want}
        if model.name != kind or got != want or model.scale != 4:
            fail(f"auto-detection read the {name} checkpoint as {model.name} {model.cfg}")
        plans = {n: runner.plan_for(h, w, on_cuda=True) for n, (h, w) in main["sizes"].items()}
        out16, out32 = (os.path.join(work, f"zoo_{name}_{t}") for t in ("bf16", "fp32"))
        # the kernels' launches in one bf16 forward of a crop: the tail conv's
        # (SRResNet's 2x upsample block and phase tail, 4; PPON's, in each
        # of its three branches, 12; none of PAN's own) and PPON's 84
        # blocks; the session launches a multiple of them, and nothing else
        reset_counts()
        model.apply(sess.stages[0].params, np2tensor(crop, dtype=torch.bfloat16, device=dev))
        fwd = read_counts()
        per_fwd, dil_fwd = fwd["tail_conv"], fwd["fused_dilated_block"]
        written, wall, ms, counts = run_session(torch, sess, main["in_dir"], out16)
        mode = runner.last_mode
        tail, dil = counts.pop("tail_conv"), counts.pop("fused_dilated_block")
        want = {"srresnet": (4, 0), "pan": (0, 0), "ppon": (12, 84)}[name]
        if any(counts.values()) or (per_fwd, dil_fwd) != want or any(
                n % max(f, 1) or (n == 0) != (f == 0)
                for n, f in ((tail, per_fwd), (dil, dil_fwd))):
            fail(f"{name} launched {counts}, tail_conv {tail} ({per_fwd} a forward), "
                 f"fused_dilated_block {dil} ({dil_fwd} a forward); want {want} a forward")
        if name == "srresnet" and mode == "hybrid":
            fail("SRResNet's auto run went hybrid: its trunk runs no port kernel")
        if name == "ppon" and mode != "hybrid":
            fail(f"PPON's auto run took {mode}: its trunk runs the block kernel, so hybrid")
        sess32 = InferenceSession(ckpt, compute_dtype=torch.float32, tile_mode="auto")
        params32 = sess32.stages[0].params
        written32, wall32, ms32, _ = run_session(torch, sess32, main["in_dir"], out32)
        dbs = []
        for (n, (h, w)), a, b in zip(main["sizes"].items(), written, written32):
            out, ref = iio.read_img(a), iio.read_img(b)
            if out is None or out.shape != (4 * h, 4 * w, 3) or out.dtype != np.uint8:
                fail(f"{a}: expected a ({4 * h}, {4 * w}, 3) uint8 PNG")
            if out.std() < 1.0:
                fail(f"{a}: the output is flat (std {out.std():.3f})")
            dbs.append(psnr(out, ref, 255.0))
        db32 = card_vs_cpu_db(torch, model, params32,
                              np2tensor(crop, device=dev))
        extra = ""
        if name == "pan":
            parts = []
            for n, plan in plans.items():
                chunk = plan.chunk or min(runner.tile_batch, plan.n_tiles)
                npx = (plan.tile_h // 4) * (plan.tile_w // 4)
                parts.append(f"{n} {plan.n_tiles} tiles of {plan.tile_h}x{plan.tile_w}, chunk "
                             f"{chunk}, attention scores {chunk * npx * npx * 4 / 1e9:.2f} GB "
                             f"fp32 per tile group")
            extra = "; auto plan: " + "; ".join(parts)
        print(f"[zoo] {name} 4x {want}: mode {mode}; bf16 CUDA events per image "
              f"{', '.join(f'{n} {t:.1f} ms' for n, t in zip(main['sizes'], ms))}, wall "
              f"{wall:.3f} s for both; fp32 {', '.join(f'{t:.1f}' for t in ms32)} ms, wall "
              f"{wall32:.3f} s; bf16 vs fp32 u8 PSNR {', '.join(f'{d:.1f}' for d in dbs)} dB "
              f"(bar {ZOO_BF16_DB}); fp32 card vs CPU (1,64,64,3) {db32:.1f} dB "
              f"(bar {ZOO_FP32_DB}); tail_conv launches {tail} ({per_fwd} a forward), "
              f"fused_dilated_block {dil} ({dil_fwd} a forward), other kernels 0{extra}",
              flush=True)
        if min(dbs) < ZOO_BF16_DB:
            fail(f"{name}: bf16 vs fp32 PSNR {min(dbs):.1f} dB < {ZOO_BF16_DB}")
        if db32 < ZOO_FP32_DB:
            fail(f"{name}: fp32 card vs CPU PSNR {db32:.1f} dB < {ZOO_FP32_DB}")
        rows[name] = {"mode": mode, "ms": ms, "wall": wall, "ms32": ms32, "dbs": dbs,
                      "db32": db32, "dilated_launches": dil}

    x = np2tensor(crop, device=dev)
    variants = {"bn": ("batch", "CNA", "leakyrelu"), "nac_bn": ("batch", "NAC", "leakyrelu"),
                "in": ("instance", "CNA", "leakyrelu"), "prelu": (None, "CNA", "prelu"),
                "swish": (None, "CNA", "swish")}
    dbs = {}
    for i, (label, (norm, mode, act)) in enumerate(variants.items()):
        cfg = get_network_config({"type": "esrgan", "nb": 2, "nf": NF, "gc": GC,
                                  "norm_type": norm, "mode": mode, "act_type": act}, 4)
        model = get_network(cfg)
        state = synth_esrgan_variant_state(torch, 60 + i, norm=norm, mode=mode, act=act)
        dbs[label] = card_vs_cpu_db(torch, model, convert_state(model, state, device=dev), x)
    print(f"[zoo] ESRGAN variants nb=2 nf={NF} gc={GC}, fp32 card vs CPU on (1,64,64,3), "
          f"0 fused_rdb launches: {', '.join(f'{k} {d:.1f} dB' for k, d in dbs.items())} "
          f"(bar {ZOO_FP32_DB})", flush=True)
    if min(dbs.values()) < ZOO_FP32_DB:
        fail(f"an ESRGAN variant's fp32 card vs CPU PSNR is below {ZOO_FP32_DB}: {dbs}")

    # the auto -> hybrid gate, with the session's runner arguments: an
    # instance-norm trunk keeps the tile grid (and per-tile statistics)
    model = get_network(get_network_config({"type": "esrgan", "nb": 2, "norm_type": "instance"}, 4))
    runner = TiledRunner(model.apply, model.scale, mode="auto", trunk_fn=model.apply_trunk,
                         tail_fn=model.apply_tail, tail_halo=model.tail_halo,
                         trunk_kernel=model.trunk_kernel)
    img = next(iter(main["sizes"].values()))
    in_mode = runner.mode_for(*img, on_cuda=True)
    print(f"[zoo] auto -> hybrid gate on the card: instance-norm ESRGAN {in_mode}, "
          f"SRResNet {rows['srresnet']['mode']}, the main path's leakyrelu ESRGAN "
          f"{main['mode']}", flush=True)
    if in_mode != "auto" or main["mode"] != "hybrid":
        fail("the auto -> hybrid gate took the wrong mode")
    return rows


def ts_srresnet(torch, nf=64, nb=16):
    """A 4x SRResNet (pixelshuffle, relu) as a plain nn.Module, for the
    TorchScript phase."""
    nn = torch.nn

    class ResBlock(nn.Module):
        def __init__(self):
            super().__init__()
            self.c0 = nn.Conv2d(nf, nf, 3, padding=1)
            self.c1 = nn.Conv2d(nf, nf, 3, padding=1)

        def forward(self, x):
            return x + self.c1(torch.relu(self.c0(x)))

    class SRResNet(nn.Module):
        def __init__(self):
            super().__init__()
            self.head = nn.Conv2d(3, nf, 3, padding=1)
            self.body = nn.Sequential(*[ResBlock() for _ in range(nb)],
                                      nn.Conv2d(nf, nf, 3, padding=1))
            self.tail = nn.Sequential(
                nn.Conv2d(nf, 4 * nf, 3, padding=1), nn.PixelShuffle(2), nn.ReLU(),
                nn.Conv2d(nf, 4 * nf, 3, padding=1), nn.PixelShuffle(2), nn.ReLU(),
                nn.Conv2d(nf, nf, 3, padding=1), nn.ReLU(), nn.Conv2d(nf, 3, 3, padding=1))

        def forward(self, x):
            fea = self.head(x)
            return self.tail(fea + self.body(fea))

    return SRResNet().eval()


def phase_ts(dev, work, main):
    """A TorchScript archive through the session (arch 'ts') on the card."""
    import numpy as np
    import torch

    from innfer_tpu_torch.io import images as iio
    from innfer_tpu_torch.nn.functional import true_fp32
    from innfer_tpu_torch.pipeline import InferenceSession, np2tensor, select_presets

    torch.manual_seed(70)
    module = ts_srresnet(torch).to(dev)
    path = os.path.join(work, "4x_srresnet_ts.pt")
    torch.jit.trace(module, torch.rand(1, 3, 32, 32, device=dev)).save(path)
    in_dir = os.path.join(work, "ts_in")
    os.makedirs(in_dir)
    name, (h, w) = next(iter(main["sizes"].items()))
    src = os.path.join(main["in_dir"], f"{name}.png")
    os.symlink(src, os.path.join(in_dir, f"{name}.png"))
    sess = InferenceSession(path, arch="ts", tile_mode="auto")
    stage = sess.stages[0]
    if stage.model.scale != 4 or sess.compute_dtype != torch.float32:
        fail(f"TorchScript stage probed scale {stage.model.scale}, compute {sess.compute_dtype}")
    written, wall, ms, counts = run_session(torch, sess, in_dir, os.path.join(work, "ts_out"))
    if any(counts.values()):
        fail(f"the TorchScript path launched a kernel: {counts}")
    x = np2tensor(iio.read_img(src), device=dev)
    with torch.no_grad(), true_fp32(torch.float32):
        eager = module(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    stage.chop = False
    whole = stage(x)
    db_whole = psnr(whole.cpu(), eager.cpu(), 1.0)
    eager_u8 = np.round(np.clip(eager[0].cpu().numpy()[..., ::-1] * 255, 0, 255))
    tiled = iio.read_img(written[0])
    if tiled is None or tiled.shape != (4 * h, 4 * w, 3):
        fail(f"the TorchScript session wrote no ({4 * h}, {4 * w}, 3) PNG")
    db_tiled = psnr(tiled, eager_u8, 255.0)
    print(f"[ts] traced 4x SRResNet nf=64 nb=16 through InferenceSession(arch='ts'), fp32: "
          f"probed scale {stage.model.scale}; {name} {ms[0]:.1f} ms between CUDA events, wall "
          f"{wall:.3f} s; tiled u8 vs the eager module's whole-image forward {db_tiled:.1f} dB "
          f"(bar {MIN_PSNR_DB}); whole-image stage vs eager {db_whole:.1f} dB (bar 80)",
          flush=True)
    if db_tiled < MIN_PSNR_DB or db_whole < 80.0:
        fail(f"TorchScript stage PSNR tiled {db_tiled:.1f} / whole {db_whole:.1f} dB")
    return {"ms": ms[0], "wall": wall}


def synth_unet_state(torch, seed, num_downs=8, ngf=64):
    """A pix2pix UNet generator (``--netG unet_256``: batch norm, so the
    convs under a norm have no bias; deconv) in the reference's nested
    key layout, with the running statistics and ``num_batches_tracked``
    a trained checkpoint holds (tools/synth_params.py's unet_state)."""
    m = SynthState(torch, seed)
    outer = [3, ngf, ngf * 2, ngf * 4] + [ngf * 8] * (num_downs - 4)
    inner = [ngf, ngf * 2, ngf * 4, ngf * 8] + [ngf * 8] * (num_downs - 4)

    def bn(key, c):
        m.batch_norm(key, c)
        m.state[f"{key}.num_batches_tracked"] = torch.tensor(1000)

    pre = "model.model"
    for lv in range(num_downs):
        if lv == 0:
            m.conv(f"{pre}.0", inner[0], outer[0], k=4, bias=False)
            m.deconv(f"{pre}.3", inner[0] * 2, 3, k=4)
        elif lv == num_downs - 1:
            m.conv(f"{pre}.1", inner[lv], outer[lv], k=4, bias=False)
            m.deconv(f"{pre}.3", inner[lv], outer[lv], k=4, bias=False)
            bn(f"{pre}.4", outer[lv])
        else:
            m.conv(f"{pre}.1", inner[lv], outer[lv], k=4, bias=False)
            m.deconv(f"{pre}.5", inner[lv] * 2, outer[lv], k=4, bias=False)
            bn(f"{pre}.2", inner[lv])
            bn(f"{pre}.6", outer[lv])
        pre += ".1.model" if lv == 0 else ".3.model"
    return m.state


def synth_wbc_state(torch, seed, nf=32):
    """The White-box Cartoonization generator (tools/synth_params.py's
    wbc_state), He-uniform: with no norm and 13 convs in a row the
    1/(3 fan_in) init would shrink the signal to its biases."""
    m = SynthState(torch, seed)
    he = math.sqrt(6.0)
    for key, o, i, k in (("conv", nf, 3, 7), ("conv_1", nf, nf, 3), ("conv_2", nf * 2, nf, 3),
                         ("conv_3", nf * 2, nf * 2, 3), ("conv_4", nf * 4, nf * 2, 3)):
        m.conv(key, o, i, k=k, gain=he)
    for b in range(4):
        m.conv(f"block_{b}.conv1", nf * 4, nf * 4, gain=he)
        m.conv(f"block_{b}.conv2", nf * 4, nf * 4)
    for key, o, i, k in (("conv_5", nf * 2, nf * 4, 3), ("conv_6", nf * 2, nf * 2, 3),
                         ("conv_7", nf, nf * 2, 3), ("conv_8", nf, nf, 3), ("conv_9", 3, nf, 7)):
        m.conv(key, o, i, k=k, gain=he)
    return m.state


def u8_close(a, b) -> float:
    """The share of u8 values within one level."""
    import numpy as np

    return float((np.abs(np.asarray(a, np.int32) - np.asarray(b, np.int32)) <= 1).mean())


def phase_i2i(dev, work, main):
    """pix2pix UNet and WBC through the session with their presets, a
    wbc+wbc chain, -cf on the zoo's SRResNet, and the device filters
    alone, card vs CPU."""
    import numpy as np
    import torch

    from innfer_tpu_torch import pipeline
    from innfer_tpu_torch.io import images as iio
    from innfer_tpu_torch.ops.filters import color_fix, guided_filter
    from innfer_tpu_torch.pipeline import InferenceSession, np2tensor

    names = list(main["sizes"])
    src = {n: os.path.join(main["in_dir"], f"{n}.png") for n in names}
    gf_calls = []
    gf = pipeline.guided_filter

    def counted_gf(*a, **k):
        gf_calls.append(1)
        return gf(*a, **k)

    pipeline.guided_filter = counted_gf

    def warm_twice(sess, in_dir, out_dir, label, tail_per_fwd=0, **kw):
        """Process ``in_dir`` twice: the first pass carries cuDNN's set-up
        for each new shape, the second is the steady state.  Every
        kernel's launches must stay 0 in both, but tail_conv's: a positive
        multiple of ``tail_per_fwd`` where that is not 0; returns the
        written paths, the second pass's wall and ms per image, and the
        first's ms."""
        cold = run_session(torch, sess, in_dir, out_dir, **kw)
        warm = run_session(torch, sess, in_dir, out_dir, **kw)
        for run in (cold, warm):
            counts = dict(run[3])
            tail = counts.pop("tail_conv")
            if any(counts.values()) or (
                    tail % tail_per_fwd or tail == 0 if tail_per_fwd else tail):
                fail(f"{label} launched a port kernel: {run[3]} (tail_conv: "
                     f"{tail_per_fwd or 'none'} a forward)")
        return warm[0], warm[1], warm[2], cold[2]

    def session_pair(ckpt, in_dir, label, want_hw, **kw):
        """bf16 and fp32 sessions over ``in_dir``, each run twice
        (``warm_twice``); u8 PNGs of the wanted shapes, not flat; returns
        the fp32 session, the warm ms per image of both, walls and bf16 vs
        fp32 dB.  Prints the first pass's ms."""
        out = {}
        for tag, dt in (("bf16", torch.bfloat16), ("fp32", torch.float32)):
            sess = InferenceSession(ckpt, compute_dtype=dt, **kw)
            if any(st.chop for st in sess.stages):
                fail(f"{label}: the preset tiles the image; it must run whole")
            written, wall, ms, cold = warm_twice(sess, in_dir,
                                                 os.path.join(work, f"{label}_{tag}"),
                                                 f"{label} {tag}")
            print(f"[i2i] {label} {tag} first pass (cuDNN set-up of new shapes): "
                  f"{', '.join(f'{t:.2f}' for t in cold)} ms per image", flush=True)
            out[tag] = (sess, written, wall, ms)
        dbs = []
        for a, b, hw in zip(out["bf16"][1], out["fp32"][1], want_hw):
            x, y = iio.read_img(a), iio.read_img(b)
            if x is None or x.shape != hw + (3,) or x.dtype != np.uint8:
                fail(f"{a}: expected a {hw + (3,)} uint8 PNG")
            if x.std() < 1.0:
                fail(f"{a}: the output is flat (std {x.std():.3f})")
            dbs.append(psnr(x, y, 255.0))
        if min(dbs) < ZOO_BF16_DB:
            fail(f"{label}: bf16 vs fp32 u8 PSNR {min(dbs):.1f} dB < {ZOO_BF16_DB}")
        return out["fp32"][0], out["bf16"][3], out["fp32"][3], out["bf16"][2], \
            out["fp32"][2], dbs

    def report(label, shapes, ms16, ms32, wall16, wall32, dbs, db32, crop, extra=""):
        print(f"[i2i] {label}: second pass, bf16 CUDA events per image "
              f"{', '.join(f'{s} {t:.2f} ms' for s, t in zip(shapes, ms16))}, wall "
              f"{wall16:.3f} s; fp32 {', '.join(f'{t:.2f}' for t in ms32)} ms, wall "
              f"{wall32:.3f} s; bf16 vs fp32 u8 PSNR {', '.join(f'{d:.1f}' for d in dbs)} dB "
              f"(bar {ZOO_BF16_DB}); fp32 card vs CPU {crop} {db32:.1f} dB (bar {ZOO_FP32_DB}); "
              f"kernel launches 0{extra}", flush=True)
        if db32 < ZOO_FP32_DB:
            fail(f"{label}: fp32 card vs CPU PSNR {db32:.1f} dB < {ZOO_FP32_DB}")

    # pix2pix unet_256: linear_resize to multiples of 256, train-mode BN
    p2p_in = os.path.join(work, "p2p_in")
    os.makedirs(p2p_in)
    for n in names:
        os.symlink(src[n], os.path.join(p2p_in, f"{n}.png"))
    iio.save_img(synth_image(256, 256, seed=12), os.path.join(p2p_in, "c_256x256.png"))
    ckpt = os.path.join(work, "p2p_synth_unet256.pth")
    torch.save(synth_unet_state(torch, seed=80), ckpt)
    want = [tuple(-(-s // 256) * 256 for s in main["sizes"][n]) for n in names] + [(256, 256)]
    sess32, ms16, ms32, wall16, wall32, dbs = session_pair(ckpt, p2p_in, "pix2pix", want,
                                                           arch="unet_256")
    model = sess32.stages[0].model
    if (model.cfg["num_downs"], model.cfg["ngf"], model.cfg["meval"]) != (8, 64, False):
        fail(f"the pix2pix session built {model.cfg}")
    if sess32.presets.resize != 256 or not sess32.presets.normalize:
        fail(f"the pix2pix preset is {sess32.presets}")
    x = np2tensor(iio.read_img(os.path.join(p2p_in, "c_256x256.png")), normalize=True,
                  device=dev)
    db32 = card_vs_cpu_db(torch, model, sess32.stages[0].params, x)
    report("pix2pix unet_256 ngf=64, train-mode BN, linear_resize 256",
           [f"{h}x{w}" for h, w in want], ms16, ms32, wall16, wall32, dbs, db32, "(1,256,256,3)")

    # WBC, pt and tf checkpoints by their names, on the main path's PNGs
    crop = np2tensor(iio.read_img(src[names[0]])[:64, :64], normalize=True, device=dev)
    for i, mode in enumerate(("pt", "tf")):
        ckpt = os.path.join(work, "wbc_synth.pth" if mode == "pt" else "wbc_tf_synth.pth")
        torch.save(synth_wbc_state(torch, seed=81 + i), ckpt)
        del gf_calls[:]
        sess32, ms16, ms32, wall16, wall32, dbs = session_pair(
            ckpt, main["in_dir"], f"wbc_{mode}", [main["sizes"][n] for n in names])
        model = sess32.stages[0].model
        if (model.cfg["mode"], model.cfg["nf"], sess32.presets.use_guided_filter) != (mode, 32, True):
            fail(f"the WBC {mode} session built {model.cfg} with {sess32.presets}")
        if len(gf_calls) != 4 * len(names):  # bf16 and fp32, two passes each
            fail(f"WBC {mode}: the guided filter ran {len(gf_calls)} times for "
                 f"{4 * len(names)} images")
        db32 = card_vs_cpu_db(torch, model, sess32.stages[0].params, crop)
        report(f"WBC {mode} nf=32, modcrop 4, guided filter r=1 eps=5e-3", names, ms16, ms32,
               wall16, wall32, dbs, db32, "(1,64,64,3)")

    # a wbc+wbc chain at 540x960: two stages, the guided filter after each
    chain_in = os.path.join(work, "chain_in")
    os.makedirs(chain_in)
    os.symlink(src[names[0]], os.path.join(chain_in, f"{names[0]}.png"))
    second = os.path.join(work, "wbc_b_synth.pth")
    torch.save(synth_wbc_state(torch, seed=83), second)
    models = os.path.join(work, "wbc_synth.pth") + "+" + second
    del gf_calls[:]
    sess32, ms16, ms32, wall16, wall32, dbs = session_pair(
        models, chain_in, "chain", [main["sizes"][names[0]]])
    if len(sess32.stages) != 2 or len(gf_calls) != 8:
        fail(f"the wbc+wbc chain ran {len(sess32.stages)} stages and {len(gf_calls)} "
             "guided filters for one image in two sessions of two passes")
    print(f"[i2i] wbc+wbc chain (two pt models) at "
          f"{names[0]}, second pass: bf16 {ms16[0]:.2f} ms between CUDA events, wall {wall16:.3f} s; "
          f"fp32 {ms32[0]:.2f} ms, wall {wall32:.3f} s; 2 stages, 2 guided filters per image; "
          f"bf16 vs fp32 u8 PSNR {dbs[0]:.1f} dB (bar {ZOO_BF16_DB}); kernel launches 0",
          flush=True)
    pipeline.guided_filter = gf

    # -cf on the zoo's 4x SRResNet at 540x960: color_fix's bicubic down/up
    sr_ckpt = os.path.join(work, "4x_synth_srresnet.pth")
    sess = InferenceSession(sr_ckpt, compute_dtype=torch.bfloat16, tile_mode="auto")
    # the SRResNet's 2x upsample block and phase tail: 4 tail_conv launches a forward
    written, wall, ms, cold = warm_twice(sess, chain_in, os.path.join(work, "cf_out"), "-cf",
                                         tail_per_fwd=4, use_color_fix=True)
    img_in = iio.read_img(src[names[0]])
    plain = iio.read_img(os.path.join(work, "zoo_srresnet_bf16", f"{names[0]}.png"))
    fixed = iio.read_img(written[0])
    h, w = main["sizes"][names[0]]
    if fixed is None or fixed.shape != (4 * h, 4 * w, 3):
        fail(f"-cf wrote no ({4 * h}, {4 * w}, 3) PNG")
    ref_u8, out_u8 = torch.from_numpy(img_in), torch.from_numpy(plain)
    cf_cpu = color_fix(ref_u8, out_u8)
    share_cf = u8_close(fixed, cf_cpu)
    print(f"[i2i] -cf on the 4x SRResNet at {names[0]}, bf16: {ms[0]:.2f} ms between CUDA "
          f"events (the model; first pass {cold[0]:.2f}), wall {wall:.3f} s (color_fix on the "
          f"card included); output vs "
          f"color_fix on the CPU of the [zoo] run's PNG: {100 * share_cf:.4f}% within 1 level "
          f"(bar 99.9%); tail_conv 4 launches a forward, no other kernel", flush=True)
    if share_cf < 0.999:
        fail(f"-cf output within one level of the CPU's color_fix in {share_cf:.5f} < 0.999")

    # the device filters alone, card vs CPU on the same inputs
    x = np2tensor(img_in, normalize=True)
    y = torch.clamp(x + 0.1 * torch.randn(x.shape, generator=torch.Generator().manual_seed(84)),
                    -1, 1)
    gf32 = [guided_filter(x.to(d), y.to(d), r=1, eps=5e-3).cpu() for d in (dev, "cpu")]
    db_gf = psnr(gf32[0], gf32[1], max(1.0, gf32[1].abs().max().item()))
    x16, y16 = x.bfloat16(), y.bfloat16()
    gf16 = [pipeline._postprocess_u8(guided_filter(x16.to(d), y16.to(d), r=1, eps=5e-3),
                                     denormalize=True).cpu() for d in (dev, "cpu")]
    share_gf = u8_close(*gf16)
    share_cf = u8_close(color_fix(ref_u8.to(dev), out_u8.to(dev)).cpu(), cf_cpu)
    xd, yd, x16d, y16d = x.to(dev), y.to(dev), x16.to(dev), y16.to(dev)
    rd, od = ref_u8.to(dev), out_u8.to(dev)
    t_gf32 = cuda_ms(lambda: guided_filter(xd, yd, r=1, eps=5e-3), reps=5)
    t_gf16 = cuda_ms(lambda: guided_filter(x16d, y16d, r=1, eps=5e-3), reps=5)
    t_cf = cuda_ms(lambda: color_fix(rd, od), reps=5)
    big = iio.read_img(src[names[-1]])
    share_lr = u8_close(iio.linear_resize(big, 256, device=dev), iio.linear_resize(big, 256))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    iio.linear_resize(big, 256, device=dev)  # u8 up, u8 back: a host wall time
    t_lr = (time.perf_counter() - t0) * 1e3
    print(f"[i2i] guided_filter r=1 eps=5e-3 on {tuple(x.shape)}: fp32 card vs CPU "
          f"{db_gf:.1f} dB (bar {ZOO_FP32_DB}), {t_gf32:.3f} ms on the card; bf16 u8 "
          f"{100 * share_gf:.4f}% within 1 level (bar 99.9%), {t_gf16:.3f} ms; color_fix "
          f"{tuple(ref_u8.shape)} -> {tuple(out_u8.shape)} u8 card vs CPU {100 * share_cf:.4f}% "
          f"within 1 level (bar 99.9%), {t_cf:.3f} ms; linear_resize {big.shape} -> 256 "
          f"multiples u8 card vs CPU {100 * share_lr:.4f}% within 1 level (bar 99.9%), "
          f"{t_lr:.2f} ms wall on the card", flush=True)
    if db_gf < ZOO_FP32_DB or min(share_gf, share_cf, share_lr) < 0.999:
        fail(f"a device filter disagrees with the CPU: guided filter {db_gf:.1f} dB, "
             f"bf16 {share_gf:.5f}, color_fix {share_cf:.5f}, linear_resize {share_lr:.5f}")


def u8_diff(a_paths, b_paths) -> tuple:
    """Over pairs of u8 PNGs of equal shape: the share of values within one
    level, the largest difference and the PSNR."""
    import numpy as np

    from innfer_tpu_torch.io import images as iio

    within, total, worst, sq = 0, 0, 0, 0.0
    for a, b in zip(a_paths, b_paths):
        x, y = iio.read_img(a), iio.read_img(b)
        if x is None or y is None or x.shape != y.shape:
            fail(f"{a} and {b} are not two PNGs of one shape")
        d = np.abs(x.astype(np.int32) - y.astype(np.int32))
        within += int((d <= 1).sum())
        total += d.size
        worst = max(worst, int(d.max()))
        sq += float((d.astype(np.float64) ** 2).sum())
    return within / total, worst, math.inf if sq == 0 else 10 * math.log10(255.0 ** 2 * total / sq)


def phase_batch(dev, work):
    """The batched directory path: auto-batched pix2pix, WBC and CycleGAN
    through process, the cross-image tile stack through the CycleGAN
    stage's runner, and the CLI's --metrics, --timing and --profile."""
    import numpy as np
    import torch

    from innfer_tpu_torch import cli
    from innfer_tpu_torch.io import images as iio
    from innfer_tpu_torch.observability import TRACE_FILE, StageTimers
    from innfer_tpu_torch.pipeline import (InferenceSession, _postprocess_u8, np2tensor,
                                           select_presets)
    from innfer_tpu_torch.tiling.engine import group_chunk

    def write_pngs(name, shapes, seed):
        d = os.path.join(work, name)
        os.makedirs(d)
        for i, (h, w) in enumerate(shapes):
            iio.save_img(synth_image(h, w, seed=seed + i), os.path.join(d, f"{i:02d}_{h}x{w}.png"))
        return d

    def twice(sess, in_dir, out_dir, batch):
        """Process ``in_dir`` twice at ``batch``: the written paths, each
        pass's wall ms per image and CUDA-event ms of the forwards per
        image, the second pass's launch counts, the group sizes run and
        the second pass's StageTimers ms per image."""
        groups, real = [], sess.run_batch

        def spy(imgs, **kw):
            groups.append(len(imgs))
            return real(imgs, **kw)

        sess.run_batch = spy
        timers = StageTimers()
        try:
            runs = [run_session(torch, sess, in_dir, out_dir, batch=batch, timers=t)
                    for t in (None, timers)]
        finally:
            del sess.run_batch
        n = len(runs[1][0])
        stages = ", ".join(f"{k} {1e3 * v['total_s'] / n:.2f}"
                           for k, v in sorted(timers.report().items()))
        return (runs[1][0], [1e3 * r[1] / n for r in runs], [sum(r[2]) / n for r in runs],
                runs[1][3], groups[: len(groups) // 2], stages)

    def ms(pair):
        return " / ".join(f"{t:.2f}" for t in pair)

    def batched_vs_single(label, sess, in_dir, shapes, bar="(bar 100%)"):
        """The CLI's default batch against batch=1 on one session."""
        batch = cli.resolve_batch(0, sess.presets)
        targets = {hw: sess.auto_batch(hw + (3,)) for hw in shapes}
        got_b, wall_b, ev_b, counts_b, groups, st_b = twice(
            sess, in_dir, os.path.join(work, f"{label}_b"), batch)
        got_1, wall_1, ev_1, counts_1, _, st_1 = twice(
            sess, in_dir, os.path.join(work, f"{label}_1"), 1)
        share, worst, db = u8_diff(got_b, got_1)
        print(f"[batch] {label}, codec {iio.codec_name()}: {len(got_b)} images, batch={batch} "
              f"(auto): auto_batch chose "
              f"{', '.join(f'{h}x{w} -> {n}' for (h, w), n in targets.items())}, groups run "
              f"{groups}; ms per image (first / second pass) wall {ms(wall_b)}, forward CUDA "
              f"events {ms(ev_b)}; batch=1 wall {ms(wall_1)}, events {ms(ev_1)}; second pass's "
              f"stages, ms per image: batched {st_b}; batch=1 {st_1}; u8 vs batch=1 "
              f"{100 * share:.4f}% within one level {bar}, max diff {worst}, PSNR {db:.1f} dB",
              flush=True)
        return got_b, got_1, share, counts_b, counts_1, groups

    bf16, fp32 = torch.bfloat16, torch.float32
    # pix2pix unet_256 (the [i2i] phase's checkpoint): 16 at 256x256, 4 at
    # 540x960 enlarged to 768x1024 by the preset
    p2p_in = write_pngs("batch_p2p_in", [(256, 256)] * 16 + [(540, 960)] * 4, seed=100)
    p2p = InferenceSession(os.path.join(work, "p2p_synth_unet256.pth"), arch="unet_256",
                           compute_dtype=bf16)
    _, p2p_single, share, cb, c1, groups = batched_vs_single(
        "pix2pix unet_256 ngf=64", p2p, p2p_in, [(256, 256), (768, 1024)])
    if sorted(groups) != [4, 16] or any(cb.values()) or any(c1.values()) or share < 1.0:
        fail(f"pix2pix batched: groups {groups}, launches {cb} / {c1}, u8 share {share}")

    # a longer directory, where full groups flush while later images decode:
    # 64 at 256x256 in groups of 16 (INNFER_MAX_BATCH)
    long_in = write_pngs("batch_p2p_long_in", [(256, 256)] * 64, seed=140)
    os.environ["INNFER_MAX_BATCH"] = "16"
    try:
        _, _, share, cb, c1, groups = batched_vs_single(
            "pix2pix unet_256 ngf=64, 64 images, INNFER_MAX_BATCH=16", p2p, long_in, [(256, 256)])
    finally:
        del os.environ["INNFER_MAX_BATCH"]
    if groups != [16] * 4 or any(cb.values()) or share < 1.0:
        fail(f"pix2pix long directory: groups {groups}, launches {cb}, u8 share {share}")

    # WBC nf=32, pt (the [i2i] phase's checkpoint): 8 at 540x960
    wbc_in = write_pngs("batch_wbc_in", [(540, 960)] * 8, seed=120)
    wbc = InferenceSession(os.path.join(work, "wbc_synth.pth"), compute_dtype=bf16)
    _, _, share, cb, c1, groups = batched_vs_single("WBC pt nf=32", wbc, wbc_in, [(540, 960)])
    if groups != [8] or any(cb.values()) or any(c1.values()) or share < 1.0:
        fail(f"WBC batched: groups {groups}, launches {cb} / {c1}, u8 share {share}")

    # CycleGAN resnet_9blocks ngf=64 (the [cyclegan] phase's checkpoint):
    # 8 at 512x512 run as one whole-image stack.  Against the same images
    # one at a time whole image: bf16 at the kernel-vs-torch-path bar (the
    # other convs and the norms' reductions of cuDNN and PyTorch sum a
    # stack of 8 in another order than one image, and instance norm
    # carries a bf16 flip on), fp32 within one level in 100%
    cg_in = write_pngs("batch_cg_in", [(512, 512)] * 8, seed=130)
    cg_ckpt = os.path.join(work, "cyclegan9_synth.pth")
    whole_p = select_presets("resnet_9blocks")
    whole_p.chop = False
    want = {"fused_rdb": 0, "fused_rdb_padded": 0, "fused_rrdb_trunk": 0, "tail_conv": 0,
            "fused_dilated_block": 0, "window_attn": 0, "fused_layer_norm": 0,
            "token_linear": 0, "hat_window_attn": 0, "overlap_attn": 0}
    cg = {}
    for dt in (bf16, fp32):
        def cg_launches(blocks, dt=dt):  # the norms take their kernel in bf16 alone
            return {**want, "fused_resnet_block": blocks,
                    "fused_instance_norm": CG_NORMS * blocks // CG_BLOCKS if dt == bf16 else 0}

        sess = InferenceSession(cg_ckpt, arch="resnet_9blocks", compute_dtype=dt,
                                tile_mode="auto")
        whole = InferenceSession(cg_ckpt, arch="resnet_9blocks", presets=whole_p,
                                 compute_dtype=dt)
        tag = str(dt)[6:]
        if dt == bf16:
            got_b, _, share_tiled, cb, c1, groups = batched_vs_single(
                "CycleGAN resnet_9blocks ngf=64", sess, cg_in, [(512, 512)],
                bar="(another computation: batch=1 runs tiles, with per-tile instance norm)")
            got_w, wall_w, ev_w, cw, _, st_w = twice(whole, cg_in,
                                                     os.path.join(work, "cg_whole_1"), 1)
        else:
            got_b, _, ev_b, cb = run_session(torch, sess, cg_in, os.path.join(work, "cg32_b"),
                                             batch=0)
            got_w, _, ev_w, cw = run_session(torch, whole, cg_in, os.path.join(work, "cg32_w"),
                                             batch=1)
        share, worst, db = u8_diff(got_b, got_w)
        print(f"[batch] CycleGAN {tag}: the group of 8 ran whole-image: fused_resnet_block "
              f"launches {cb['fused_resnet_block']} (9 for the stack at (8,128,128,256)) against "
              f"{cw['fused_resnet_block']} one image at a time whole-image; u8 vs those "
              f"{100 * share:.4f}% within one level, max diff {worst}, PSNR {db:.1f} dB (bar "
              + (f"{MIN_PSNR_DB} dB" if dt == bf16 else "100% within one level") + ")"
              + (f"; whole-image one at a time wall {ms(wall_w)} ms per image, events "
                 f"{ms(ev_w)}, stages {st_w}" if dt == bf16 else ""), flush=True)
        if cb != cg_launches(9) or cw != cg_launches(72):
            fail(f"CycleGAN {tag} batched: launches {cb}, one at a time {cw}")
        if (db < MIN_PSNR_DB) if dt == bf16 else (share < 1.0):
            fail(f"CycleGAN {tag} batched vs one at a time: {share:.5f} within one level, "
                 f"{db:.1f} dB")
        if dt == bf16 and (groups != [8] or c1 != cg_launches(72)):
            fail(f"CycleGAN batched: groups {groups}, batch=1 launches {c1}")
        cg[dt] = sess

    # the cross-image tile stack through the stage's runner: 64 tiles in
    # groups grown toward 1.4 MP, against the per-image tiled runs
    imgs = np.stack([iio.read_img(os.path.join(cg_in, f)) for f in sorted(os.listdir(cg_in))])
    for dt in (bf16, fp32):
        runner, params = cg[dt].stages[0].runner, cg[dt].stages[0].params
        x = np2tensor(imgs, normalize=True, dtype=dt, device=dev)
        plan = runner.plan_for(512, 512, on_cuda=True)
        chunk = group_chunk(plan, len(imgs), tile_batch=runner.tile_batch,
                            max_group_px=runner.max_group_px)

        def stacked():
            return runner(params, x)

        def one_by_one():
            return torch.cat([runner(params, x[i: i + 1]) for i in range(len(imgs))])

        counts, outs = {}, {}
        for name, fn in (("stack", stacked), ("single", one_by_one)):
            reset_counts()
            outs[name] = _postprocess_u8(fn(), denormalize=True, batched=True).cpu().numpy()
            counts[name] = read_counts()["fused_resnet_block"]
        d = np.abs(outs["stack"].astype(np.int32) - outs["single"].astype(np.int32))
        share = float((d <= 1).mean())
        db = psnr(outs["stack"], outs["single"], 255.0)
        timing = ""
        if dt == bf16:
            timing = (f"; {cuda_ms(stacked, reps=3):.2f} ms against "
                      f"{cuda_ms(one_by_one, reps=3):.2f} ms between CUDA events")
        print(f"[batch] CycleGAN tiled stack of {len(imgs)} at 512x512, {str(dt)[6:]}: "
              f"{plan.n_tiles * len(imgs)} tiles of {plan.tile_h}x{plan.tile_w}, chunk {chunk} "
              f"(one image alone: {plan.chunk or min(runner.tile_batch, plan.n_tiles)}); "
              f"fused_resnet_block launches {counts['stack']} against {counts['single']} one "
              f"image at a time{timing}; u8 vs the per-image tiled runs {100 * share:.4f}% within "
              f"one level, max diff {int(d.max())}, PSNR {db:.1f} dB (bar "
              + (f"{MIN_PSNR_DB} dB" if dt == bf16 else "100% within one level") + ")",
              flush=True)
        if (chunk, counts["stack"], counts["single"]) != (32, 18, 72):
            fail(f"tiled stack: chunk {chunk}, launches {counts}")
        if (db < MIN_PSNR_DB) if dt == bf16 else (share < 1.0):
            fail(f"tiled stack {dt} vs per image: {share:.5f} within one level, {db:.1f} dB")

    # the CLI: --metrics against the pix2pix batch=1 outputs, --timing, --profile
    gt = os.path.dirname(p2p_single[0])
    prof = os.path.join(work, "batch_profile")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["-m", os.path.join(work, "p2p_synth_unet256.pth"), "-a", "unet_256",
                       "-i", p2p_in, "-o", os.path.join(work, "batch_cli"), "--metrics", gt,
                       "--timing", "--profile", prof])
    rows = [ln.split() for ln in buf.getvalue().splitlines()
            if ln.strip().startswith("metrics ") and "mean" not in ln]
    dbs = [float(r[3]) for r in rows]
    trace = os.path.join(prof, TRACE_FILE)
    size = os.path.getsize(trace) if os.path.isfile(trace) else 0
    print(f"[batch] CLI -a unet_256 --metrics (the batch=1 outputs) --timing --profile: rc {rc}, "
          f"{len(rows)} metric rows, PSNR {min(dbs) if dbs else 'none'} to "
          f"{max(dbs) if dbs else 'none'} dB (bar 48.1, or inf); trace "
          f"{os.path.relpath(trace, work)} {size} bytes", flush=True)
    if rc != 0 or len(rows) != 20 or min(dbs) < 48.1 or size == 0:
        fail(f"the CLI's --metrics/--profile run: rc {rc}, rows {rows}, trace {size} bytes")


EV_CLIP = (1, 5, 270, 480, 3)   # evsrgan's clip: 5 frames of 270x480


def synth_evsrgan_state(torch, seed, nb=NB, nf=NF, gc=GC):
    """A seeded 4x evsrgan (RRDBNet with Conv3d everywhere) state dict:
    the ESRGAN keys with 3x3x3 OIDHW weights, uniform with variance
    1/fan_in."""
    g = torch.Generator().manual_seed(seed)
    state = {}

    def conv(key, o, i):
        std = math.sqrt(3.0 / (i * 27))
        state[f"{key}.weight"] = (torch.rand(o, i, 3, 3, 3, generator=g) * 2 - 1) * std
        state[f"{key}.bias"] = (torch.rand(o, generator=g) * 2 - 1) * 0.01

    conv("model.0", nf, 3)
    for i in range(nb):
        for j in (1, 2, 3):
            for c in range(1, 6):
                conv(f"model.1.sub.{i}.RDB{j}.conv{c}.0", gc if c < 5 else nf, nf + (c - 1) * gc)
    conv(f"model.1.sub.{nb}", nf, nf)
    for key in ("model.3", "model.6", "model.8"):
        conv(key, nf, nf)
    conv("model.10", 3, nf)
    return state


def evsrgan_flops(d, h, w, nb=NB, nf=NF, gc=GC, out_nc=3) -> float:
    """Operations of one 4x evsrgan forward on a d x h x w clip (3x3x3
    convs): fea conv, nb x 3 RDBs, LR conv, then up1 at 2x, up2, the HR
    conv and conv_last at 4x."""
    conv = lambda cin, cout, px: 2 * 27 * cin * cout * px  # noqa: E731
    px = d * h * w
    rdb = sum(conv(nf + c * gc, gc if c < 4 else nf, px) for c in range(5))
    return (conv(3, nf, px) + nb * 3 * rdb + conv(nf, nf, px) + conv(nf, nf, 4 * px)
            + 2 * conv(nf, nf, 16 * px) + conv(nf, out_nc, 16 * px))


def phase_evsrgan(dev, work, main, clip=EV_CLIP, nb=NB):
    """evsrgan through the library (the session refuses it): load_model ->
    model.apply on a clip of frames in bf16 and fp32, timed by CUDA events,
    bf16 vs fp32, fp32 card vs CPU on a (1,3,16,16,3) clip at full depth,
    no kernel launched; then InferenceSession must raise."""
    import numpy as np
    import torch

    from innfer_tpu_torch.loader import load_model
    from innfer_tpu_torch.pipeline import InferenceSession

    ckpt = os.path.join(work, "4x_synth_evsrgan.pth")
    torch.save(synth_evsrgan_state(torch, seed=150, nb=nb), ckpt)
    _b, d, h, w, _c = clip
    frames = np.stack([synth_image(h, w, seed=151 + k) for k in range(d)])
    x = torch.from_numpy(frames[None].astype(np.float32) / 255.0).to(dev)
    outs, ms = {}, {}
    reset_counts()
    for dt in (torch.bfloat16, torch.float32):
        model, params = load_model(ckpt, arch="evsrgan", scale=4, param_dtype=dt, device=dev)
        if (model.cfg["convtype"], model.cfg["nb"], model.cfg["nf"]) != ("Conv3D", nb, NF):
            fail(f"evsrgan built {model.cfg}")
        xd = x.to(dt)
        model.apply(params, xd)  # cuDNN's set-up of the clip's shapes
        torch.cuda.synchronize()
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        outs[dt] = model.apply(params, xd)
        e1.record()
        torch.cuda.synchronize()
        ms[dt] = e0.elapsed_time(e1)
    counts = read_counts()
    if any(counts.values()):
        fail(f"evsrgan launched a port kernel: {counts}")
    a, b = outs[torch.bfloat16].float(), outs[torch.float32]
    if tuple(b.shape) != (1, d, 4 * h, 4 * w, 3) or not torch.isfinite(a).all():
        fail(f"evsrgan output {tuple(b.shape)}, finite {bool(torch.isfinite(a).all())}")
    peak = max(1.0, b.abs().max().item())
    mse = (a - b).square().mean().item()
    db16 = math.inf if mse == 0 else 10 * math.log10(peak ** 2 / mse)
    del outs, a, b
    small = torch.rand(1, 3, 16, 16, 3, generator=torch.Generator().manual_seed(152))
    model, params = load_model(ckpt, arch="evsrgan", scale=4, device=dev)
    card = model.apply(params, small.to(dev)).cpu()
    cpu = model.apply({k: v.cpu() for k, v in params.items()}, small)
    db32 = psnr(card, cpu, max(1.0, cpu.abs().max().item()))
    try:
        InferenceSession(ckpt, arch="evsrgan", compute_dtype=torch.float32)
        refused = None
    except ValueError as e:
        refused = str(e)
    flops = evsrgan_flops(d, h, w, nb=nb)
    print(f"[evsrgan] 4x nb={nb} nf={NF} gc={GC} Conv3D, clip {clip}, {flops / 1e12:.2f} TFLOP "
          f"a forward: bf16 {ms[torch.bfloat16]:.1f} ms ({flops / ms[torch.bfloat16] / 1e9:.1f} "
          f"TFLOP/s), fp32 {ms[torch.float32]:.1f} ms ({flops / ms[torch.float32] / 1e9:.1f} "
          f"TFLOP/s) between CUDA events; bf16 vs fp32 {db16:.1f} dB (bar {ZOO_BF16_DB}); fp32 "
          f"card vs CPU (1,3,16,16,3) {db32:.1f} dB (bar {ZOO_FP32_DB}); kernel launches "
          f"{sum(counts.values())}; InferenceSession: "
          f"{'ValueError' if refused else 'did not raise'}", flush=True)
    if db16 < ZOO_BF16_DB or db32 < ZOO_FP32_DB:
        fail(f"evsrgan: bf16 vs fp32 {db16:.1f} dB, card vs CPU {db32:.1f} dB")
    if not refused or "Conv3D" not in refused:
        fail(f"InferenceSession did not refuse evsrgan with the Conv3D error: {refused}")


def synth_mesrgan_state(torch, seed, nb=NB, nf=NF, gc=GC):
    """A seeded 4x mESRGAN state dict in the modified layout (conv_first,
    RRDB_trunk.<i>.RDB<j>.conv<c>, trunk_conv, upconv1/2, HRconv,
    conv_last), uniform with variance 1/fan_in."""
    g = torch.Generator().manual_seed(seed)
    state = {}

    def conv(key, o, i):
        std = math.sqrt(3.0 / (i * 9))
        state[f"{key}.weight"] = (torch.rand(o, i, 3, 3, generator=g) * 2 - 1) * std
        state[f"{key}.bias"] = (torch.rand(o, generator=g) * 2 - 1) * 0.01

    conv("conv_first", nf, 3)
    for i in range(nb):
        for j in (1, 2, 3):
            for c in range(1, 6):
                conv(f"RRDB_trunk.{i}.RDB{j}.conv{c}", gc if c < 5 else nf, nf + (c - 1) * gc)
    for key in ("trunk_conv", "upconv1", "upconv2", "HRconv"):
        conv(key, nf, nf)
    conv("conv_last", 3, nf)
    return state


def phase_convert(dev, work, main, nb=NB):
    """The conversion tool: a synthetic full-width mESRGAN checkpoint
    converted with --remap mod2normal, then the main path's 540x960 PNG
    through InferenceSession from both files in bf16: identical u8
    outputs, 69 fused_rdb launches each."""
    import numpy as np
    import torch

    from innfer_tpu_torch.io import images as iio
    from innfer_tpu_torch.pipeline import InferenceSession
    from innfer_tpu_torch.tools import convert

    src = os.path.join(work, "4x_synth_mesrgan.pth")
    dst = os.path.join(work, "4x_synth_mesrgan_normal.pth")
    torch.save(synth_mesrgan_state(torch, seed=160, nb=nb), src)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = convert.main([src, dst, "--remap", "mod2normal"])
    state = torch.load(dst, map_location="cpu", weights_only=True)
    if rc != 0 or f"model.1.sub.{nb}.weight" not in state or "conv_first.weight" in state:
        fail(f"convert --remap mod2normal: rc {rc}, keys {sorted(state)[:4]}")
    name = next(iter(main["sizes"]))
    in_dir = os.path.join(work, "convert_in")
    os.makedirs(in_dir)
    os.symlink(os.path.join(main["in_dir"], f"{name}.png"), os.path.join(in_dir, f"{name}.png"))
    got, launches = {}, {}
    for label, path in (("mesrgan", src), ("converted", dst)):
        sess = InferenceSession(path, compute_dtype=torch.bfloat16, tile_mode="auto")
        written, wall, ms, counts = run_session(torch, sess, in_dir, os.path.join(work, f"cv_{label}"))
        got[label] = iio.read_img(written[0])
        launches[label] = counts["fused_rdb"]
    a, b = got["mesrgan"], got["converted"]
    same = a is not None and b is not None and a.shape == b.shape and np.array_equal(a, b)
    print(f"[convert] {buf.getvalue().strip()}; {name} through InferenceSession in bf16 from both "
          f"files: u8 outputs {'identical' if same else 'DIFFER'} (shape "
          f"{None if a is None else a.shape}); fused_rdb launches {launches}", flush=True)
    if not same or set(launches.values()) != {3 * nb}:
        fail(f"the converted checkpoint's outputs or launches differ: {launches}")


def phase_stages(dev, work, main):
    """The main path's ESRGAN images through process with StageTimers, with
    the encode pool and with encodes inline, after a warm-up pass: the two
    images, and the same two three times over (six); inside "image", the
    forward's enqueue and the pinned copy's start are timed apart.  Each
    run is made with the native host codec and then with OpenCV
    (``native.get_lib`` patched to None: OpenCV decodes on the loader's
    Python pool and encodes), in turns.  Then one 4x 1080p output encoded
    alone."""
    import torch

    from innfer_tpu_torch import pipeline
    from innfer_tpu_torch.io import images as iio
    from innfer_tpu_torch.observability import StageTimers
    from innfer_tpu_torch.pipeline import InferenceSession
    from innfer_tpu_torch.runtime import native

    get_lib = native.get_lib
    codecs = ["native", "opencv"] if native.available() else ["opencv"]

    six = os.path.join(work, "stages_in_six")
    os.makedirs(six)
    for k in range(3):
        for name in main["sizes"]:
            os.symlink(os.path.join(main["in_dir"], f"{name}.png"),
                       os.path.join(six, f"{name}_{k}.png"))
    sess = InferenceSession(main["ckpt"], compute_dtype=torch.bfloat16, tile_mode="auto")
    # a warm-up pass, untimed: a session's first forwards pack the kernel's
    # weights and upload the tile plans' constants, once
    sess.process(main["in_dir"], os.path.join(work, "stages_warm"), verbose=False)
    current = {}
    forward, start = sess.forward, pipeline.HostCopy.__dict__["start"]

    def timed_forward(x, **kw):
        with current["timers"].stage("image: forward enqueue"):
            return forward(x, **kw)

    def timed_start(cls, u8):
        with current["timers"].stage("image: pinned copy start"):
            return start.__func__(cls, u8)

    sess.forward = timed_forward
    pipeline.HostCopy.start = classmethod(timed_start)
    try:
        for label, in_dir, n in (("two images", main["in_dir"], main["n_images"]),
                                 ("six images", six, 3 * main["n_images"])):
            for threads, codec in ((t, c) for t in ("2", "0") for c in codecs):
                timers = current["timers"] = StageTimers()
                out_dir = os.path.join(work, f"stages_{n}_{threads}_{codec}")
                os.environ["INNFER_ENCODE_THREADS"] = threads
                if codec == "opencv":
                    native.get_lib = lambda: None
                try:
                    name = iio.codec_name()
                    reset_counts()
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    written = sess.process(in_dir, out_dir, verbose=False, timers=timers)
                    torch.cuda.synchronize()
                    wall = time.perf_counter() - t0
                finally:
                    del os.environ["INNFER_ENCODE_THREADS"]
                    native.get_lib = get_lib
                counts = read_counts()
                rep = timers.report()
                print(f"[stages] ESRGAN, {label} ({', '.join(main['sizes'])}), bf16 "
                      f"{sess.stages[0].runner.last_mode}, INNFER_ENCODE_THREADS={threads}, codec "
                      f"{name}: wall {wall:.3f} s; "
                      + "; ".join(f"{k} total {v['total_s']:.4f} s, n {v['count']}, mean "
                                  f"{v['mean_ms']:.2f} ms" for k, v in sorted(rep.items()))
                      + f"; fused_rdb launches {counts['fused_rdb']}", flush=True)
                if counts["fused_rdb"] != 69 * n or len(written) != n:
                    fail(f"the [stages] run launched {counts} and wrote {written}")
                if not {"read", "image", "fetch", "encode"} <= set(rep) or "batch" in rep:
                    fail(f"StageTimers timed {sorted(rep)}")
    finally:
        del sess.forward
        pipeline.HostCopy.start = start
    big = iio.read_img(os.path.join(work, f"stages_2_0_{codecs[0]}",
                                    f"{list(main['sizes'])[-1]}.png"))
    encoders = [(f"io.images.save_img ({iio.codec_name()})", iio.save_img)]
    if iio.cv2 is not None:
        encoders.append((f"cv2.imwrite (opencv {iio.cv2.__version__})",
                         lambda im, p: iio.cv2.imwrite(p, im)))
    alone = []
    for i, (label, enc) in enumerate(encoders):
        path = os.path.join(work, f"stages_encode_alone_{i}.png")
        t0 = time.perf_counter()
        enc(big, path)
        dt = time.perf_counter() - t0
        alone.append(f"{label}: {1e3 * dt:.1f} ms, {os.path.getsize(path) / 1e6:.1f} MB")
    print(f"[stages] one {big.shape[0]}x{big.shape[1]} output encoded alone through "
          + "; through ".join(alone), flush=True)


def phase_codec(work, main):
    """The native host codec against OpenCV on the card's host: decode of a
    1080x1920 PNG and encode of the main path's 4320x7680 output, median of
    5 in turns, then a 1080x1920 JPEG (natively where libjpeg is built in).
    Where g++ or zlib.h is missing, OpenCV alone is timed."""
    import numpy as np

    from innfer_tpu_torch.io import images as iio
    from innfer_tpu_torch.runtime import native

    cv2 = iio.cv2
    if cv2 is None:
        fail("[codec] OpenCV does not import: nothing to hold the native codec against")
    ocv = f"opencv {cv2.__version__}"
    decoders = {ocv: lambda p: iio.read_img(p, use_native=False)}
    encoders = {ocv: cv2.imwrite}
    if native.available():
        decoders = {"native": native.decode, **decoders}
        encoders = {"native": native.encode_png, **encoders}
    else:
        missing = [h for h in native.missing_headers() if h in native.REQUIRED]
        if shutil.which(native.CXX) and not missing:
            fail(f"zlib.h is present, yet the native codec did not build: "
                 f"{native.unavailable_reason()}")
        print(f"[codec] this host lacks {', '.join(missing) or native.CXX}: the native codec did "
              f"not build, so OpenCV reads and writes and is timed alone "
              f"({native.unavailable_reason()})", flush=True)
    names = list(decoders)
    d = os.path.join(work, "codec")
    os.makedirs(d)
    img = synth_image(1080, 1920, seed=300)
    paths = {"PNG": os.path.join(d, "in.png"), "JPEG": os.path.join(d, "in.jpg")}
    cv2.imwrite(paths["PNG"], img)
    cv2.imwrite(paths["JPEG"], img, [cv2.IMWRITE_JPEG_QUALITY, 95])

    def in_turns(fns: dict) -> dict:
        """The median host ms of 5 calls of each of ``fns``, taken in turns
        (a b b a a b b a a b) after one warm call each."""
        for fn in fns.values():
            fn()
        keys, times = list(fns), {k: [] for k in fns}
        for k in (keys + keys[::-1]) * 2 + keys:
            t0 = time.perf_counter()
            fns[k]()
            times[k].append(1e3 * (time.perf_counter() - t0))
        return {k: sorted(v)[len(v) // 2] for k, v in times.items()}

    got = {k: dec(paths["PNG"]) for k, dec in decoders.items()}
    ms = in_turns({k: (lambda dec=dec: dec(paths["PNG"])) for k, dec in decoders.items()})
    same = all(a is not None and np.array_equal(a, img) for a in got.values())
    print(f"[codec] decode 1080x1920 PNG ({os.path.getsize(paths['PNG']) / 1e6:.2f} MB, written "
          f"by OpenCV), median of 5 in turns: " + "; ".join(f"{k} {t:.2f} ms" for k, t in ms.items())
          + (f" (native / opencv {ms['native'] / ms[ocv]:.3f})" if len(ms) > 1 else "")
          + f"; arrays identical to each other and to the image written: {same}", flush=True)
    if not same:
        fail("a codec does not read back the PNG written, or the two differ")

    jpeg = {k: dec for k, dec in decoders.items() if k != "native" or native.has_jpeg()}
    got = {k: dec(paths["JPEG"]) for k, dec in jpeg.items()}
    ms = in_turns({k: (lambda dec=dec: dec(paths["JPEG"])) for k, dec in jpeg.items()})
    if len(jpeg) < len(decoders):
        print("[codec] JPEG through OpenCV: no libjpeg on this host", flush=True)
    print(f"[codec] decode 1080x1920 JPEG ({os.path.getsize(paths['JPEG']) / 1e6:.2f} MB, "
          f"quality 95), median of 5 in turns: "
          + "; ".join(f"{k} {t:.2f} ms" for k, t in ms.items())
          + (f" (native / opencv {ms['native'] / ms[ocv]:.3f}); arrays "
             f"{'identical' if len({a.tobytes() for a in got.values()}) == 1 else 'differ'}"
             if len(ms) > 1 else ""), flush=True)
    if any(a is None or a.shape != img.shape for a in got.values()):
        fail(f"a codec does not read the JPEG: {[None if a is None else a.shape for a in got.values()]}")

    big = iio.read_img(os.path.join(main["out_dir"], f"{list(main['sizes'])[-1]}.png"))
    outs = {k: os.path.join(d, f"out_{i}.png") for i, k in enumerate(encoders)}
    for k, enc in encoders.items():  # the warm call, checked
        if not enc(outs[k], big):
            fail(f"the {k} encoder failed on the {big.shape} output")
    med = in_turns({k: (lambda k=k, enc=enc: enc(outs[k], big)) for k, enc in encoders.items()})
    mb = {k: os.path.getsize(p) / 1e6 for k, p in outs.items()}
    back = all(np.array_equal(dec(p), big) for p in outs.values() for dec in decoders.values())
    print(f"[codec] encode {big.shape[0]}x{big.shape[1]} PNG, median of 5 in turns: "
          + "; ".join(f"{k} {med[k]:.1f} ms, {mb[k]:.2f} MB" for k in names)
          + (f" (native / opencv: time {med['native'] / med[ocv]:.3f}, size "
             f"{mb['native'] / mb[ocv]:.3f})" if len(names) > 1 else "")
          + f"; each file reads back through every decoder to the array written: {back}",
          flush=True)
    if not back:
        fail("a PNG written by one codec does not read back to the array written")


def timed_once(torch, fn):
    """``fn()`` once, and its ms between CUDA events."""
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    e0.record()
    out = fn()
    e1.record()
    torch.cuda.synchronize()
    return out, e0.elapsed_time(e1)


def dp_slices(n_tiles: int, chunk: int, n_data: int) -> int:
    """Slices a mesh runner runs: groups of ``chunk`` tiles (the last at its
    natural size), each cut into at most ``n_data`` non-empty slices."""
    return sum(min(n_data, min(chunk, n_tiles - i)) for i in range(0, n_tiles, chunk))


def phase_parallel(dev, work, main, halo_shape=(1, 1088, 1920, NF)):
    """The device mesh on the one card: make_mesh's device check, halo_conv2d,
    the spatial forward, the session under spatial=True, dp tiles, tp and
    the batched dp split, on virtual meshes that repeat cuda:0 (each halo
    copy and per-device slice of the real path runs; the times are the
    mesh code's overhead on one card, not scaling)."""
    import numpy as np
    import torch

    from innfer_tpu_torch.io import images as iio
    from innfer_tpu_torch.loader import load_model
    from innfer_tpu_torch.nn import functional as F
    from innfer_tpu_torch.parallel.mesh import (make_mesh, params_on, replicate_params,
                                                tp_shard_params)
    from innfer_tpu_torch.parallel.spatial import halo_conv2d
    from innfer_tpu_torch.parallel.spatial_model import (SpatialRunner, build_spatial_apply,
                                                         spatial_rejection_reason)
    from innfer_tpu_torch.pipeline import (InferenceSession, _postprocess_u8, np2tensor,
                                           select_presets)
    from innfer_tpu_torch.tiling.engine import TiledRunner

    bf16, fp32 = torch.bfloat16, torch.float32
    virtual = lambda n_data, n_model=1: make_mesh(  # noqa: E731
        n_data, n_model, devices=[dev] * (n_data * n_model))

    # (a) the device check
    n_dev = torch.cuda.device_count()
    msg = "(more than one card: make_mesh(n_data=2) is a real mesh here)"
    if n_dev < 2:
        try:
            make_mesh(n_data=2)
            fail("make_mesh(n_data=2) built a mesh on a one-card machine")
        except ValueError as e:
            msg = str(e)
    one = make_mesh()
    print(f"[parallel] make_mesh(n_data=2) on {n_dev} card(s): {msg}; make_mesh(): "
          f"{one.shape} of {one.devices}", flush=True)
    if n_dev == 1 and (one.shape != {"data": 1, "model": 1}
                       or one.devices != [[torch.device("cuda", 0)]]):
        fail(f"make_mesh() on one card is {one.shape} of {one.devices}")

    # (b) halo_conv2d at the main path's trunk shape, 4 shards of cuda:0
    mesh4 = virtual(4)
    g = torch.Generator().manual_seed(170)
    x = torch.randn(*halo_shape, generator=g).to(dev)
    w = (torch.randn(NF, NF, 3, 3, generator=g) / 24).to(dev)
    b = (torch.randn(NF, generator=g) * 0.02).to(dev)
    parts = []
    for dt in (fp32, bf16):
        xd, wd = x.to(dt), w.to(dt)
        out = halo_conv2d(xd, wd, b, mesh=mesh4)
        ref = F.conv2d(xd, wd, b, padding=1)
        peak = ref.float().abs().max().item()
        err = (out.float() - ref.float()).abs().max().item()
        db = psnr(out.float().cpu(), ref.float().cpu(), peak)
        ms_h = cuda_ms(lambda: halo_conv2d(xd, wd, b, mesh=mesh4), reps=5)
        ms_p = cuda_ms(lambda: F.conv2d(xd, wd, b, padding=1), reps=5)
        parts.append(f"{str(dt)[6:]} max_abs {err:.3g} ({err / peak:.3g} of max|ref| {peak:.3g}), "
                     f"PSNR {db:.1f} dB, {ms_h:.3f} ms against F.conv2d {ms_p:.3f} ms")
        if not torch.isfinite(out.float()).all() or (
                err > 1e-4 * peak if dt == fp32 else db < MIN_PSNR_DB):
            fail(f"halo_conv2d {dt} disagrees with F.conv2d: max_abs {err}, {db:.1f} dB")
        del out, ref
    print(f"[parallel] halo_conv2d {halo_shape} -> {NF}, 3x3, 4 shards of cuda:0 against "
          f"F.conv2d (bars: fp32 1e-4 x max|ref|, bf16 {MIN_PSNR_DB} dB): " + "; ".join(parts),
          flush=True)
    del x

    # (c) the spatial forward: the main path's ESRGAN, 4 shards, against the
    # whole-image forward with the plain tail (the form the spatial path
    # computes; its trunk runs the kernel)
    imgs = {n: iio.read_img(os.path.join(main["in_dir"], f"{n}.png")) for n in main["sizes"]}
    big, small = list(main["sizes"])[-1], list(main["sizes"])[0]
    model, p16 = load_model(main["ckpt"], param_dtype=bf16)
    apply4 = build_spatial_apply(model.cfg, mesh4)
    whole_u8 = {}
    with tail_form("a"):
        for n, img in imgs.items():
            t = np2tensor(img, dtype=bf16, device=dev)
            whole_u8[n], ms_w = timed_once(
                torch, lambda: _postprocess_u8(model.apply(p16, t)).cpu().numpy())
            if n == big:
                ms_whole = ms_w
    t = np2tensor(imgs[big], dtype=bf16, device=dev)
    reset_counts()
    sp_u8, ms_sp = timed_once(torch, lambda: _postprocess_u8(apply4(p16, t)).cpu().numpy())
    counts = read_counts()
    db16 = psnr(sp_u8, whole_u8[big], 255.0)
    del t
    p32 = {k: v.float() for k, v in p16.items()}
    t = np2tensor(imgs[small], dtype=fp32, device=dev)
    sp32, ms_sp32 = timed_once(torch, lambda: apply4(p32, t))
    with tail_form("a"):
        wh32, ms_wh32 = timed_once(torch, lambda: model.apply(p32, t))
    db32 = psnr(sp32.cpu(), wh32.cpu(), max(1.0, wh32.abs().max().item()))
    print(f"[parallel] spatial ESRGAN 4x nb=23 on 4 shards of cuda:0: {big} bf16 "
          f"{tuple(sp_u8.shape)}, u8 PSNR {db16:.1f} dB against the whole-image plain-tail "
          f"forward (bar {MIN_PSNR_DB}), {ms_sp:.1f} ms against {ms_whole:.1f} ms whole image "
          f"(CUDA events; overhead on one card, not scaling), kernel launches {counts}; "
          f"{small} fp32 PSNR {db32:.1f} dB (bar 80), {ms_sp32:.1f} ms against "
          f"{ms_wh32:.1f} ms", flush=True)
    if db16 < MIN_PSNR_DB or db32 < 80.0 or any(counts.values()):
        fail(f"spatial ESRGAN: bf16 {db16:.1f} dB, fp32 {db32:.1f} dB, launches {counts}")
    if sp_u8.shape != (4 * imgs[big].shape[0], 4 * imgs[big].shape[1], 3):
        fail(f"spatial ESRGAN output shape {sp_u8.shape}")
    del sp32, wh32, t

    # SRResNet through SpatialRunner on 8 shards of 540x960 (540 = 8 * 67 + 4)
    h, w = main["sizes"][small]
    sr_model, sr32 = load_model(os.path.join(work, "4x_synth_srresnet.pth"), param_dtype=fp32)
    mesh8 = virtual(8)
    runner = SpatialRunner(sr_model, mesh8)
    t = np2tensor(imgs[small], dtype=fp32, device=dev)
    reset_counts()
    out, ms_r = timed_once(torch, lambda: runner(replicate_params(sr32, mesh8), t))
    counts = read_counts()
    with tail_form("a"):
        ref = sr_model.apply(sr32, t)
    keep = (h - 40) * 4  # rows beyond the padded rows' receptive field
    db_r = psnr(out[:, :keep].cpu(), ref[:, :keep].cpu(), max(1.0, ref.abs().max().item()))
    print(f"[parallel] SRResNet 4x nf=64 nb=16 through SpatialRunner, 8 shards of cuda:0, "
          f"{h}x{w} fp32 (padded to {-(-h // 8) * 8} rows): output {tuple(out.shape)}, rows < "
          f"{keep} PSNR "
          f"{db_r:.1f} dB against the whole-image plain-tail forward (bar 80), {ms_r:.1f} ms, "
          f"kernel launches {counts}", flush=True)
    if tuple(out.shape) != (1, 4 * h, 4 * w, 3) or db_r < 80.0 or any(counts.values()):
        fail(f"SpatialRunner SRResNet: shape {tuple(out.shape)}, {db_r:.1f} dB, {counts}")
    del out, ref, t

    # (d) the session under spatial=True
    sess = InferenceSession(main["ckpt"], compute_dtype=bf16, mesh=mesh4, spatial=True)
    written, wall, ev, counts = run_session(torch, sess, main["in_dir"],
                                            os.path.join(work, "par_spatial"))
    dbs = []
    for path, (n, (ih, iw)) in zip(written, main["sizes"].items()):
        got = iio.read_img(path)
        if got is None or got.shape != (4 * ih, 4 * iw, 3):
            fail(f"{path}: expected a ({4 * ih}, {4 * iw}, 3) PNG")
        dbs.append(psnr(got, whole_u8[n], 255.0))
    try:
        InferenceSession(os.path.join(work, "4x_synth_pan.pth"), compute_dtype=bf16,
                         mesh=mesh4, spatial=True)
        fail("the spatial session accepted PAN")
    except NotImplementedError as e:
        pan_msg = str(e)
    print(f"[parallel] InferenceSession(spatial=True) on 4 shards of cuda:0, bf16: "
          f"{len(written)} 4x PNGs, PSNR {', '.join(f'{d:.1f}' for d in dbs)} dB against the "
          f"whole-image plain-tail forwards (bar {MIN_PSNR_DB}); forward ms per image "
          f"{', '.join(f'{e:.1f}' for e in ev)}, wall {wall:.3f} s; kernel launches {counts}; "
          f"PAN refused: {pan_msg!r}", flush=True)
    if min(dbs) < MIN_PSNR_DB or any(counts.values()):
        fail(f"the spatial session: {dbs} dB, launches {counts}")
    if pan_msg != "--spatial: " + spatial_rejection_reason({"type": "pan_net"}):
        fail(f"PAN's refusal does not carry the reason: {pan_msg!r}")
    del sess

    # (e) dp tiles: the main path's session on 2 data slices, auto mode
    mesh2 = virtual(2)
    one_dir = os.path.join(work, "par_one")
    os.makedirs(one_dir)
    os.symlink(os.path.join(main["in_dir"], f"{small}.png"), os.path.join(one_dir, f"{small}.png"))
    dp = InferenceSession(main["ckpt"], compute_dtype=bf16, tile_mode="auto", mesh=mesh2)
    st = dp.stages[0]
    dp_written, dp_wall, dp_ev, dp_counts = run_session(torch, dp, one_dir,
                                                        os.path.join(work, "par_dp"))
    plan = st.runner.plan_for(h, w, on_cuda=True)
    slices = dp_slices(plan.n_tiles, st.runner.tile_batch, 2)
    free = TiledRunner(st.model.apply, 4, mode="auto", overlap=st.runner.overlap,
                       tile_batch=st.runner.tile_batch, compute_dtype=bf16)
    fplan = free.plan_for(h, w, on_cuda=True)
    if (fplan.tile_h, fplan.tile_w, fplan.starts_h, fplan.starts_w) != (
            plan.tile_h, plan.tile_w, plan.starts_h, plan.starts_w) or st.runner.last_mode != "auto":
        fail(f"dp runner ran {st.runner.last_mode} on another plan than the mesh-free runner")
    t = np2tensor(imgs[small], dtype=bf16, device=dev)
    pdev = params_on(st.params, dev)
    u8_m = _postprocess_u8(st.runner(st.params, t)).cpu().numpy()
    u8_f = _postprocess_u8(free(pdev, t)).cpu().numpy()
    ms_m = cuda_ms(lambda: st.runner(st.params, t), reps=2)
    ms_f = cuda_ms(lambda: free(pdev, t), reps=2)
    share, db = u8_close(u8_m, u8_f), psnr(u8_m, u8_f, 255.0)
    # fp32 on a 64x64 crop, uniform 32-px tiles (9 tiles: groups of 8 and 1,
    # so slices of 4, 4 and 1): against a mesh-free runner whose groups have
    # the slices' composition (tile_batch 4), which isolates the mesh code,
    # and against one at the same tile_batch, whose launches take 8 tiles
    # (cuDNN's results vary with the batch: the bar is about 10x the
    # 4.58e-05 the H100 showed there)
    crop = np2tensor(imgs[small][:64, :64], dtype=fp32, device=dev)
    q32 = {k: v.float() for k, v in pdev.items()}
    kw = dict(mode="uniform", tile=32, overlap=8, compute_dtype=fp32)
    m32 = TiledRunner(st.model.apply, 4, mesh=mesh2, tile_batch=8, **kw)(
        replicate_params(q32, mesh2), crop)
    s32 = TiledRunner(st.model.apply, 4, tile_batch=4, **kw)(q32, crop)
    f32 = TiledRunner(st.model.apply, 4, tile_batch=8, **kw)(q32, crop)
    err32 = (m32 - s32).abs().max().item()
    err_tb = (m32 - f32).abs().max().item()
    db_tb = psnr(m32.cpu(), f32.cpu(), max(1.0, f32.abs().max().item()))
    print(f"[parallel] dp tiles: the main path's session on 2 data slices of cuda:0, bf16 auto "
          f"(mode {st.runner.last_mode}), {small}: {plan.n_tiles} tiles of {plan.tile_h}x"
          f"{plan.tile_w} in groups of {st.runner.tile_batch}, {slices} slices, fused_rdb "
          f"launches {dp_counts['fused_rdb']} (69 x {slices} = {69 * slices}), tail_conv "
          f"{dp_counts['tail_conv']} (4 x {slices}); runner "
          f"{ms_m:.1f} ms against {ms_f:.1f} ms mesh-free (CUDA events; overhead on one card); "
          f"u8 against the mesh-free runner {100 * share:.4f}% within one level (bar 99.9%), "
          f"PSNR {db:.1f} dB (bar {MIN_PSNR_DB}); fp32 64x64 crop max_abs {err32:.3g} against "
          f"the slices' composition (bar 1e-5), {err_tb:.3g} (bar 5e-4; PSNR {db_tb:.1f} dB, "
          f"max|ref| {f32.abs().max().item():.3g}) against the same tile_batch; session wall "
          f"{dp_wall:.3f} s", flush=True)
    if dp_counts != {"fused_rdb": 69 * slices, "fused_rdb_padded": 0, "fused_rrdb_trunk": 0,
                     "fused_resnet_block": 0, "tail_conv": 4 * slices,
                     "fused_dilated_block": 0, "fused_instance_norm": 0, "window_attn": 0,
                     "fused_layer_norm": 0, "token_linear": 0, "hat_window_attn": 0,
                     "overlap_attn": 0}:
        fail(f"dp tiles launched {dp_counts}, expected 69 x {slices} fused_rdb and 4 x "
             f"{slices} tail_conv (a forward's tail per slice)")
    if share < 0.999 or db < MIN_PSNR_DB or err32 > 1e-5 or err_tb > 5e-4 or len(dp_written) != 1:
        fail(f"dp tiles vs mesh-free: {share:.5f}, {db:.1f} dB, fp32 {err32}, {err_tb}")

    # (f) tp: a (2 data x 2 model) mesh against replicated params
    mesh22 = virtual(2, 2)
    tps = InferenceSession(main["ckpt"], compute_dtype=bf16, tile_mode="auto", mesh=mesh22)
    n_sharded = sum(hasattr(v, "tp_shards") for v in params_on(tps.stages[0].params, dev).values())
    tp_written, tp_wall, _, tp_counts = run_session(torch, tps, one_dir,
                                                    os.path.join(work, "par_tp"))
    tp_share, _, tp_db = u8_diff(tp_written, dp_written)
    tp32 = params_on(tp_shard_params(q32, mesh22), dev)
    a = st.model.apply(tp32, crop)
    b = st.model.apply(q32, crop)
    tp_err = (a - b).abs().max().item()
    tp_db32 = psnr(a.cpu(), b.cpu(), max(1.0, b.abs().max().item()))
    print(f"[parallel] tp: the session on (2 data x 2 model) of cuda:0, bf16 auto, {small}: "
          f"{n_sharded} of {len(q32)} params sharded; fused_rdb launches "
          f"{tp_counts['fused_rdb']} (on gathered weights; 69 x {slices}); u8 against the "
          f"replicated dp run PSNR {tp_db:.1f} dB (bar {MIN_PSNR_DB}), {100 * tp_share:.4f}% "
          f"within one level; fp32 64x64 crop whole-model max_abs {tp_err:.3g} against "
          f"replicated (bar 1e-5; PSNR {tp_db32:.1f} dB, max|ref| {b.abs().max().item():.3g}); "
          f"wall {tp_wall:.3f} s", flush=True)
    if tp_counts["fused_rdb"] != 69 * slices or tp_db < MIN_PSNR_DB or tp_err > 1e-5:
        fail(f"tp: launches {tp_counts}, {tp_db:.1f} dB, fp32 {tp_err}")
    del dp, tps

    # (g) batched dp: run_batch's whole-image stack split over 2 data slices
    p2p_dir = os.path.join(work, "batch_p2p_in")
    p2p_imgs = [iio.read_img(os.path.join(p2p_dir, f))
                for f in sorted(os.listdir(p2p_dir)) if f.endswith("_256x256.png")][:8]
    cg_dir = os.path.join(work, "batch_cg_in")
    cg_imgs = [iio.read_img(os.path.join(cg_dir, f)) for f in sorted(os.listdir(cg_dir))]
    lines = []
    cases = (("pix2pix unet_256 ngf=64", "p2p_synth_unet256.pth", "unet_256", p2p_imgs, (bf16,)),
             ("CycleGAN resnet_9blocks ngf=64", "cyclegan9_synth.pth", "resnet_9blocks", cg_imgs,
              (bf16, fp32)))
    for label, name, arch, batch_imgs, dts in cases:
        for dt in dts:
            outs, counts, ms_b = {}, {}, {}
            for key, mesh in (("mesh", mesh2), ("free", None)):
                sess = InferenceSession(os.path.join(work, name), arch=arch, compute_dtype=dt,
                                        mesh=mesh, presets=select_presets(arch))
                sess.run_batch(batch_imgs)  # untimed: cuDNN's set-up of the shapes
                reset_counts()
                outs[key], ms_b[key] = timed_once(torch, lambda: sess.run_batch(batch_imgs))
                counts[key] = read_counts()["fused_resnet_block"]
            d = [np.abs(a.astype(np.int32) - b.astype(np.int32))
                 for a, b in zip(outs["mesh"], outs["free"])]
            share = float(np.mean([(x <= 1).mean() for x in d]))
            worst = max(int(x.max()) for x in d)
            db = psnr(np.stack(outs["mesh"]), np.stack(outs["free"]), 255.0)
            lines.append(f"{label} {str(dt)[6:]} x{len(batch_imgs)} "
                         f"{batch_imgs[0].shape[0]}x{batch_imgs[0].shape[1]}: "
                         f"{100 * share:.4f}% within one level, max diff {worst}, PSNR {db:.1f} "
                         f"dB; fused_resnet_block {counts['mesh']} against {counts['free']} "
                         f"mesh-free; {ms_b['mesh']:.1f} ms against {ms_b['free']:.1f} ms "
                         f"(second run)")
            if arch == "unet_256":
                ok = share == 1.0 and counts == {"mesh": 0, "free": 0}
            else:
                ok = (counts == {"mesh": 18, "free": 9}
                      and (db >= MIN_PSNR_DB if dt == bf16 else share == 1.0))
            if not ok:
                fail(f"batched dp {label} {dt}: {lines[-1]}")
    print("[parallel] batched dp, run_batch on 2 data slices of cuda:0 against no mesh (bars: "
          "pix2pix and CycleGAN fp32 100% within one level, CycleGAN bf16 "
          f"{MIN_PSNR_DB} dB; 9 fused_resnet_block launches per slice of (4,128,128,256)): "
          + "; ".join(lines), flush=True)


MP_SCRIPT = """
import atexit, runpy, sys, time
t0 = time.perf_counter()
sys.path.insert(0, {root!r})
def report():
    from innfer_tpu_torch.ops.rdb import fused_rdb
    print("MP_REPORT", fused_rdb.launches, time.perf_counter() - t0, flush=True)
atexit.register(report)
sys.argv = ["innfer_tpu_torch.cli"] + sys.argv[1:]
runpy.run_module("innfer_tpu_torch.cli", run_name="__main__", alter_sys=True)
"""


def phase_multiproc(dev, work, main, size=(540, 960), cli_args=()):
    """Two CLI processes share cuda:0, joined over gloo at a localhost
    coordinator; each writes its stripe, and the stripes together equal a
    single-process CLI run."""
    import gc
    import socket

    import numpy as np
    import torch

    from innfer_tpu_torch.io import images as iio

    # the children share the card with this process: hand back the blocks
    # the earlier phases left in PyTorch's caching allocator
    gc.collect()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_reserved() / 2 ** 30
    in_dir = os.path.join(work, "mp_in")
    os.makedirs(in_dir)
    for i in range(4):
        iio.save_img(synth_image(*size, seed=180 + i),
                     os.path.join(in_dir, f"{i}_{size[0]}x{size[1]}.png"))
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    script = MP_SCRIPT.format(root=HERE)
    env = dict(os.environ, PYTHONPATH=HERE, GLOO_SOCKET_IFNAME="lo")
    base = [sys.executable, "-c", script, "-m", main["ckpt"], "-i", in_dir, *cli_args]

    def start(out, extra):
        return subprocess.Popen(base + ["-o", out] + extra, cwd=HERE, env=env,
                                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)

    def finish(procs):
        results = []
        try:
            for p, t0 in procs:
                log = p.communicate(timeout=300)[0]
                results.append((p.returncode, log, time.perf_counter() - t0))
        finally:
            for p, _ in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        return results

    outs = [os.path.join(work, f"mp_out{r}") for r in (0, 1)]
    procs = [(start(outs[r], ["--coordinator", f"127.0.0.1:{port}", "--num-processes", "2",
                              "--process-id", str(r)]), time.perf_counter()) for r in (0, 1)]
    results = finish(procs)
    single = os.path.join(work, "mp_single")
    results += finish([(start(single, []), time.perf_counter())])
    reports = []
    for rc, log, wall in results:
        rep = [ln.split() for ln in log.splitlines() if ln.startswith("MP_REPORT")]
        if rc != 0 or not rep:
            fail(f"a [multiproc] CLI process exited {rc}:\n{log[-4000:]}")
        reports.append((int(rep[-1][1]), float(rep[-1][2]), wall))
    names = sorted(os.listdir(in_dir))
    got = [sorted(os.listdir(o)) for o in outs]
    want = [[n for i, n in enumerate(names) if i % 2 == r] for r in (0, 1)]
    if got != want:
        fail(f"the processes wrote {got}, expected the stripes {want}")
    pairs = [(os.path.join(outs[i % 2], n), os.path.join(single, n)) for i, n in enumerate(names)]
    share, worst, db = u8_diff(*zip(*pairs))
    same = all(np.array_equal(iio.read_img(a), iio.read_img(b)) for a, b in pairs)
    print(f"[multiproc] 2 CLI processes on cuda:0 (gloo, coordinator 127.0.0.1), 4 PNGs of "
          f"{size[0]}x{size[1]}, bf16: " + "; ".join(
              f"rank {r}: wrote {got[r]}, fused_rdb launches {reports[r][0]} (69 per image), "
              f"wall {reports[r][2]:.2f} s ({reports[r][1]:.2f} s inside the process)"
              for r in (0, 1))
          + f"; one process: fused_rdb {reports[2][0]}, wall {reports[2][2]:.2f} s; this "
          f"process held {held:.2f} GiB of the card meanwhile; union "
          f"against it: {'identical' if same else 'not identical'}, {100 * share:.4f}% within "
          f"one level (bar 100%), max diff {worst}, PSNR {db:.1f} dB", flush=True)
    if [r[0] for r in reports] != [138, 138, 276] or share < 1.0:
        fail(f"[multiproc]: launches {[r[0] for r in reports]}, share {share}")


def phase_determinism(dev, work):
    """C4: pix2pix and CycleGAN, whose upsampling runs F.conv_transpose2d
    (a cuDNN backward-data conv), give the same u8 outputs in two passes
    on one session and in a pass on a second session, bf16 and fp32.
    Reads [i2i]'s and [cyclegan]'s checkpoints from the work directory."""
    import numpy as np
    import torch

    from innfer_tpu_torch.pipeline import InferenceSession

    cases = (("pix2pix unet_256 ngf=64, 8 x 256x256", "p2p_synth_unet256.pth", "unet_256",
              [synth_image(256, 256, seed=170 + i) for i in range(8)]),
             ("CycleGAN resnet_9blocks ngf=64, 512x512", "cyclegan9_synth.pth",
              "resnet_9blocks", [synth_image(512, 512, seed=180)]))
    differ = []
    for label, name, arch, imgs in cases:
        for dt in (torch.bfloat16, torch.float32):
            runs = []
            for passes in (2, 1):
                sess = InferenceSession(os.path.join(work, name), arch=arch, compute_dtype=dt,
                                        tile_mode="auto")
                runs += [np.stack(sess.run_batch(imgs)) for _ in range(passes)]
                del sess
            pairs = []
            for (i, j), what in (((0, 1), "pass 1 vs pass 2 of one session"),
                                 ((0, 2), "session 1 vs session 2"),
                                 ((1, 2), "pass 2 vs session 2")):
                d = np.abs(runs[i].astype(np.int32) - runs[j].astype(np.int32))
                pairs.append(f"{what}: {100 * float((d == 0).mean()):.4f}% equal, "
                             f"max diff {int(d.max())}")
                if d.any():
                    differ.append(f"{label} {str(dt)[6:]} {what}")
            print(f"[determinism] {label}, {str(dt)[6:]}, cudnn benchmark="
                  f"{torch.backends.cudnn.benchmark} deterministic="
                  f"{torch.backends.cudnn.deterministic}: " + "; ".join(pairs), flush=True)
    if differ:
        fail("C4: outputs differ between passes: " + "; ".join(differ))


E2E_IMGS = 2   # images per _e2e pass in [bench]: 8 took 103 s of the phase on the H100


def phase_bench():
    """bench_torch.py's ten configs at their defaults with --iters 3 (the
    _e2e configs on E2E_IMGS images), each line printed by the bench.
    bench_torch.main exits 1 where an output misses its fidelity bar; here
    each kernel's launches per step must be those of its path and 0 on the
    kernel-free configs."""
    import bench_torch

    want = {"esrgan": {"fused_rdb": 69}, "chain": {"fused_rdb": 138},
            "esrgan_e2e": {"fused_rdb": 69 * E2E_IMGS}}
    t0 = time.perf_counter()
    for model in bench_torch.CONFIGS:
        t1 = time.perf_counter()
        os.environ["INNFER_E2E_IMGS"] = str(E2E_IMGS)
        try:
            line = bench_torch.main(["--model", model, "--iters", "3"])
        finally:
            del os.environ["INNFER_E2E_IMGS"]
        got = {k: v for k, v in line["launches"].items() if v}
        if model == "cyclegan":
            ok = set(got) == {"fused_resnet_block"} and got["fused_resnet_block"] % 9 == 0
        else:
            ok = got == want.get(model, {})
        print(f"[bench] {model}: {line['value']:.3f} MP/s, median {line['median_ms']:.2f} ms "
              f"of {line['n']}, set-up {line['setup_s']:.2f} s, fidelity "
              f"{line['fidelity_db']} dB (bar {line['fidelity_bar_db']}), launches per step "
              f"{got or 0}; {time.perf_counter() - t1:.1f} s", flush=True)
        if not ok:
            fail(f"[bench] {model}: launches per step {got}, expected {want.get(model, {})}"
                 + (" (fused_resnet_block, 9 per tile group)" if model == "cyclegan" else ""))
    print(f"[bench] {len(bench_torch.CONFIGS)} configs in {time.perf_counter() - t0:.1f} s",
          flush=True)


def main() -> int:
    if not os.path.isdir(os.path.join(HERE, "innfer_tpu_torch")):
        fail("innfer_tpu_torch/ is not beside chip_smoke.py: run it from a checkout")
    sys.path.insert(0, HERE)
    kind, count, smi = phase_device()
    import torch

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    reports = phase_build()
    with torch.no_grad():
        timing = phase_kernel(dev)
        tail_rows = phase_tail_conv(dev)
        dil_row = phase_dilated(dev, reports.get("dilated_block", {}))
        with tempfile.TemporaryDirectory() as work:
            main = phase_main(dev, work)
            phase_tail(dev, work, main)
            pad, trunk = phase_chain(dev, work, main)
            rb = phase_resnet_block(dev)
            in_row = phase_instance_norm(dev)
            cg_counts = phase_cyclegan(dev, work)
            wa_row = phase_window_attn(dev, reports)
            tg_rows = phase_token_gemm(dev, reports)
            swin = phase_swinir(dev, work)
            hat_rows = phase_hat_attn(dev, reports)
            hat = phase_hat(dev, work)
            for site, row in hat_rows.items():
                row["launches"] = (hat["overlap_attn"] if site == "oca" else
                                   hat["hat_window_attn"] / 2)
            wa_row["launches"] = swin["window_attn"]
            for row in tg_rows.values():
                row["launches"] = swin["token_linear"] / len(tg_rows)
            rb["launches"] = cg_counts["fused_resnet_block"]
            in_row["launches"] = cg_counts["fused_instance_norm"]
            dil_row["launches"] = phase_zoo(dev, work, main)["ppon"]["dilated_launches"]
            phase_ts(dev, work, main)
            phase_i2i(dev, work, main)
            phase_batch(dev, work)
            phase_evsrgan(dev, work, main)
            phase_convert(dev, work, main)
            phase_codec(work, main)
            phase_stages(dev, work, main)
            phase_parallel(dev, work, main)
            phase_multiproc(dev, work, main)
            phase_determinism(dev, work)
        phase_bench()
    rdb_src = "innfer_tpu_torch/ops/csrc/rdb.cu"
    kernels = [
        {"name": "fused_rdb", "route": "cuda", "source": rdb_src,
         "replaces": "innfer_tpu/ops/pallas/rdb.py:539", "launches": main["launches"], **timing},
        {"name": "fused_rdb_padded", "route": "cuda", "source": rdb_src,
         "replaces": "innfer_tpu/ops/pallas/rdb.py:691", **pad},
        {"name": "fused_rrdb_trunk", "route": "cuda", "source": rdb_src,
         "replaces": "innfer_tpu/ops/pallas/rdb.py:749", **trunk},
        {"name": "fused_resnet_block", "route": "cuda",
         "source": "innfer_tpu_torch/ops/csrc/resnet_block.cu",
         "replaces": "innfer_tpu/ops/pallas/resnet_block.py:169", **rb},
    ] + [{"name": f"tail_conv.{conv}", "route": "cuda",
          "source": "innfer_tpu_torch/ops/csrc/tail_conv.cu",
          "replaces": "XLA's convs of innfer_tpu/models/common.py's tail (no TPU kernel)",
          "launches": main["tail_groups"], **row} for conv, row in tail_rows.items()] + [
        {"name": "fused_dilated_block", "route": "cuda",
         "source": "innfer_tpu_torch/ops/csrc/dilated_block.cu",
         "replaces": "XLA's convs of innfer_tpu/models/ppon.py::_res_block_32 (no TPU kernel)",
         **dil_row},
        {"name": "fused_instance_norm", "route": "cuda",
         "source": "innfer_tpu_torch/ops/csrc/instance_norm.cu",
         "replaces": "XLA's instance norm of innfer_tpu/nn/functional.py (no TPU kernel)",
         **in_row},
        {"name": "window_attn", "route": "cuda",
         "source": "innfer_tpu_torch/ops/csrc/window_attn.cu",
         "replaces": "none: the JAX package has no SwinIR", **wa_row}] + [
        {"name": f"token_linear.{site}", "route": "cuda",
         "source": "innfer_tpu_torch/ops/csrc/token_gemm.cu",
         "replaces": "none: the JAX package has no SwinIR", **row}
        for site, row in tg_rows.items()] + [
        {"name": f"{'overlap_attn' if site == 'oca' else 'hat_window_attn'}.{site}",
         "route": "cuda", "source": "innfer_tpu_torch/ops/csrc/hat_attn.cu",
         "replaces": "none: the JAX package has no HAT", **row}
        for site, row in hat_rows.items()]
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms", "tflops", "bound_share")
    print(json.dumps({"kernels": [{k: row[k] for k in keys} for row in kernels]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
