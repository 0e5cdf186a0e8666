#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (innfer_tpu_torch) through its paths on one
NVIDIA GPU, and hold each of its CUDA kernels against the kernel's plain
version.

    python3 chip_smoke.py

Phases, each printing its lines (any failure exits non-zero, and without
the final result line):
  1. device   the card's name, the device count and nvidia-smi's name and
              power limit;
  2. build    both kernel libraries (ops/csrc/rdb.cu, resnet_block.cu,
              each with the shared ops/csrc/conv3x3_tc.cuh) built at once
              with nvcc (sm_90a); for each, ptxas' registers and spills of
              every tensor-core conv (conv_wgmma, one per N tile) with its
              dynamic shared memory, and the count of HGMMA (wgmma)
              instructions in the library's SASS (cuobjdump), which must be
              above 0;
  3. kernel   fused_rdb against rdb_reference at nf=64, gc=32 on
              (1, 64, 1920, 64) strips, bf16 and fp32, with and without the
              ESRGAN+ plus; then timed with CUDA events at the main-path
              shape (1, 1088, 1920, 64) bf16 beside its bound, the plain
              version and the cuDNN conv chain (the library yardstick,
              which the port never calls), with the achieved TFLOP/s and
              the share of the bound;
  4. main     a seeded synthetic 4x ESRGAN (nb=23, nf=64, gc=32, upconv)
              saved with torch.save, and seeded 540x960 and 1080x1920
              PNGs, run through InferenceSession.process in bf16 with
              tile_mode="auto" (auto-detection, auto -> hybrid): exactly
              69 fused_rdb launches per image, 4x PNGs read back, and the
              same images through backend="torch" at >= 40 dB;
  5. chain    at the main-path shape (1, 1088, 1920, 64) bf16: one
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
  6. resnet_block  fused_resnet_block against resnet_block_reference at
              the CycleGAN path's shape (8, 138, 64, 256) and on a ragged
              slab (3, 37, 29, 256), bf16 and fp32, with and without bias
              (fp32: max-abs 1e-4; bf16: PSNR >= 55 dB and every value
              within 2^-7 (|ref| + |ref - x| + 1), one bf16 ulp of the sum,
              of h2 and of IN's unit scale); then timed beside its bound,
              the plain version and cuDNN convs + F.instance_norm, with
              TFLOP/s and share of the bound;
  7. cyclegan a seeded synthetic CycleGAN resnet_9blocks (ngf=64) state
              dict with legacy InstanceNorm running-stat keys, and seeded
              512x512 and 1080x1920 PNGs, through InferenceSession with the
              cyclegan preset (non-strict load, [-1, 1]) in bf16,
              tile_mode="auto": 9 fused_resnet_block launches per tile
              group, 1x PNGs, >= 40 dB against backend="torch", and fp32
              kernel path vs torch path >= 80 dB on a small input;
  8. result   the kernels line (each kernel also with "tflops", its
              achieved rate, and "bound_share", bound_ms / ms), the card
              line and, last,
              {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Each path (main, chain, cyclegan) runs with every kernel's launch count set
to 0 just before it and read just after; launches made to compare a kernel
with its plain version are not counted.
"""
from __future__ import annotations

import json
import math
from concurrent.futures import ThreadPoolExecutor
import os
import re
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
LIBS = ("rdb", "resnet_block")


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
    print(f"[device] {kind}; device count {count}; nvidia-smi: {smi}; "
          f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
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


def phase_build():
    from innfer_tpu_torch.ops import _build

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(LIBS)) as pool:  # one nvcc per source, at once
        built = dict(zip(LIBS, pool.map(_build.build, LIBS)))
    for name, b in built.items():
        where = os.path.relpath(b.path, HERE)
        hgmma = sass_count(b.path, "HGMMA")
        if not b.ptxas:
            print(f"[build] {where} was already built; HGMMA in SASS: {hgmma}", flush=True)
        else:
            lib = _build.library(name)
            kernels = ptxas_kernels(b.ptxas)
            tc = []
            for func, k in sorted(kernels.items()):
                m = re.search(r"conv_wgmmaILi(\d+)E", func)
                if m:
                    nt = int(m.group(1))
                    tc.append((nt, f"N={nt}: {k['regs']} regs, {k['spill']} B spilled, "
                                   f"{lib.innfer_conv_tc_smem_bytes(nt)} B dynamic smem"))
            others = [k for f, k in kernels.items() if "conv_wgmma" not in f]
            print(f"[build] {where}: nvcc {b.seconds:.1f} s; wgmma convs: "
                  f"{'; '.join(t for _, t in sorted(tc))}; other kernels: {len(others)}, "
                  f"registers {min(k['regs'] for k in others)}-"
                  f"{max(k['regs'] for k in others)}, spills "
                  f"{sum(k['spill'] for k in others)} B; HGMMA in SASS: {hgmma}", flush=True)
        if hgmma == 0:
            fail(f"{where} holds no HGMMA instruction: the bf16 conv is not on the tensor cores")
    print(f"[build] {len(LIBS)} libraries in {time.perf_counter() - t0:.1f} s", flush=True)


def kernel_counters():
    from innfer_tpu_torch.ops.rdb import fused_rdb, fused_rdb_padded, fused_rrdb_trunk
    from innfer_tpu_torch.ops.resnet_block import fused_resnet_block

    return {f.__name__: f for f in (fused_rdb, fused_rdb_padded, fused_rrdb_trunk,
                                    fused_resnet_block)}


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
    return row


def phase_main(dev, work):
    import numpy as np
    import torch

    from innfer_tpu_torch.io import images as iio
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
    cfg = sess.stage.model.cfg
    if (cfg["nb"], cfg["nf"], cfg["gc"], sess.stage.model.scale) != (23, NF, GC, 4):
        fail(f"auto-detection read the checkpoint as {cfg}")
    runner = sess.stage.runner
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
    if sum(counts.values()) != launches:
        fail(f"the default ESRGAN path launched other kernels: {counts}")
    device_ms = [{k: sum(a.elapsed_time(b) for a, b in v) for k, v in im.items()}
                 for im in per_image]

    ref_sess = InferenceSession(ckpt, compute_dtype=torch.bfloat16, tile_mode="auto",
                                backend="torch")
    ref_dir = os.path.join(work, "out_torch")
    t0 = time.perf_counter()
    ref_sess.process(in_dir, ref_dir, verbose=False)
    torch.cuda.synchronize()
    ref_wall = time.perf_counter() - t0
    if fused_rdb.launches != launches:
        fail("backend='torch' launched the kernel")

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
          f"launches {launches} (69 per image); wall {wall:.3f} s for both "
          f"(backend='torch' {ref_wall:.3f} s); CUDA events: {times}; PSNR vs "
          f"backend='torch' {', '.join(f'{d:.1f}' for d in dbs)} dB", flush=True)
    if min(dbs) < MIN_PSNR_DB:
        fail(f"kernel path vs torch path PSNR {min(dbs):.1f} dB < {MIN_PSNR_DB}")

    # fp32 on a small input: the kernel path is true fp32 end to end
    small = torch.rand(1, 40, 56, 3, generator=torch.Generator().manual_seed(7)).to(dev)
    model, params = sess.stage.model, sess.stage.params
    p32 = {k: v.float() for k, v in params.items()}
    with torch.no_grad():
        a = model.apply(p32, small)
        ref_model = ref_sess.stage.model
        b = ref_model.apply(p32, small)
    db32 = psnr(a.cpu(), b.cpu(), 1.0)
    print(f"[main] fp32 (1,40,56,3): kernel path vs torch path PSNR {db32:.1f} dB", flush=True)
    if db32 < 80.0 or not torch.isfinite(a).all():
        fail(f"fp32 kernel path vs torch path PSNR {db32:.1f} dB < 80")
    return {"launches": launches, "ckpt": ckpt, "in_dir": in_dir, "out_dir": out_dir,
            "n_images": len(sizes)}


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
            "fused_resnet_block": 0}
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
    return row


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


def time_images(torch, sess) -> list:
    """Wrap the session's tiled runner with CUDA events; returns the list
    that gets one (start, end) pair per image."""
    runner, events = sess.stage.runner, []

    def timed(params, x):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        out = runner(params, x)
        e1.record()
        events.append((e0, e1))
        return out

    sess.stage.runner = timed
    return events


def phase_cyclegan(dev, work):
    """Path 1: the CycleGAN resnet_9blocks through the session."""
    import numpy as np
    import torch

    from innfer_tpu_torch.io import images as iio
    from innfer_tpu_torch.models import resnet as resnet_model
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
    cfg, params = sess.stage.model.cfg, sess.stage.params
    if (cfg["n_blocks"], params["model.1.weight"].shape[0]) != (CG_BLOCKS, CG_NGF):
        fail(f"the session built {cfg} with ngf {params['model.1.weight'].shape[0]}")
    if presets.strict or any("running_" in k for k in params):
        fail("the cyclegan preset did not drop the legacy InstanceNorm keys")
    runner = sess.stage.runner
    groups = {}
    for name, (h, w) in sizes.items():
        plan = runner.plan_for(h, w, on_cuda=True)
        chunk = plan.chunk or min(runner.tile_batch, plan.n_tiles)
        groups[name] = (-(-plan.n_tiles // chunk), plan.tile_h, plan.tile_w, plan.n_tiles, chunk)
    events = time_images(torch, sess)
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
    want = {"fused_rdb": 0, "fused_rdb_padded": 0, "fused_rrdb_trunk": 0,
            "fused_resnet_block": CG_BLOCKS * sum(g[0] for g in groups.values())}
    if runner.last_mode != "auto":
        fail(f"tile_mode auto ran {runner.last_mode!r} for the CycleGAN")
    if counts != want:
        fail(f"CycleGAN session launches {counts}; expected {want} (plans {groups})")
    device_ms = [a.elapsed_time(b) for a, b in events]
    block_ms = [sum(a.elapsed_time(b) for i, a, b in blocks if i == k) for k in range(len(sizes))]

    ref_sess = InferenceSession(ckpt, backend="torch", **kw)
    ref_events = time_images(torch, ref_sess)
    ref_dir = os.path.join(work, "cg_out_torch")
    t0 = time.perf_counter()
    ref_sess.process(in_dir, ref_dir, verbose=False)
    torch.cuda.synchronize()
    ref_wall = time.perf_counter() - t0
    if read_counts() != counts:
        fail("backend='torch' launched a kernel")
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
        f"backend='torch' {a.elapsed_time(z):.1f} ms)"
        for n, t, b, (a, z) in zip(sizes, device_ms, block_ms, ref_events))
    print(f"[cyclegan] resnet_9blocks ngf={CG_NGF}, {len(sizes)} images in bf16, mode "
          f"{runner.last_mode} ({plans}): fused_resnet_block launches "
          f"{counts['fused_resnet_block']}; wall {wall:.3f} s for both (backend='torch' "
          f"{ref_wall:.3f} s); CUDA events per image: {times}; PSNR vs backend='torch' "
          f"{', '.join(f'{d:.1f}' for d in dbs)} dB (bar {MIN_PSNR_DB})", flush=True)
    if min(dbs) < MIN_PSNR_DB:
        fail(f"CycleGAN kernel path vs torch path PSNR {min(dbs):.1f} dB < {MIN_PSNR_DB}")

    # fp32 on a small input: the kernel path is true fp32 end to end
    small = (torch.rand(1, 64, 96, 3, generator=torch.Generator().manual_seed(42)) * 2 - 1).to(dev)
    p32 = {k: v.float() for k, v in params.items()}
    a = sess.stage.model.apply(p32, small)
    b = ref_sess.stage.model.apply(p32, small)
    db32 = psnr(a.cpu(), b.cpu(), 1.0)
    print(f"[cyclegan] fp32 (1,64,96,3): kernel path vs torch path PSNR {db32:.1f} dB (bar 80)",
          flush=True)
    if db32 < 80.0 or not torch.isfinite(a).all():
        fail(f"fp32 CycleGAN kernel path vs torch path PSNR {db32:.1f} dB < 80")
    return counts["fused_resnet_block"]


def main() -> int:
    if not os.path.isdir(os.path.join(HERE, "innfer_tpu_torch")):
        fail("innfer_tpu_torch/ is not beside chip_smoke.py: run it from a checkout")
    sys.path.insert(0, HERE)
    kind, count, smi = phase_device()
    import torch

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    phase_build()
    with torch.no_grad():
        timing = phase_kernel(dev)
        with tempfile.TemporaryDirectory() as work:
            main = phase_main(dev, work)
            pad, trunk = phase_chain(dev, work, main)
            rb = phase_resnet_block(dev)
            rb["launches"] = phase_cyclegan(dev, work)
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
    ]
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms", "tflops", "bound_share")
    print(json.dumps({"kernels": [{k: row[k] for k in keys} for row in kernels]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
