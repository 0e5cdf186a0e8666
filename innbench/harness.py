"""One run of one cell: set-up, warm-up, the measured window, the per-layer
readings of a traced run, and the comparison with the plain reference.

Everything a cell is made of is found by name (``BENCHMARK.json`` at the
checkout's root names them): the configuration ``configs/<config>.json``,
the traffic mix ``traffic/<traffic>.json``, the comparison's limits
``limits/<cell>.json``, the configuration's plain reference
``reference/<arch>.py`` and its operation counts ``flops/<arch>.py``, and
each per-layer metric's reader ``metrics/<metric>.py``.
"""
from __future__ import annotations

import gc
import importlib.util
import json
import math
import os
import os.path as osp
import random
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from innbench import png, trace, traffic as T

FORBIDDEN = ("jax", "jaxlib", "flax", "innfer_tpu")


class CellError(RuntimeError):
    """The run cannot give a result (no card, a missing file, a bad name)."""


def load_json(path: str):
    with open(path) as f:
        return json.load(f)


def load_module(path: str, name: str):
    """A module from its file; a per-layer metric's name may hold dots."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclass
class Cell:
    name: str
    workload: dict
    config: dict
    traffic: dict
    limits: dict
    ref: object
    flops: object
    end_to_end: List[dict]
    per_layer: List[dict]
    readers: Dict[str, object]
    bench_dir: str

    @property
    def model(self) -> dict:
        return self.config["model"]

    @property
    def session(self) -> dict:
        return self.config["session"]


def _for(metric: dict, cell: str) -> bool:
    return cell in metric.get("workloads", [cell])


def load_cell(root: str, name: str) -> Cell:
    """The cell ``name`` of the checkout at ``root``, its parts found by name."""
    bench = load_json(osp.join(root, "BENCHMARK.json"))
    bench_dir = osp.join(root, "innbench")
    found = [w for w in bench["workloads"] if w["name"] == name]
    if not found:
        raise CellError(f"no workload {name!r} in BENCHMARK.json")
    wl = found[0]
    cfg_entry = [c for c in bench["configs"] if c["name"] == wl["config"]][0]
    config = load_json(osp.join(root, cfg_entry["file"]))
    mix = load_json(osp.join(bench_dir, "traffic", wl["traffic"] + ".json"))
    if mix["kind"] not in T.KINDS:
        raise CellError(f"traffic {wl['traffic']}: unknown kind {mix['kind']!r}")
    arch = config["arch"]
    per_layer = [m for m in bench["per_layer"] if _for(m, name)]
    readers = {m["name"]: load_module(osp.join(bench_dir, "metrics", m["name"] + ".py"),
                                      "innbench_metric_" + m["name"].replace(".", "_"))
               for m in per_layer}
    return Cell(name=name, workload=wl, config=config, traffic=mix,
                limits=load_json(osp.join(bench_dir, "limits", name + ".json")),
                ref=load_module(osp.join(bench_dir, "reference", arch + ".py"),
                                "innbench_reference_" + arch),
                flops=load_module(osp.join(bench_dir, "flops", arch + ".py"),
                                  "innbench_flops_" + arch),
                end_to_end=[m for m in bench["end_to_end"] if _for(m, name)],
                per_layer=per_layer, readers=readers, bench_dir=bench_dir)


def forbidden_modules() -> List[str]:
    """The top-level names of loaded modules that a run must not load."""
    tops = {m.split(".", 1)[0] for m in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


def init_card() -> None:
    """Card 0 current, with its CUDA context made (inside ``setup_s``)."""
    torch.cuda.set_device(0)
    torch.zeros(1, device="cuda")
    torch.cuda.synchronize()


def smi(query: str) -> str:
    try:
        return subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
                              capture_output=True, text=True, timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable: {e}"


def io_counters() -> Dict[str, int]:
    """This process's bytes written (``write_bytes``: to storage; ``wchar``:
    through write calls), from /proc."""
    try:
        with open("/proc/self/io") as f:
            rows = dict(line.split(":") for line in f.read().splitlines())
        return {k: int(rows[k]) for k in ("write_bytes", "wchar")}
    except (OSError, KeyError, ValueError):
        return {}


def launch_counters(config: dict) -> Dict[str, object]:
    """The program's kernel wrappers whose ``.launches`` the configuration
    names (``"module:attribute"``), by attribute."""
    out = {}
    for spec in config.get("launch_counters", []):
        mod, attr = spec.split(":")
        out[attr] = getattr(importlib.import_module(mod), attr)
    return out


@dataclass
class Window:
    """What the measured window did, on the host's clock."""

    wall_s: float = 0.0
    latencies_s: List[float] = field(default_factory=list)
    out_px: int = 0
    attempted: int = 0
    failed: int = 0
    images: List[Tuple[int, int]] = field(default_factory=list)   # input (h, w) finished
    samples: list = field(default_factory=list)
    timers: Optional[dict] = None
    passes: int = 0
    pass_s: List[float] = field(default_factory=list)


def p95(values: List[float]) -> float:
    """The 95th percentile (linear between order statistics)."""
    if len(values) == 1:
        return values[0]
    return statistics.quantiles(values, n=20, method="inclusive")[-1]


def end_to_end(kind: str, win: Window, setup_s: float) -> Dict[str, float]:
    """The host-clock readings of a window: output megapixels over the
    window's wall time (every frame returned, or every PNG of the whole
    passes), and a frame loop's 95th-percentile latency over all frames."""
    mp_s = win.out_px / 1e6 / win.wall_s
    if kind == "frames":
        return {"setup_s": setup_s, "frames_mp_s": mp_s,
                "frame_p95_ms": 1e3 * p95(win.latencies_s)}
    return {"setup_s": setup_s, "dir_mp_s": mp_s}


@dataclass
class Context:
    """What a per-layer metric's reader may read."""

    cell: Cell
    window: Window
    trace: Optional[trace.Trace]
    peaks: Optional[dict]
    act_bytes: int

    def kernel_work(self, kernel: str) -> Tuple[float, float]:
        flops = nbytes = 0.0
        for h, w in self.window.images:
            got = self.cell.flops.kernel_work(self.cell.model, kernel, h, w, self.act_bytes)
            if got is None:
                return 0.0, 0.0
            flops, nbytes = flops + got[0], nbytes + got[1]
        return flops, nbytes

    def step_flops(self) -> float:
        return sum(self.cell.flops.image_flops(self.cell.model, h, w)
                   for h, w in self.window.images)


class Run:
    """One run of a cell on ``device`` (the card; the CPU only in tests)."""

    def __init__(self, cell: Cell, seed: int, seconds: float, traced: bool, *,
                 device: str = "cuda", t0: Optional[float] = None, log=print):
        self.cell, self.seed, self.seconds, self.traced = cell, seed, seconds, traced
        self.device = torch.device(device)
        self.t0 = time.perf_counter() if t0 is None else t0
        self.log = log
        self.work = tempfile.mkdtemp(prefix="innbench_")
        self.made: Dict[str, float] = {}   # seconds of the harness's own making

    # -- set-up --------------------------------------------------------------

    def checkpoint(self) -> str:
        """The seeded weights in the published key layout, made on the
        device and saved as a checkpoint file, as a user's would be; the
        program loads it, and the reference reads it again.  Making it is
        the harness's work, like making the images: its seconds go to
        ``made`` and stay out of ``setup_s``.  The last conv's calibration
        runs the reference without cuDNN, so that loading cuDNN stays the
        program's cost."""
        t = time.perf_counter()
        with torch.backends.cudnn.flags(enabled=False):
            state = self.cell.ref.make_state(self.cell.model, self.seed, self.device)
        w = list(state.values())[-2]   # the last conv's weight, which make_state scaled
        gain = w.flatten(1).square().mean(1).sqrt() * math.sqrt(w[0].numel())
        self.log(f"[weights] last conv's gain per output channel {gain.tolist()}")
        self.ckpt = osp.join(self.work, self.cell.config["checkpoint"])
        torch.save({k: v.cpu() for k, v in state.items()}, self.ckpt)
        del state
        self.made["checkpoint"] = time.perf_counter() - t
        return self.ckpt

    def _session(self, ckpt: str):
        from innfer_tpu_torch.cli import resolve_batch
        from innfer_tpu_torch.pipeline import InferenceSession, select_presets

        s = self.cell.session
        presets = select_presets(s["arch"], ckpt)
        sess = InferenceSession(
            ckpt, arch=s["arch"], presets=presets,
            compute_dtype={"bf16": torch.bfloat16, "fp32": torch.float32}[s["dtype"]],
            tile=s["tile"], overlap=s["overlap"], tile_mode=s["tile_mode"],
            tile_batch=s["tile_batch"], device=None if self.device.type == "cuda" else "cpu")
        return sess, resolve_batch(s["batch"], presets)

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- the two kinds of traffic ------------------------------------------------

    def _frames(self, sess, frames_bgr: np.ndarray, prof_ctx) -> Window:
        s = self.cell.model.get("scale", 1)
        want = (frames_bgr.shape[1] * s, frames_bgr.shape[2] * s, 3)
        k = self.cell.traffic["sample"]
        pick = random.Random(self.seed * 7919 + 1)
        win = Window()
        n = len(frames_bgr)
        with prof_ctx as prof, torch.profiler.record_function(trace.WINDOW):
            start = time.perf_counter()
            while True:
                i = win.attempted
                t1 = time.perf_counter()
                with torch.profiler.record_function("innbench.run_image"):
                    out = sess.run_image(frames_bgr[i % n])
                t2 = time.perf_counter()
                win.attempted += 1
                win.latencies_s.append(t2 - t1)
                if out.shape != want or out.dtype != np.uint8:
                    win.failed += 1
                else:
                    win.out_px += want[0] * want[1]
                    win.images.append(frames_bgr.shape[1:3])
                # a reservoir: a uniform sample of the window's frames
                if len(win.samples) < k:
                    win.samples.append((i % n, out))
                else:
                    j = pick.randrange(win.attempted)
                    if j < k:
                        win.samples[j] = (i % n, out)
                if t2 - start >= self.seconds:
                    break
            win.wall_s = time.perf_counter() - start
        self.prof = prof
        return win

    def _dir(self, sess, batch: int, in_dir: str, sizes: Dict[str, Tuple[int, int]],
             prof_ctx, timers) -> Window:
        s = self.cell.model.get("scale", 1)
        win = Window()
        with prof_ctx as prof, torch.profiler.record_function(trace.WINDOW):
            start = time.perf_counter()
            while True:
                out_dir = osp.join(self.work, f"out{win.passes}")
                t1 = time.perf_counter()
                with torch.profiler.record_function("innbench.process"):
                    written = sess.process(in_dir, out_dir, verbose=False, batch=batch,
                                           timers=timers)
                win.pass_s.append(time.perf_counter() - t1)
                win.passes += 1
                win.attempted += len(sizes)
                for p in written:
                    h, w = sizes[osp.splitext(osp.basename(p))[0]]
                    win.out_px += h * w * s * s
                    win.images.append((h, w))
                if time.perf_counter() - start >= self.seconds:
                    break
            win.wall_s = time.perf_counter() - start
        self.prof = prof
        # every output of every pass is there, at its size
        for k in range(win.passes):
            for name, (h, w) in sizes.items():
                p = osp.join(self.work, f"out{k}", name + ".png")
                try:
                    ok = png.size(p) == (h * s, w * s)
                except (OSError, ValueError):
                    ok = False
                win.failed += not ok
        return win

    # -- the comparison ----------------------------------------------------------

    @staticmethod
    def compare(got: np.ndarray, want: np.ndarray, scale: np.ndarray) -> Dict[str, float]:
        """The number compared, ``rmse_ratio``: the root-mean-square gap in u8
        levels of ``got`` to the fp32 reference ``want``, over every channel
        of every pixel, divided by that of ``scale``, the reference with its
        conv operands rounded to bf16.  The ratio takes out how strongly the
        seeded network amplifies rounding, which moves both gaps alike from
        seed to seed; ``rmse_u8`` and ``max_abs_u8`` go to the log."""
        def rmse(a):
            d = a.astype(np.float64) - want.astype(np.float64)
            return float(np.sqrt(np.mean(d ** 2)))

        if got is None or got.shape != want.shape:
            return {"rmse_ratio": float("inf"), "rmse_u8": float("inf"), "max_abs_u8": 255.0}
        gap = rmse(got)
        return {"rmse_ratio": gap / max(rmse(scale), 1e-9), "rmse_u8": gap,
                "max_abs_u8": float(np.abs(got.astype(np.int16) - want.astype(np.int16)).max())}

    def reference_outputs(self, items, precision: str = "fp32"):
        """The reference's u8 RGB output for each (input u8 RGB, mode), on
        the weights of the run's checkpoint file."""
        state = {k: v.to(self.device) for k, v in torch.load(self.ckpt).items()}
        try:
            return [self.cell.ref.infer(state, rgb, model=self.cell.model,
                                        session=self.cell.session, mode=mode,
                                        precision=precision) for rgb, mode in items]
        finally:
            del state
            self._free()

    def _free(self):
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def budget(self) -> Optional[int]:
        if self.device.type != "cuda":
            return None
        return torch.cuda.get_device_properties(self.device).total_memory // 2

    # -- the run -----------------------------------------------------------------

    def run(self) -> dict:
        try:
            return self._run()
        finally:
            shutil.rmtree(self.work, ignore_errors=True)

    def _run(self) -> dict:
        from innfer_tpu_torch.observability import StageTimers
        from innfer_tpu_torch.ops import _build

        cell, mix, log = self.cell, self.cell.traffic, self.log
        io0 = io_counters()
        t = time.perf_counter()
        in_dir = osp.join(self.work, "in")
        if mix["kind"] == "frames":
            frames_rgb = T.make_frames(mix, self.seed, self.device)
            frames_bgr = np.ascontiguousarray(frames_rgb[..., ::-1])
        else:
            imgs = T.write_dir(mix, self.seed, in_dir, self.device)
            sizes = {k: v.shape[:2] for k, v in imgs.items()}
            warm_dir = osp.join(self.work, "warm")
            os.makedirs(warm_dir)
            for name in T.warm_names(mix, self.seed):
                src, dst = osp.join(in_dir, name + ".png"), osp.join(warm_dir, name + ".png")
                try:
                    os.link(src, dst)
                except OSError:
                    shutil.copy(src, dst)
        self.made["images"] = time.perf_counter() - t
        log(f"[inputs] {self.made['images']:.3f} s making the inputs")

        ckpt = self.checkpoint()
        phases = {}
        t = time.perf_counter()
        sess, batch = self._session(ckpt)
        phases["session"] = time.perf_counter() - t
        if mix["kind"] == "frames":
            for i in range(2):
                t = time.perf_counter()
                sess.run_image(frames_bgr[i % len(frames_bgr)])
                phases[f"warm{i}"] = time.perf_counter() - t
        else:
            t = time.perf_counter()
            sess.process(warm_dir, osp.join(self.work, "warm_out"), verbose=False, batch=batch)
            shutil.rmtree(osp.join(self.work, "warm_out"), ignore_errors=True)
            phases["warm"] = time.perf_counter() - t
        self._sync()
        setup_s = time.perf_counter() - self.t0 - sum(self.made.values())
        compile_s = sum(b.seconds for b in _build._built.values())
        log(f"[setup] setup_s {setup_s:.4f}; compile {compile_s:.3f} s in this process "
            f"(libraries {sorted(_build._built)}); the program's phases "
            + ", ".join(f"{k} {v:.3f} s" for k, v in phases.items())
            + "; left out, the harness's making: "
            + ", ".join(f"{k} {v:.3f} s" for k, v in self.made.items()))
        log(f"[card] before the window: {smi('name,power.limit,clocks.sm,power.draw,temperature.gpu')}")

        counters = launch_counters(cell.config)
        for f in counters.values():
            f.launches = 0
        if self.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(self.device)
        timers = StageTimers() if self.traced else None
        prof_ctx = trace.profile() if self.traced else _null_profile()
        if mix["kind"] == "frames":
            win = self._frames(sess, frames_bgr, prof_ctx)
        else:
            win = self._dir(sess, batch, in_dir, sizes, prof_ctx, timers)
        self._sync()
        peak = torch.cuda.max_memory_allocated(self.device) if self.device.type == "cuda" else 0
        log(f"[card] after the window: {smi('name,power.limit,clocks.sm,power.draw,temperature.gpu')}")
        launches = {k: f.launches for k, f in counters.items()}
        n_img = max(len(win.images), 1)
        log(f"[window] {win.wall_s:.3f} s, {win.attempted} attempted, {win.failed} failed, "
            f"{win.passes} passes {[round(s, 3) for s in win.pass_s]}; kernel launches per image "
            + ", ".join(f"{k} {v / n_img:g}" for k, v in launches.items()))
        if timers is not None and mix["kind"] == "dir":
            win.timers = timers.report()
            log(f"[stages] {json.dumps(win.timers)}")

        tr = None
        if self.traced:
            t = time.perf_counter()
            tr = trace.read(self.prof)
            log(f"[trace] read {tr.device_events} device events in "
                f"{time.perf_counter() - t:.2f} s; busy {tr.busy_s:.4f} of {tr.window_s:.4f} s")
        self.prof = None

        metrics = self._metrics(win, tr, setup_s)

        # the program's state goes before the reference runs
        del sess
        self._free()
        checks, extra = self._check(win, imgs if mix["kind"] == "dir" else frames_rgb)
        for k, v in extra.items():
            log(f"[check] {k} {v}")
        io1 = io_counters()
        if io0 and io1:
            log(f"[disk] this run wrote {io1['wchar'] - io0['wchar']} bytes through write calls "
                f"({io1['write_bytes'] - io0['write_bytes']} counted to a block device)")
        correct = (win.failed == 0 and bool(checks)
                   and all(c["value"] <= c["limit"] for c in checks.values()))
        line = {"correct": correct, "attempted": win.attempted, "failed": win.failed,
                "metrics": metrics,
                "device": self._device(peak, tr)}
        if tr is not None:
            line["breakdown"] = tr.breakdown()
        line["checks"] = checks
        return line

    def _device(self, peak: int, tr) -> dict:
        if self.device.type == "cuda":
            d = {"platform": "gpu", "kind": torch.cuda.get_device_name(self.device), "count": 1,
                 "memory_peak_bytes": int(peak)}
        else:
            d = {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
        if tr is not None:
            d["busy_s"], d["window_s"] = tr.busy_s, tr.window_s
        return d

    def _metrics(self, win: Window, tr, setup_s: float) -> dict:
        cell = self.cell
        if not self.traced:
            have = end_to_end(cell.traffic["kind"], win, setup_s)
            out = {}
            for m in cell.end_to_end:
                if m["name"] not in have:
                    raise CellError(f"{cell.name}: no reading of {m['name']}")
                out[m["name"]] = {"value": have[m["name"]], "unit": m["unit"]}
            return out
        kind = torch.cuda.get_device_name(self.device) if self.device.type == "cuda" else "cpu"
        peaks = load_json(osp.join(self.cell.bench_dir, "peaks.json")).get(kind)
        ctx = Context(cell=cell, window=win, trace=tr, peaks=peaks,
                      act_bytes=2 if cell.session["dtype"] == "bf16" else 4)
        out = {}
        for m in cell.per_layer:
            v = cell.readers[m["name"]].read(ctx)
            if v is not None:
                out[m["name"]] = {"value": v, "unit": m["unit"]}
        if peaks:
            self.log(f"[peaks] {kind}: {peaks}; power limit {smi('power.limit')}")
        return out

    def sample_items(self, win: Window, inputs, read_outputs: bool = True):
        """(input u8 RGB, output u8 RGB or None, the mode the reference runs
        it in, label) of each sampled output."""
        mix, ref = self.cell.traffic, self.cell.ref
        on_cuda = self.device.type == "cuda"
        if mix["kind"] == "frames":
            out = []
            for ring_i, got_bgr in win.samples:
                rgb = inputs[ring_i]
                mode = ref.modes(self.cell.model, self.cell.session, [rgb.shape[:2]],
                                 on_cuda=on_cuda, budget=self.budget())[0]
                got = None if got_bgr is None else got_bgr[..., ::-1]
                out.append((rgb, got, mode, f"frame {ring_i}"))
            return out
        names = sorted(inputs)
        shapes = [inputs[n].shape[:2] for n in names]
        modes = dict(zip(names, ref.modes(self.cell.model, self.cell.session, shapes,
                                          on_cuda=on_cuda, budget=self.budget())))
        pick = random.Random(self.seed * 104729 + 3)
        pairs = [(k, n) for k in range(win.passes) for n in names]
        largest = max(h * w for h, w in shapes)
        big = [p for p in pairs if np.prod(inputs[p[1]].shape[:2]) == largest]
        chosen = [pick.choice(big)]
        rest = [p for p in pairs if p != chosen[0]]
        chosen += pick.sample(rest, min(mix["sample"] - 1, len(rest)))
        out = []
        for k, n in chosen:
            got = None
            try:
                if read_outputs:
                    got = png.read(osp.join(self.work, f"out{k}", n + ".png"))
            except (OSError, ValueError) as e:
                self.log(f"[check] pass {k} {n}: {e}")
                got = np.zeros((0, 0, 3), np.uint8)
            out.append((inputs[n], got, modes[n], f"pass {k} {n}"))
        return out

    def _check(self, win: Window, inputs):
        items = self.sample_items(win, inputs)
        pairs = [(rgb, mode) for rgb, _, mode, _ in items]
        want = self.reference_outputs(pairs)
        scale = self.reference_outputs(pairs, precision="bf16")
        per = [self.compare(got, ref, s) for (_, got, _, _), ref, s in zip(items, want, scale)]
        extra = {f"{label} ({mode})": {k: round(v, 6) for k, v in p.items()}
                 for (_, _, mode, label), p in zip(items, per)}
        extra["output_u8_std"] = float(np.mean([got.std() for _, got, _, _ in items
                                                if got is not None and got.size] or [0.0]))
        if self.cell.traffic["kind"] == "dir":
            total = sum(os.path.getsize(osp.join(self.work, f"out{k}", n + ".png"))
                        for k in range(win.passes) for n in inputs
                        if osp.exists(osp.join(self.work, f"out{k}", n + ".png")))
            extra["png_bytes_per_output_px"] = total / max(win.out_px, 1)
        checks = {name: {"value": max((p[name] for p in per), default=float("inf")),
                         "limit": limit} for name, limit in self.cell.limits.items()}
        return checks, extra


class _null_profile:
    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False
