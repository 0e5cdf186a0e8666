"""The traced run's reading of the profiler: the window, the device's busy
time (the union of its operations' intervals), time by kernel name, and the
idle gaps named by what the host's calling thread was doing in them."""
from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import torch

WINDOW = "innbench.window"
# the harness's spans around its calls into the program
SPANS = (WINDOW, "innbench.run_image", "innbench.process")
TOP = 10
# a breakdown names a kernel by this many characters at most
NAME_CHARS = 160


def busy(intervals: Iterable[Tuple[float, float]]) -> float:
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


def gaps(intervals: Sequence[Tuple[float, float]], lo: float, hi: float) -> List[Tuple[float, float]]:
    """The parts of [lo, hi] that no interval covers."""
    out, t = [], lo
    for a, b in sorted(intervals):
        if a > t:
            out.append((t, min(a, hi)))
        t = max(t, b)
        if t >= hi:
            break
    if t < hi:
        out.append((t, hi))
    return [(a, b) for a, b in out if b > a]


def innermost(ops: Sequence[Tuple[float, float, str]], points: Sequence[float]) -> List[Optional[str]]:
    """For each time in ``points`` (sorted), the name of the shortest op of
    one thread's properly nested ``ops`` (start, end, name) that holds it."""
    ops = sorted(ops, key=lambda o: (o[0], -o[1]))
    out, stack, i = [], [], 0
    for p in points:
        while i < len(ops) and ops[i][0] <= p:
            while stack and stack[-1][1] < ops[i][0]:
                stack.pop()
            stack.append(ops[i])
            i += 1
        while stack and stack[-1][1] < p:
            stack.pop()
        out.append(stack[-1][2] if stack else None)
    return out


@dataclass
class Trace:
    window_s: float
    busy_s: float
    by_kernel: Dict[str, float]
    idle_by_host_op: Dict[str, float]
    device_events: int

    def kernel_seconds(self, patterns: Sequence[str]) -> float:
        return sum(t for name, t in self.by_kernel.items() if any(p in name for p in patterns))

    def breakdown(self) -> dict:
        def top(d):
            return [[k[:NAME_CHARS], v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]

        return {"device_ops": top(self.by_kernel), "idle_gaps": top(self.idle_by_host_op)}


def profile():
    from torch.profiler import ProfilerActivity
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=acts)


def read(prof) -> Trace:
    """Reduce a finished profile whose window is the ``WINDOW`` span."""
    events = prof.profiler.kineto_results.events()
    win = [e for e in events if e.name() == WINDOW]
    if not win:
        raise RuntimeError(f"the trace has no {WINDOW} span")
    w = win[0]
    lo, hi, tid = w.start_ns(), w.end_ns(), w.start_thread_id()
    dev, host = [], []
    by_kernel: Dict[str, float] = defaultdict(float)
    for e in events:
        a, b = e.start_ns(), e.end_ns()
        if b <= lo or a >= hi:
            continue
        if e.device_type() != torch.autograd.DeviceType.CPU:
            if e.is_user_annotation() or e.name() in SPANS:
                continue  # a host span mirrored on the device's timeline, not an operation
            a, b = max(a, lo), min(b, hi)
            dev.append((a, b))
            by_kernel[e.name()] += (b - a) / 1e9
        elif e.start_thread_id() == tid and e.name() != WINDOW:
            host.append((a, b, e.name()))
    idle = gaps(dev, lo, hi)
    labels = innermost(host, [(a + b) / 2 for a, b in idle])
    idle_by: Dict[str, float] = defaultdict(float)
    for (a, b), name in zip(idle, labels):
        idle_by[name or "(no host op)"] += (b - a) / 1e9
    return Trace(window_s=(hi - lo) / 1e9, busy_s=busy(dev) / 1e9, by_kernel=dict(by_kernel),
                 idle_by_host_op=dict(idle_by), device_events=len(dev))
