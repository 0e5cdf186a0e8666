"""Per-stage timing, logging and profiling hooks.

The port's counterpart of ``innfer_tpu/observability.py``: stage timers
(host wall clock around the directory loop's sections, optionally
synchronized with the card), the ``innfer_tpu_torch`` logger and a
``torch.profiler`` trace context.

The JAX package's ``enable_compilation_cache`` is not carried: it turns on
XLA's persistent compilation cache, and PyTorch runs eagerly with nothing
to compile per shape.  Its ``device_sync`` (a scalar fetch, for tunneled
TPU platforms where ``block_until_ready`` could return early) is
``torch.cuda.synchronize`` here.
"""
from __future__ import annotations

import contextlib
import logging
import os
import threading
import time
from collections import defaultdict
from typing import Dict, Optional

import torch

logger = logging.getLogger("innfer_tpu_torch")
if not logger.handlers:
    _h = logging.StreamHandler()
    _h.setFormatter(logging.Formatter("%(asctime)s %(name)s %(levelname)s %(message)s"))
    logger.addHandler(_h)
    logger.setLevel(logging.INFO)


class StageTimers:
    """Accumulate wall-clock seconds per named stage; ``report()`` returns
    a dict.  The encode pool's threads time their stages concurrently, so
    the totals are updated under a lock.

    The directory loop's stages (``InferenceSession.process``): ``read``
    waits for a decode, ``image`` and ``batch`` enqueue one image's or one
    group's device work (the host returns before the card finishes unless
    ``sync``), ``fetch`` waits for the pinned u8 copy, which waits for the
    device, and ``encode`` writes the PNG."""

    def __init__(self, sync: bool = False):
        self.sync = sync
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)
        self._lock = threading.Lock()

    @contextlib.contextmanager
    def stage(self, name: str, sync_val: Optional[torch.Tensor] = None):
        """Time the block as ``name``; with ``sync`` and a CUDA
        ``sync_val``, wait for the card before the clock stops."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if self.sync and sync_val is not None and sync_val.is_cuda:
                torch.cuda.synchronize(sync_val.device)
            dt = time.perf_counter() - t0
            with self._lock:
                self.totals[name] += dt
                self.counts[name] += 1

    def report(self) -> Dict[str, Dict[str, float]]:
        with self._lock:
            return {
                name: {
                    "total_s": round(self.totals[name], 4),
                    "count": self.counts[name],
                    "mean_ms": round(1e3 * self.totals[name] / max(self.counts[name], 1), 2),
                }
                for name in self.totals
            }

    def log_report(self) -> None:
        for name, row in sorted(self.report().items()):
            logger.info("stage %-16s total=%7.3fs n=%-4d mean=%8.2fms",
                        name, row["total_s"], row["count"], row["mean_ms"])


TRACE_FILE = "trace.json"


@contextlib.contextmanager
def profile_trace(trace_dir: Optional[str]):
    """``torch.profiler`` over the block (host, and the card where there is
    one), written as a Chrome trace to ``trace_dir/trace.json``; a no-op
    when ``trace_dir`` is falsy."""
    if not trace_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(trace_dir, TRACE_FILE))
