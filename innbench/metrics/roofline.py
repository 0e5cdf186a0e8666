"""The arithmetic of a kernel's share of its roofline, for the
``<kernel>_roofline`` readers: the least time the card could take for the
work the benchmark counts (the larger of the operations at the peak rate of
the computing dtype and the bytes at the memory's peak), over the device
time of the kernel's launches in the traced window."""
from __future__ import annotations


def share(ctx, kernel: str, patterns) -> "float | None":
    if ctx.trace is None or not ctx.peaks:
        return None
    seconds = ctx.trace.kernel_seconds(patterns)
    flops, nbytes = ctx.kernel_work(kernel)
    if seconds <= 0 or flops <= 0:
        return None
    rate = ctx.peaks["bf16_flops"] if ctx.act_bytes == 2 else ctx.peaks["fp32_flops"]
    bound = max(flops / rate, nbytes / ctx.peaks["hbm_bytes_per_s"])
    return 100.0 * bound / seconds
