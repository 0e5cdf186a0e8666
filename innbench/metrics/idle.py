"""The arithmetic of the ``device_idle_pct.*`` readers: the share of the
traced window in which no operation ran on the card (one less the union of
the device's operation intervals over the window)."""
from __future__ import annotations


def idle_pct(ctx) -> "float | None":
    if ctx.trace is None or ctx.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)
