"""Device ms of the whole-image LR trunk per frame: the program's span
``innfer.trunk`` (``tiling/engine.hybrid_apply``, around the 69
``fused_rdb`` calls)."""
from innbench.metrics.spans import device_ms_per_frame


def read(ctx):
    return device_ms_per_frame(["innfer.trunk"])
