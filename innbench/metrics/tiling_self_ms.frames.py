"""Device self ms of the tiling engine per frame: the program's span
``innfer.tiling`` less its trunk and tile groups, i.e. the engine's own
pad, cut, cast, recompose and crop."""
from innbench.metrics.spans import device_ms_per_frame


def read(ctx):
    return device_ms_per_frame(["innfer.tiling"], key="device_self_ms")
