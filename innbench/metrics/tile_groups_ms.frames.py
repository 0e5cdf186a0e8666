"""Device ms of the tile groups' model forwards per frame: the program's
spans ``innfer.tile_group`` (``tiling/engine._run_groups``; ESRGAN's x4
tail, CycleGAN's whole network)."""
from innbench.metrics.spans import device_ms_per_frame


def read(ctx):
    return device_ms_per_frame(["innfer.tile_group"])
