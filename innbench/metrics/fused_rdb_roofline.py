"""``fused_rdb``'s share of its roofline: the five convs of each of the
image's 3 * nb dense blocks at the image's unpadded LR shape (the hybrid
trunk's padding to 64 rows is not counted, so its waste shows), over the
device time of its conv launches (``conv3x3_tma.cuh``'s ``conv_tma``)."""
from innbench.metrics.roofline import share

PATTERNS = ("conv_tma",)


def read(ctx):
    return share(ctx, "fused_rdb", PATTERNS)
