"""``fused_dilated_block``'s share of its roofline: the image's 84 PPON
blocks at its unpadded LR shape (the hybrid trunk's padding to 64 rows is
not counted, so its waste shows), over the device time of the block's
launches (``dilated_block.cu``'s three kernels ``dilated_block_c1``,
``dilated_block_rates`` and ``dilated_block_fuse``)."""
from innbench.metrics.roofline import share

PATTERNS = ("dilated_block_",)


def read(ctx):
    return share(ctx, "fused_dilated_block", PATTERNS)
