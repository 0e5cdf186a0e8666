"""``fused_resnet_block``'s share of its roofline: the n_blocks blocks'
two 3x3 convs at the whole image's quarter-resolution shape, counted once
(tile overlap and padding are not counted, so their waste shows), over the
device time of its launches: the convs (``conv3x3_tc.cuh``'s
``conv_wgmma``) and its instance-norm kernels (``resnet_block.cu``)."""
from innbench.metrics.roofline import share

PATTERNS = ("conv_wgmma", "in_merge", "in_stats", "in_apply")


def read(ctx):
    return share(ctx, "fused_resnet_block", PATTERNS)
