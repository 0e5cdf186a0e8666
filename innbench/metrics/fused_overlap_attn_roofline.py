"""``overlap_attn``'s share of its roofline: the image's 6 overlapping
cross-attentions at their unpadded LR shape, over the device time of the
kernel's launches (``hat_attn.cu``'s ``hatattn_oca``).  Operations and bytes
only: the 1.79 G exponentials a call (about 0.48 ms at the SFU's rate
against a 0.22 ms byte bound) are not in the bound, so the share caps near
45%.  A program without the kernel reads nothing."""
from innbench.metrics.roofline import share

PATTERNS = ("hatattn_oca",)


def read(ctx):
    return share(ctx, "overlap_attn", PATTERNS)
