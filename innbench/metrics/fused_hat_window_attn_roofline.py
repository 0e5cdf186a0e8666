"""``hat_window_attn``'s share of its roofline: the image's 36 hybrid
attention blocks' window attention at its unpadded LR shape (the canvas's
padding to a multiple of the window and the heads' padding to 32 channels
are not counted, so their waste shows), over the device time of the
kernel's launches (``hat_attn.cu``'s ``hatattn_sa``).  A program without
the kernel reads nothing."""
from innbench.metrics.roofline import share

PATTERNS = ("hatattn_sa",)


def read(ctx):
    return share(ctx, "hat_window_attn", PATTERNS)
