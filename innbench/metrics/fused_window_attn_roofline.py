"""``window_attn``'s share of its roofline: the image's 36 SwinIR layers'
attention at its unpadded LR shape (the canvas's padding to a multiple of
the window and the heads' padding to 32 channels are not counted, so their
waste shows), over the device time of the kernel's launches
(``window_attn.cu``'s ``winattn_fwd``)."""
from innbench.metrics.roofline import share

PATTERNS = ("winattn_",)


def read(ctx):
    return share(ctx, "window_attn", PATTERNS)
