"""Device ms per frame of HAT's channel-attention conv branches: the
program's span ``innfer.cab`` (``models/hat.py``, each hybrid attention
block's CAB from its first conv to the gated residual, 36 a frame).  A
program without the span reads nothing."""
from innbench.metrics.spans import device_ms_per_frame


def read(ctx):
    return device_ms_per_frame(["innfer.cab"])
