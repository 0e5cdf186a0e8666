"""Device ms of a frame's input and output per frame: the program's spans
``innfer.upload`` (host prep, the u8 upload, the float cast),
``innfer.postprocess`` (rounding to u8 on the card) and ``innfer.download``
(the copy into pinned host memory)."""
from innbench.metrics.spans import device_ms_per_frame


def read(ctx):
    return device_ms_per_frame(["innfer.upload", "innfer.postprocess", "innfer.download"])
