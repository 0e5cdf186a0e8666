"""Host ms the program takes to issue a frame, per frame: its span
``innfer.frame`` (``InferenceSession.run_image``) less the host's wait for
the output copy (``innfer.fetch``)."""
from innbench.metrics.spans import enqueue_ms_per_frame


def read(ctx):
    return enqueue_ms_per_frame()
