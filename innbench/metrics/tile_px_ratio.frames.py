"""The tile grid's pixels over the image pixels they cover: the program's
counters ``tile_px`` and ``tiled_px`` (``tiling/engine``); above 1 by the
overlap and padding computed for nothing."""
from innbench.metrics.spans import counter_ratio


def read(ctx):
    return counter_ratio("tile_px", "tiled_px")
