"""The share of SwinIR's layers whose window attention ran on the
hand-written kernel: the program's counters ``window_attns_fused`` over
``window_attns`` (``models/swinir.py``); 1 where every layer's attention
read the qkv projection in place on the kernel."""
from innbench.metrics.spans import counter_ratio


def read(ctx):
    return counter_ratio("window_attns_fused", "window_attns")
