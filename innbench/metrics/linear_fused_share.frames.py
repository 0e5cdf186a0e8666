"""The share of SwinIR's token linears with an epilogue (each layer's proj
and fc2 with the residual add, fc1 with GELU) that ran on the hand-written
token GEMM: the program's counters ``swin_linears_fused`` over
``swin_linears`` (``models/swinir.py``); 1 where every one of every frame
did.  A program without the counters reads nothing."""
from innbench.metrics.spans import counter_ratio


def read(ctx):
    return counter_ratio("swin_linears_fused", "swin_linears")
