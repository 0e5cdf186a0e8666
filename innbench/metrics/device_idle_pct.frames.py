"""The card's idle share over the traced window of the frame cells."""
from innbench.metrics.idle import idle_pct


def read(ctx):
    return idle_pct(ctx)
