"""The whole step's share of the card's peak: the published architecture's
operations for every frame finished in the window (``flops/<arch>.py``),
over the window's wall time at the peak rate of the computing dtype."""


def read(ctx):
    if not ctx.peaks or ctx.window.wall_s <= 0:
        return None
    rate = ctx.peaks["bf16_flops"] if ctx.act_bytes == 2 else ctx.peaks["fp32_flops"]
    flops = ctx.step_flops()
    return 100.0 * flops / (ctx.window.wall_s * rate) if flops else None
