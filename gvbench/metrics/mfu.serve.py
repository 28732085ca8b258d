"""The whole step's share of the card's float32 peak in the serve cells:
the operations the profiled batches' valid frames need
(`bounds.batch_work`: chains, sums, encoder, classifier, FFTs, SPP
updates) over the profiled window's seconds times 67 TFLOP/s."""


def read(ctx):
    if ctx.profile is None or not ctx.n_batches or ctx.window_s <= 0:
        return None
    return 100.0 * ctx.flops / (ctx.window_s * ctx.peak_flops)
