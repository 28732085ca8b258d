"""K1's share of its roofline in the serve cells: the least time the card
could take for the MH chains' work over the profiled batches' valid frames
(`bounds.chain_work`, float32 peak and HBM bandwidth), over the device time
of the chain kernels."""

PATTERNS = ("mh_chain", "sum_tiles_kernel", "philox_streams")


def read(ctx):
    if ctx.profile is None or not ctx.n_batches:
        return None
    t = ctx.kernel_s(PATTERNS)
    return 100.0 * ctx.bound_s("k1") / t if t > 0 else None
