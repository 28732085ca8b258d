"""K2's share of its roofline in the sweep cells: the least time for the
M-step sums' work over the profiled batches' valid frames
(`bounds.sums_work`), over the device time of the sums kernels."""

PATTERNS = ("nmf_sums",)


def read(ctx):
    if ctx.profile is None or not ctx.n_batches:
        return None
    t = ctx.kernel_s(PATTERNS)
    return 100.0 * ctx.bound_s("k2") / t if t > 0 else None
