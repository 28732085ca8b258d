"""The RVAE decoder's sweep kernels' share of their roofline in the sweep
cells: the least time for the recurrent work (forward and backward sweeps,
both directions, over the profiled batches' valid frames: the family's
`lstm_sweep` work) over the device time of the kernels found by name."""

PATTERNS = ("lstm_sweep_fwd_kernel", "lstm_sweep_bwd_kernel")


def read(ctx):
    if ctx.profile is None or not ctx.n_batches:
        return None
    t = ctx.kernel_s(PATTERNS)
    return 100.0 * ctx.bound_s("lstm_sweep") / t if t > 0 else None
