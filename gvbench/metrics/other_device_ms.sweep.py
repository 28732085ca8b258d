"""Device milliseconds a batch outside K1 and K2 in the sweep cells: the
profiled window's kernels, copies and fills other than the chain and sums
kernels (STFT, classifier, encoder, W / H / g updates, cost, ISTFT), over
the profiled batches."""

K1_K2 = ("mh_chain", "sum_tiles_kernel", "philox_streams", "nmf_sums")


def read(ctx):
    if ctx.profile is None or not ctx.n_batches:
        return None
    other = ctx.profile.total_seconds() - ctx.kernel_s(K1_K2)
    return 1e3 * other / ctx.n_batches
