"""The RVAE's Langevin chains' share of their roofline in the sweep cells:
the least time the card could take for the chains' work over the profiled
batches' valid frames (the family's `chain` work: the sweeps, the output
layer and its transpose, the likelihood and update passes; float32 peak
and HBM bandwidth), over the device time of the program's
`gvnmf.rvae.e_chain` and `gvnmf.rvae.wf_chain` spans. It counts the same
work whichever kernels do it."""

from gvbench.harness import spans

CHAINS = ("gvnmf.rvae.e_chain", "gvnmf.rvae.wf_chain")


def read(ctx):
    ms = spans.device_ms(ctx, CHAINS)
    if not ms:
        return None
    return 100.0 * ctx.bound_s("chain") / (ms * ctx.n_batches / 1e3)
