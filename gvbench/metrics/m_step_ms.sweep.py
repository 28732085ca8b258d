"""Device milliseconds a batch of the EM M-step in the sweep cells: the
program's `gvnmf.em.m_step` spans (the W update, the 'h' sums, the H
update, the L1 normalisation, the 'g' sums and the gain, once an EM
iteration) over the profiled batches."""

from gvbench.harness import spans


def read(ctx):
    return spans.device_ms(ctx, ("gvnmf.em.m_step",))
