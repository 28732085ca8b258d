"""Device milliseconds a batch of the EM cost pass in the sweep cells: the
program's `gvnmf.em.cost` spans (the W H product and
`_masked_cost_batched`, once an EM iteration) over the profiled batches."""

from gvbench.harness import spans


def read(ctx):
    return spans.device_ms(ctx, ("gvnmf.em.cost",))
