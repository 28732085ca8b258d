"""Device milliseconds a batch of the back end in the sweep cells: the
program's `gvnmf.back` spans (the Wiener products, both masked ISTFTs,
the finite flags, PCM16 and the packed labels) over the profiled
batches."""

from gvbench.harness import spans


def read(ctx):
    return spans.device_ms(ctx, ("gvnmf.back",))
