"""Device milliseconds a batch of the front end in the sweep cells: the
program's `gvnmf.front` (PCM and mask to the device, STFT, power),
`gvnmf.labels` (the classifier) and `gvnmf.engine.init` (transposes,
encoder, first decode, NMF init, weight packing, the chain seeds and their
fetch) spans over the profiled batches."""

from gvbench.harness import spans


def read(ctx):
    return spans.device_ms(ctx, ("gvnmf.front", "gvnmf.labels",
                                 "gvnmf.engine.init"))
