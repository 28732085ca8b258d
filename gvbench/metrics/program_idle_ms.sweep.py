"""Milliseconds a batch in which the card was idle while the program's
host code ran, in the sweep cells: the gaps between the profiled window's
device intervals (kernels, copies, fills) intersected with the union of
the host `gvnmf.*` spans of the same trace, over the profiled batches.
The rest of the idle time is the caller's (the fetch of the outputs, the
next batch's set-up)."""

from gvbench.harness import spans


def read(ctx):
    if spans.records(ctx) is None:
        return None
    idle = spans.gaps((a, b) for _, a, b in ctx.profile.dev)
    prog = spans.merged((a, b) for n, a, b in ctx.profile.host
                        if n.startswith(spans.PREFIX))
    if not prog:
        return None
    return spans.overlap(idle, prog) / 1e3 / ctx.n_batches
