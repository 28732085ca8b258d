"""Device microseconds an ordered timestep of the RVAE's Langevin chains
in the sweep cells: the program's `gvnmf.rvae.e_chain` and
`gvnmf.rvae.wf_chain` spans' device time over their `timesteps` counts
(the timesteps their sweeps run in order: steps x N x 2) over the
profiled batches. The recurrence's latency, which a change to the sweep
kernels moves."""

from gvbench.harness import spans

CHAINS = ("gvnmf.rvae.e_chain", "gvnmf.rvae.wf_chain")


def read(ctx):
    recs = spans.records(ctx)
    if recs is None:
        return None
    chains = [r for r in recs if r["name"] in CHAINS]
    if not chains or any(r["device_ms"] is None for r in chains):
        return None
    steps = sum(r["counts"].get("timesteps", 0) for r in chains)
    if not steps:
        return None
    return 1e3 * sum(r["device_ms"] for r in chains) / steps
