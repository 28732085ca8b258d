"""The share of the profiled batches' frames that are valid in the sweep
cells: the program's `valid_frames` counts over `rows` times `n_pad` on
its `gvnmf.batch` spans (the rest is the padding to each batch's bucket,
which every stage computes on)."""

from gvbench.harness import spans


def read(ctx):
    recs = spans.records(ctx)
    if recs is None:
        return None
    batch = [r["counts"] for r in recs if r["name"] == spans.BATCH]
    total = sum(c["rows"] * c["n_pad"] for c in batch)
    return 100.0 * sum(c["valid_frames"] for c in batch) / total
