"""The program's own spans over the profiled batches: the records of
`guided_vae_nmf_torch.ops.profiling.span_records()`, which the program
makes only while a profiler records, so in a traced run they are the
profiled sub-window's. A program without that registry, or a registry
that does not hold exactly one `gvnmf.batch` span per profiled batch,
gives no reading (None), and the metrics that read it are left out of the
line.

Span names (the program's): `gvnmf.batch` (one entry call, counts `rows`,
`n_pad`, `valid_frames`), under it `gvnmf.front`, `gvnmf.labels`,
`gvnmf.engine` and `gvnmf.back`; under `gvnmf.engine`
`gvnmf.engine.init`, `gvnmf.em.e_chain`, `gvnmf.em.m_step` and
`gvnmf.em.cost` (one each an EM iteration) and `gvnmf.wf_chain`."""

BATCH = "gvnmf.batch"
PREFIX = "gvnmf."


def records(ctx):
    """The span records of the profiled batches, or None."""
    if getattr(ctx, "profile", None) is None or not getattr(
            ctx, "n_batches", 0):
        return None
    try:
        from guided_vae_nmf_torch.ops.profiling import span_records
    except ImportError:
        return None
    recs = span_records()
    if sum(r["name"] == BATCH for r in recs) != ctx.n_batches:
        return None
    return recs


def device_ms(ctx, names):
    """Device milliseconds a profiled batch of the spans named `names`
    (the time on the stream between each span's entry and exit events),
    or None."""
    recs = records(ctx)
    if recs is None:
        return None
    vals = [r["device_ms"] for r in recs if r["name"] in names]
    if not vals or any(v is None for v in vals):
        return None
    return sum(vals) / ctx.n_batches


def merged(intervals):
    """The union of (start, end) intervals as sorted disjoint intervals."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def gaps(intervals):
    """The gaps between the union's intervals, first to last."""
    u = merged(intervals)
    return [(u[i][1], u[i + 1][0]) for i in range(len(u) - 1)]


def overlap(xs, ys):
    """Length of the intersection of two lists of sorted disjoint
    intervals."""
    total, i, j = 0.0, 0, 0
    while i < len(xs) and j < len(ys):
        a = max(xs[i][0], ys[j][0])
        b = min(xs[i][1], ys[j][1])
        if b > a:
            total += b - a
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return total
