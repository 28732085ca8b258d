"""Rows a served request shared its device batch with, itself included:
the mean of the service's per-request `batch_size` over the requests due in
the window that were served."""


def read(ctx):
    sizes = (ctx.requests or {}).get("batch_sizes") or []
    return sum(sizes) / len(sizes) if sizes else None
