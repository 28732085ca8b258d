"""What decides `correct`: the cell's family (`families/<name>.py`) reads
its numbers for the armed batch against its plain reference, and each is
held to its limit in `limits/<cell>.json`. The gap measures here are the
ones the families share."""

import torch


def frame_gap(a, b, valid):
    """Largest |a - b| in a frame over the frame's largest |b|, over the
    valid frames; a, b (B, N, ...) with `valid` (B, N)."""
    a, b = a.double(), b.double()
    d = torch.abs(a - b).flatten(2).amax(-1)
    s = torch.abs(b).flatten(2).amax(-1)
    r = d / torch.clamp_min(s, 1e-300)
    return float(r[valid].max()) if bool(valid.any()) else 0.0


def worst_frame(a, b, valid):
    """(row, frame, largest |a - b|, largest |b|) of the frame that sets
    `frame_gap` (a diagnostic printed beside the readings)."""
    a, b = a.double(), b.double()
    d = torch.abs(a - b).flatten(2).amax(-1)
    s = torch.abs(b).flatten(2).amax(-1)
    r = torch.where(valid, d / torch.clamp_min(s, 1e-300), -1.0)
    i = int(torch.argmax(r))
    bi, ni = divmod(i, r.shape[1])
    return [bi, ni, float(d[bi, ni]), float(s[bi, ni])]


def row_gap(a, b):
    """Largest |a - b| of an utterance over its largest |b|."""
    a, b = a.double(), b.double()
    d = torch.abs(a - b).flatten(1).amax(-1)
    s = torch.abs(b).flatten(1).amax(-1)
    return float((d / torch.clamp_min(s, 1e-300)).max())


def verdict(nums, limits, err):
    """(correct, [(name, value, limit)]): every number at or under its
    limit, and every limit's number present."""
    rows = [(k, nums.get(k), limits[k]) for k in limits]
    ok = err is None and all(v is not None and v <= lim
                             for _, v, lim in rows)
    return ok, rows
