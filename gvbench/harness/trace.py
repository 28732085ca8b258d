"""The traced run's profile: `torch.profiler` over a steady sub-window,
reduced to device busy time, device time by kernel name, and the longest
idle gaps with what the host was doing meanwhile.

Busy time is the length of the union of the card's kernel, copy and fill
intervals (`ops.profiling._union_us` / `device_time_ms`'s arithmetic,
frozen here): kernels on concurrent streams overlap, and a sum would count
the overlap twice.
"""

import json
import os
import tempfile
from collections import defaultdict

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATEGORIES = ("cpu_op", "user_annotation", "python_function",
                   "cuda_runtime")


def union_length(intervals):
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, None
    for a, b in sorted(intervals):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


def warm_profiler(device):
    """Start and stop the profiler once around a small kernel: its first
    start initialises the tracing library (seconds), which belongs to
    set-up and not to the profiled sub-window."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        (torch.ones(8, device=device) * 2).sum().item()


def events(prof):
    """(device events, host events) of a stopped profiler, each a list of
    (name, start_us, end_us)."""
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            raw = json.load(f)["traceEvents"]
    dev, host = [], []
    for e in raw:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        item = (e.get("name", "?"), float(e["ts"]),
                float(e["ts"]) + float(e["dur"]))
        if e.get("cat") in DEVICE_CATEGORIES:
            dev.append(item)
        elif e.get("cat") in HOST_CATEGORIES:
            host.append(item)
    return dev, host


class Profile:
    """The reduction of one profiled sub-window."""

    def __init__(self, dev, host, window_s, batches):
        self.dev = dev
        self.window_s = window_s
        self.batches = batches
        self.busy_s = union_length((a, b) for _, a, b in dev) / 1e6
        self.host = host

    def seconds(self, patterns):
        """Device seconds of the events whose name holds any pattern."""
        return sum(b - a for n, a, b in self.dev
                   if any(p in n for p in patterns)) / 1e6

    def total_seconds(self):
        return sum(b - a for _, a, b in self.dev) / 1e6

    def top_ops(self, k=10):
        agg = defaultdict(float)
        for n, a, b in self.dev:
            agg[n] += (b - a) / 1e6
        return sorted(([n, s] for n, s in agg.items()),
                      key=lambda t: -t[1])[:k]

    def idle_gaps(self, k=10):
        """The k longest gaps between device events, each named by the
        shortest host event that covers its middle."""
        spans = sorted((a, b) for _, a, b in self.dev)
        gaps, end = [], None
        for a, b in spans:
            if end is not None and a > end:
                gaps.append((end, a))
            end = b if end is None else max(end, b)
        gaps.sort(key=lambda g: g[0] - g[1])
        out = []
        for a, b in gaps[:k]:
            mid = 0.5 * (a + b)
            cover = [(e - s, n) for n, s, e in self.host if s <= mid <= e]
            out.append([min(cover)[1] if cover else "host",
                        (b - a) / 1e6])
        return out
