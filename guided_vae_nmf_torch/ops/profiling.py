"""Tracing and profiling hooks.

Counterpart of `guided_vae_nmf_tpu/ops/profiling.py`:

  * :class:`StageTimer`: accumulating named stage timers with a report,
    used by `pipeline.enhance_files` (a copy, same report format);
  * :func:`profile_trace`: a context manager around `torch.profiler`
    (host ops, and the card's kernels and copies when there is one)
    writing a Chrome / TensorBoard trace under a directory;
  * :func:`device_time_ms`: one call of a function under the profiler,
    reduced to its device time and a table by kernel name.
"""

import time
from collections import defaultdict
from contextlib import contextmanager

import torch


class StageTimer:
    """Accumulate wall-clock per named stage; thread-unsafe by design (use
    one per driver)."""

    def __init__(self):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)

    @contextmanager
    def stage(self, name):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def report(self):
        lines = ["{:<24} {:>10} {:>8}".format("STAGE", "TOTAL(s)", "CALLS")]
        for name in sorted(self.totals, key=self.totals.get, reverse=True):
            lines.append("{:<24} {:>10.3f} {:>8}".format(
                name, self.totals[name], self.counts[name]))
        return "\n".join(lines)


_GLOBAL = StageTimer()


def stage(name):
    """Module-level convenience: `with stage('mcem'):` on the shared
    timer."""
    return _GLOBAL.stage(name)


def _activities():
    from torch.profiler import ProfilerActivity

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    return acts


@contextmanager
def profile_trace(log_dir):
    """Profile the body with `torch.profiler` (host ops, and the card's
    kernels and copies when CUDA is available) and write its Chrome trace,
    `<host>_<pid>.<time>.pt.trace.json`, under `log_dir` on exit (view it
    in TensorBoard's profiler plugin, Perfetto or chrome://tracing).
    Yields the profiler."""
    from torch.profiler import profile, tensorboard_trace_handler

    with profile(activities=_activities(),
                 on_trace_ready=tensorboard_trace_handler(log_dir)) as prof:
        yield prof


# Trace categories of the work the card does: kernels, and copies and
# fills that the copy engines or the SMs run.
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


def _sync():
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def _union_us(intervals):
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


def device_time_ms(fn, top=0):
    """Call `fn()` once to warm it up, then once under `torch.profiler`;
    return (total_device_ms, [(ms, count, name), ...]).

    The total is the length of the union of the card's kernel, copy and
    fill intervals: kernels on concurrent streams overlap, and a sum would
    count the overlap twice. The table sums each name's intervals, largest
    first; `top` > 0 prints that many rows. Raises RuntimeError when the
    trace holds no device event (no card, or nothing ran on it)."""
    import json
    import os
    import tempfile

    from torch.profiler import profile

    fn()
    _sync()
    with profile(activities=_activities()) as prof:
        fn()
        _sync()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    dev = [e for e in events if e.get("ph") == "X"
           and e.get("cat") in DEVICE_CATEGORIES]
    if not dev:
        raise RuntimeError("the profiler saw no device event: is a CUDA "
                           "device attached, and does fn run on it?")
    agg, cnt = defaultdict(float), defaultdict(int)
    for e in dev:
        agg[e["name"]] += e["dur"]
        cnt[e["name"]] += 1
    table = sorted(((us / 1e3, cnt[n], n) for n, us in agg.items()),
                   reverse=True)
    total = _union_us((e["ts"], e["ts"] + e["dur"]) for e in dev) / 1e3
    for ms, c, n in table[:top]:
        print(f"{ms:9.2f} ms x{c:5d}  {n[:100]}")
    return total, table
