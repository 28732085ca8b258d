"""Tracing and profiling hooks.

Counterpart of `guided_vae_nmf_tpu/ops/profiling.py`:

  * :class:`StageTimer`: accumulating named stage timers with a report,
    used by `pipeline.enhance_files` (a copy, same report format); each
    stage is also a :func:`span`;
  * :func:`span`: a named span of the program's work, recorded only while
    a `torch.profiler` records in the process: then it is a
    `record_function` range in the trace (a `user_annotation` on the host,
    a `gpu_user_annotation` on the card) and a record in an in-memory
    registry, with CUDA events around it on a card and integer counts;
    :func:`span_records` resolves the registry into each span's device
    milliseconds and self time, :func:`reset_spans` empties it;
  * :func:`profile_trace`: a context manager around `torch.profiler`
    (host ops, and the card's kernels and copies when there is one)
    writing a Chrome / TensorBoard trace under a directory;
  * :func:`device_time_ms`: one call of a function under the profiler,
    reduced to its device time and a table by kernel name.
"""

import itertools
import threading
import time
from collections import defaultdict, deque
from contextlib import contextmanager, nullcontext

import torch
from torch.autograd import profiler as _autograd_profiler


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
            with span(name):
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


# -- spans ------------------------------------------------------------------

# the span of one batch: the spans under it carry its sequence number
BATCH_SPAN = "gvnmf.batch"

_OFF = nullcontext()
_enabled_here = torch._C._autograd._profiler_enabled
_ids = itertools.count()
_batch_ids = itertools.count()
_open = threading.local()      # each thread's stack of (id, batch, device)
_lock = threading.Lock()       # guards the registry and the event pools
# A span must leave no new object for the garbage collector to track:
# a few thousand of them (a tuple a record, an event a span) set off
# collections, and a full one stalls the host for a tenth of a second in
# the middle of a batch. So the closed spans are laid flat in one list of
# plain values, RECORD_FIELDS each in closing order: (id, name, parent,
# batch, thread, t0, t1, counts, device, start, end), where start / end
# index the device's event pool until read, then hold (device ms, None);
# and the events of finished spans are read and reused as the pool runs
# dry, so it holds about the spans the host runs ahead of the card. A few
# at a time: reading a whole batch's at once (some hundreds, 2-3 ms) is
# host time the card waits for when the host has just synchronised.
RECORD_FIELDS = 11
READ_AT_ONCE = 16
_records = []
_unread = deque()  # offsets in _records with unread events
_events = {}                   # device index -> every timing event made
_free = {}                     # device index -> pool indices free to reuse


def profiler_on():
    """Whether a `torch.profiler` records anywhere in the process (the
    profiler's own flag is per thread, and its host events are of the
    thread that started it; a span in another thread is still recorded
    in the registry)."""
    return (getattr(_autograd_profiler, "_is_profiler_enabled", False)
            or _enabled_here())


def span(name, device=None, **counts):
    """Context manager around a named part of the program's work.

    With no profiler recording (:func:`profiler_on` false) it is a shared
    no-op: nothing but that check runs. While one records it enters
    `torch.profiler.record_function(name)` and, on exit, adds a record to
    the registry: its name, the enclosing span of the thread, the batch
    (the sequence number of the enclosing `gvnmf.batch` span), the
    thread, the host start and end (`time.perf_counter`) and `counts`.
    On a CUDA `device` (default: the enclosing span's) it also records a
    timing event on the device's current stream at entry and at exit;
    nothing synchronises them until :func:`span_records`. A count is an
    int, a tensor (a device sum stays on the device until then) or a
    callable of no argument, called at entry, for a count that costs
    something to take."""
    if not profiler_on():
        return _OFF
    return _Span(name, device, counts)


def _record_event(dev):
    """Record a pooled timing event on `dev`'s current stream; returns its
    index in the pool."""
    with _lock:
        free = _free.setdefault(dev, [])
        if not free:
            _read_finished()
        if free:
            i = free.pop()
        else:
            pool = _events.setdefault(dev, [])
            i = len(pool)
            pool.append(torch.cuda.Event(enable_timing=True))
        ev = _events[dev][i]
    ev.record(torch.cuda.current_stream(dev))
    return i


class _Span:
    __slots__ = ("name", "dev", "counts", "rf", "id", "parent", "batch",
                 "t0", "start")

    def __init__(self, name, device, counts):
        self.name, self.dev, self.counts = name, device, counts

    def __enter__(self):
        stack = getattr(_open, "stack", None)
        if stack is None:
            stack = _open.stack = []
        top = stack[-1] if stack else (None, None, None)
        dev = self.dev
        if dev is None:
            dev = top[2]
        else:
            dev = torch.device(dev)
            dev = (None if dev.type != "cuda" else dev.index
                   if dev.index is not None else torch.cuda.current_device())
        self.dev = dev
        self.id, self.parent = next(_ids), top[0]
        self.batch = next(_batch_ids) if self.name == BATCH_SPAN else top[1]
        self.counts = {k: v() if callable(v) else v
                       for k, v in self.counts.items()} or None
        self.rf = torch.profiler.record_function(self.name)
        self.rf.__enter__()
        stack.append((self.id, self.batch, dev))
        self.t0 = time.perf_counter()
        self.start = None if dev is None else _record_event(dev)
        return self

    def __exit__(self, *exc):
        dev = self.dev
        end = None if dev is None else _record_event(dev)
        t1 = time.perf_counter()
        _open.stack.pop()
        self.rf.__exit__(*exc)
        with _lock:
            if end is not None:
                _unread.append(len(_records))
            _records.extend((self.id, self.name, self.parent, self.batch,
                             threading.get_ident(), self.t0, t1,
                             self.counts, dev, self.start, end))
        return False


def _read_finished():
    """Read the events of up to READ_AT_ONCE of the oldest records whose
    work the card has finished, without waiting for any; under `_lock`."""
    for _ in range(min(READ_AT_ONCE, len(_unread))):
        k = _unread[0]
        pool = _events[_records[k + 8]]
        if not (pool[_records[k + 10]].query()
                and pool[_records[k + 9]].query()):
            return
        _read_events(_unread.popleft())


def _read_events(k):
    """Read the timing events of the record at `_records[k]` (waiting for
    the card if they are pending) and give them back to the pool; in
    place, under `_lock`."""
    dev, start, end = _records[k + 8: k + RECORD_FIELDS]
    pool = _events[dev]
    pool[end].synchronize()
    _records[k + 9: k + 11] = pool[start].elapsed_time(pool[end]), None
    _free[dev].extend((start, end))


def span_records():
    """The closed spans, in the order they opened: dicts with `id`,
    `name`, `parent` (the enclosing span's id, or None), `batch`,
    `thread`, `t0` / `t1` (host seconds), `host_ms`, `device_ms` (None off
    a card), `self_ms` (the span's device ms less its children's, or its
    host ms less theirs off a card) and `counts`."""
    with _lock:
        for k in _unread:
            _read_events(k)
        _unread.clear()
        recs = []
        for k in range(0, len(_records), RECORD_FIELDS):
            counts = _records[k + 7]
            if counts and any(isinstance(v, torch.Tensor)
                              for v in counts.values()):
                _records[k + 7] = {name: int(round(v.item()))
                                   if isinstance(v, torch.Tensor) else v
                                   for name, v in counts.items()}
            recs.append(tuple(_records[k: k + RECORD_FIELDS]))
    recs.sort()
    kids_host, kids_dev = defaultdict(float), defaultdict(float)
    for _, _, parent, _, _, t0, t1, _, dev, dms, _ in recs:
        kids_host[parent] += 1e3 * (t1 - t0)
        if dev is not None:
            kids_dev[parent] += dms
    out = []
    for i, name, parent, batch, thread, t0, t1, counts, dev, dms, _ in recs:
        host_ms = 1e3 * (t1 - t0)
        own = (host_ms - kids_host[i] if dev is None
               else dms - kids_dev[i])
        out.append({"id": i, "name": name, "parent": parent, "batch": batch,
                    "thread": thread, "t0": t0, "t1": t1, "host_ms": host_ms,
                    "device_ms": None if dev is None else dms,
                    "self_ms": own, "counts": dict(counts or {})})
    return out


def reset_spans():
    """Empty the registry and give its unread events back to the pools
    (spans open now are recorded when they close)."""
    with _lock:
        for k in _unread:
            _free[_records[k + 8]].extend(_records[k + 9: k + 11])
        _unread.clear()
        _records.clear()


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
