"""Kernel launch counters shared by the kernel wrappers.

Each wrapper keeps its process-wide counts in its `launches` dict (one
entry a variant). Shard threads launch concurrently, so every increment
goes through :func:`count`, which holds a lock; a thread inside
:func:`per_thread` also gets its own launches counted apart, which is how a
sharded call reports the launches of each shard."""

import threading
from contextlib import contextmanager

_lock = threading.Lock()
_local = threading.local()


def count(wrapper, name, key):
    """One launch of `wrapper`'s variant `key`: added to `wrapper.launches`
    and, inside :func:`per_thread`, to the calling thread's counts under
    `name`."""
    with _lock:
        wrapper.launches[key] += 1
    mine = getattr(_local, "counts", None)
    if mine is not None:
        per = mine.setdefault(name, {})
        per[key] = per.get(key, 0) + 1


def reset(wrapper):
    """Set every variant of `wrapper` to 0."""
    with _lock:
        wrapper.launches = dict.fromkeys(wrapper.launches, 0)


@contextmanager
def per_thread():
    """Count the calling thread's launches while the block runs: yields a
    dict {wrapper name: {variant: launches}} that holds only the variants
    launched."""
    prev = getattr(_local, "counts", None)
    _local.counts = counts = {}
    try:
        yield counts
    finally:
        _local.counts = prev
