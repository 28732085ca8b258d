"""Device meshes, row sharding and the shard runner.

Counterpart of `guided_vae_nmf_tpu/parallel/mesh.py`. One process drives
every device of a mesh, as the JAX package's single controller does: a
sharded call splits its rows (or frames) over the mesh's devices, runs the
single-device code on each shard in a host thread of its own (the fused
EM loop is host-paced, and PyTorch releases the GIL while it launches, so
one thread a shard overlaps the shards' host work), and gathers the
results. A shard thread makes its device current and launches on a
stream of its own; :func:`run_shards` waits for every shard, and a shard
that raises makes the whole call raise :class:`ShardError` (no shard is
dropped or rerun).

Where the JAX code sums over a mesh axis (`lax.psum`), the port calls
`group.all_sum(t)` on a group object: :class:`LocalGroup` for shard
threads of one process (the sum runs in shard order on the group's
device, so the result is deterministic), and `multihost.DistGroup` over
`torch.distributed`.

A mesh may name one device several times (`make_mesh(devices=[cuda:0] *
2)`, or `[torch.device("cpu")] * 4` in the CPU tests): the split, the
threads, the streams and the sums then run for real on one device.
"""

import threading
from contextlib import contextmanager

import numpy as np
import torch

from .. import _launches
from .._device import resolve_device


class ShardError(RuntimeError):
    """A shard of a sharded call raised; the shard's exception is the
    cause. Callers that retry or degrade on other runtime errors let this
    one through."""


def _normal(device):
    d = torch.device(device)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


class Mesh:
    """An n-D array of devices with one name an axis; `shape` maps each
    name to its size (`mesh.shape["data"]`, as in JAX). `shard_launches`
    holds the kernel launches of each shard position (in the order of
    `devices.ravel()`) over the sharded calls since
    :meth:`reset_shard_launches`."""

    def __init__(self, devices, axis_names):
        devices = np.asarray(devices, dtype=object)
        if devices.ndim != len(axis_names):
            raise ValueError(f"{devices.ndim}-D devices for axes "
                             f"{tuple(axis_names)}")
        self.devices = devices
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, devices.shape))
        self.reset_shard_launches()

    def cells(self, axis=None, **at):
        """Index tuples into `devices`: every cell with no `axis`, else
        the cells along `axis` with the other axes at `at` (default 0)."""
        if axis is None:
            return list(np.ndindex(self.devices.shape))
        out = []
        for i in range(self.shape[axis]):
            idx = [at.get(name, 0) for name in self.axis_names]
            idx[self.axis_names.index(axis)] = i
            out.append(tuple(idx))
        return out

    def axis_devices(self, axis="data"):
        """The devices along `axis`, every other axis at its first
        index."""
        return [self.devices[c] for c in self.cells(axis)]

    def reset_shard_launches(self):
        self.shard_launches = [{} for _ in range(self.devices.size)]

    def _add_launches(self, position, counts):
        mine = self.shard_launches[position]
        for name, per in counts.items():
            got = mine.setdefault(name, {})
            for key, n in per.items():
                got[key] = got.get(key, 0) + n

    def __repr__(self):
        return f"Mesh({self.shape}, {[str(d) for d in self.devices.ravel()]})"


def make_mesh(devices=None, axis_names=("data",), shape=None):
    """A Mesh over every visible CUDA device, or over `devices` (a device
    may repeat). With no `devices` and no card it raises, as
    `_device.resolve_device` does; it never falls back to the CPU. With
    several axis names give `shape` (e.g. ("data", "frame"), (2, 2))."""
    if devices is None:
        resolve_device()
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [_normal(d) for d in devices]
    if shape is None:
        shape = (len(devices),) + (1,) * (len(axis_names) - 1)
    arr = np.empty(len(devices), dtype=object)
    arr[:] = devices
    return Mesh(arr.reshape(shape), axis_names)


def data_parallel_mesh(device=None):
    """The mesh a `data_parallel` entry point shards over: every visible
    card when `device` is a CUDA device or None (raising without a card),
    else a mesh of the one named device (`device="cpu"`)."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        return make_mesh()
    return make_mesh(devices=[dev])


def data_size(mesh, axis="data"):
    """The size of the mesh's `axis`; a TypeError for anything but a
    Mesh."""
    if not isinstance(mesh, Mesh):
        raise TypeError(f"mesh must be a parallel.Mesh, got "
                        f"{type(mesh).__name__}")
    return mesh.shape[axis]


def pad_to_multiple(n, m):
    """Smallest n' >= n with n' % m == 0."""
    return ((n + m - 1) // m) * m


@contextmanager
def maybe_mesh(mesh):
    """Yields the mesh (or None). PyTorch has no ambient mesh, so this
    only keeps the JAX package's call sites' shape."""
    yield mesh


def row_slices(n, n_shards):
    """Contiguous row ranges of `n` rows over `n_shards` shards
    (`np.array_split`'s: the first n % n_shards shards take one more)."""
    bounds = np.cumsum([0] + [len(a) for a in np.array_split(
        np.arange(n), n_shards)])
    return [slice(int(a), int(b)) for a, b in zip(bounds[:-1], bounds[1:])]


def _tree(fn, t):
    if isinstance(t, dict):
        return {k: _tree(fn, v) for k, v in t.items()}
    if isinstance(t, (tuple, list)):
        return type(t)(_tree(fn, v) for v in t)
    return fn(t)


def shard_batch(mesh, tree, axis="data"):
    """Every tensor or array of `tree` with its leading axis split over
    the mesh's `axis`, each part on its shard's device; returns one tree a
    shard. The batch must divide the axis (padding is the caller's job,
    as in JAX)."""
    devs = mesh.axis_devices(axis)
    leaves = []
    _tree(leaves.append, tree)
    B = next(len(x) for x in leaves if x is not None)
    if B % len(devs):
        raise ValueError(f"batch {B} must divide the {axis} axis "
                         f"({len(devs)})")
    return [_tree(lambda x, s=s, d=d: None if x is None
                  else torch.as_tensor(x[s]).to(d), tree)
            for s, d in zip(row_slices(B, len(devs)), devs)]


def replicate(mesh, module):
    """{device: module} with one copy of `module` (or None) on each
    distinct device of the mesh; a device the module already lives on
    gets the module itself."""
    if module is None:
        return {d: None for d in mesh.devices.ravel()}
    home = next(module.parameters()).device
    out = {}
    for d in mesh.devices.ravel():
        if d not in out:
            out[d] = module if d == home else _copy_to(module, d)
    return out


def _copy_to(module, device):
    import copy

    return copy.deepcopy(module).to(device)


def _cuda_sync(device):
    if device.type == "cuda":
        torch.cuda.current_stream(device).synchronize()


class LocalGroup:
    """`all_sum` over the shard threads of one process: each of the `n`
    members hands its partial in, the first member adds them in member
    order on `device` and every member gets the sum back (a copy on its
    own device). Each member calls :meth:`member`'s `all_sum` the same
    number of times."""

    def __init__(self, n, device):
        self.n = n
        self.device = _normal(device)
        self._barrier = threading.Barrier(n)
        self._parts = [None] * n
        self._sum = None

    def member(self, rank):
        return _Member(self, rank)

    def abort(self):
        """Release members waiting for a member that failed (they raise
        `threading.BrokenBarrierError`)."""
        self._barrier.abort()


class _Member:
    def __init__(self, group, rank):
        self.group, self.rank = group, rank

    def all_sum(self, t):
        g = self.group
        _cuda_sync(t.device)
        g._parts[self.rank] = t
        g._barrier.wait()
        if self.rank == 0:
            total = g._parts[0].to(g.device)
            for p in g._parts[1:]:
                total = total + p.to(g.device)
            _cuda_sync(g.device)
            g._sum = total
        g._barrier.wait()
        out = g._sum.to(t.device, copy=True)
        _cuda_sync(t.device)
        g._barrier.wait()
        return out


@contextmanager
def _on_device(device, main_stream):
    """The shard thread's device made current, with a stream of its own
    that starts after the caller's work on that device."""
    if device.type != "cuda":
        yield
        return
    with torch.cuda.device(device):
        stream = torch.cuda.Stream(device=device)
        stream.wait_stream(main_stream)
        with torch.cuda.stream(stream):
            yield
        stream.synchronize()


def run_shards(mesh, fn, cells=None, groups=()):
    """fn(i, device) for each shard i in a thread of its own, shard i on
    the device of `cells[i]` (index tuples of `mesh.cells()`; default:
    every cell); returns the results in shard order. Tensors in a result
    may be used on the caller's stream. A shard that raises aborts
    `groups` (so no shard waits for it) and the call raises ShardError
    from the first shard's error. Each shard's kernel launches are added
    to `mesh.shard_launches` at its cell's flat position."""
    cells = mesh.cells() if cells is None else cells
    devices = [mesh.devices[c] for c in cells]
    main = {d: torch.cuda.current_stream(d) for d in set(devices)
            if d.type == "cuda"}
    n = len(devices)
    results, errors, counts = [None] * n, [None] * n, [None] * n

    def work(i):
        d = devices[i]
        try:
            with _launches.per_thread() as c, _on_device(d, main.get(d)):
                out = fn(i, d)
            counts[i] = c
            if d.type == "cuda":
                def keep(t):
                    if isinstance(t, torch.Tensor) and t.device == d:
                        t.record_stream(main[d])
                    return t
                _tree(keep, out)
            results[i] = out
        except BaseException as exc:       # noqa: BLE001 (re-raised below)
            errors[i] = exc
            for g in groups:
                g.abort()

    threads = [threading.Thread(target=work, args=(i,), daemon=True,
                                name=f"gvnmf-shard-{i}") for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    failed = [i for i in range(n) if errors[i] is not None]
    if failed:
        first = next((i for i in failed if not isinstance(
            errors[i], threading.BrokenBarrierError)), failed[0])
        raise ShardError(f"shard {first} of {n} on {devices[first]} "
                         f"failed: {errors[first]!r}") from errors[first]
    for c, n in zip(cells, counts):
        mesh._add_launches(int(np.ravel_multi_index(
            c, mesh.devices.shape)), n)
    return results
