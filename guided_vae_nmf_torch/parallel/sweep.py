"""Sharded enhancement sweeps over a device mesh.

Counterpart of `guided_vae_nmf_tpu/parallel/sweep.py`: the file list
splits across processes (:func:`shard_file_list`), an utterance batch
splits over the mesh's data axis (:func:`sharded_mcem_m1`,
:func:`sharded_mcem_m2` on the eager engine, :func:`sharded_mcem_fused` on
the K1 / K2 kernels), and one long recording's frames split over the mesh
(:func:`frame_sharded_mcem`), or a batch of them over a 2-D (data, frame)
mesh (:func:`grid_sharded_mcem`). Parameters are replicated (one copy a
distinct device), each shard runs the single-device engine in a thread
of its own (`mesh.run_shards`), and only the frame-sharded forms
communicate: the W update's num / den and the cost's total and count go
through the shards' group (`LocalGroup`). Results come back on the
mesh's first device.

The eager engine is plan-invariant (a row's draws and arithmetic do not
depend on its batch), so the batch-sharded eager sweeps equal the
unsharded batch bit for bit. The fused engine seeds a batch's generator
from its first row's seed, as the JAX fused engine uses a batch's leading
key, so a shard equals the unsharded run of the same rows with the same
generator, and not the unsharded run of the whole batch.
"""

import numpy as np
import torch

from ..mcem.engine import (
    MCEMConfig,
    _nmf_init,
    _row_keys,
    fold_seed,
    mcem_m1_batch,
    mcem_m2_batch,
    mcem_run,
)
from .mesh import LocalGroup, pad_to_multiple, replicate, row_slices, \
    run_shards


def shard_file_list(file_paths, process_index=None, process_count=None):
    """This process's contiguous share of the utterance list
    (`np.array_split` over the processes of `multihost`)."""
    from . import multihost

    if process_index is None:
        process_index = multihost.process_index()
    if process_count is None:
        process_count = multihost.process_count()
    return list(np.array_split(np.asarray(file_paths),
                               process_count)[process_index])


def _pad_batch_to_mesh(arrays, n_dev):
    """Pad the leading axis of every array (tensor, numpy array or list) to
    a multiple of n_dev with copies of row 0, which the caller drops.
    Returns (arrays, B)."""
    B = len(arrays[0])
    Bp = pad_to_multiple(B, n_dev)
    out = []
    for a in arrays:
        if a is not None and Bp != B:
            if isinstance(a, torch.Tensor):
                a = torch.cat([a, a[:1].expand((Bp - B,) + a.shape[1:])])
            else:
                a = np.asarray(a)
                a = np.concatenate([a, np.broadcast_to(
                    a[:1], (Bp - B,) + a.shape[1:])])
        out.append(a)
    return out, B


def _to(x, device, sl=None):
    if x is None:
        return None
    x = torch.as_tensor(x)
    return (x if sl is None else x[sl]).to(device)


def _gather(parts, device, dim=0):
    """{key: tensor} parts concatenated along `dim` on `device`."""
    return {k: torch.cat([p[k].to(device) for p in parts], dim=dim)
            for k in parts[0]}


def _batch_sharded(mesh, run, arrays, seeds, axis=None):
    """run(replica, device, shard arrays, shard seeds) over the rows of
    `arrays` split over the mesh (its data `axis`, or every device)."""
    cells = mesh.cells(axis)
    devs = [mesh.devices[c] for c in cells]
    arrays_p, B = _pad_batch_to_mesh(list(arrays) + [list(seeds)],
                                       len(devs))
    seeds_p = [int(s) for s in arrays_p.pop()]
    slices = row_slices(len(seeds_p), len(devs))

    def shard(i, d):
        s = slices[i]
        return run(d, [_to(a, d, s) for a in arrays_p], seeds_p[s])

    parts = run_shards(mesh, shard, cells)
    out = _gather(parts, devs[0])
    return {k: v[:B] for k, v in out.items()}


def sharded_mcem_m1(mesh, model, X_abs2, mask, seeds,
                    cfg: MCEMConfig = MCEMConfig()):
    """The eager M1 engine with the utterance batch split over every
    device of the mesh: X_abs2 (B, F, N), mask (B, N), B seeds. A ragged
    batch is padded with row 0 and trimmed."""
    reps = replicate(mesh, model)
    return _batch_sharded(
        mesh, lambda d, a, s: mcem_m1_batch(reps[d], a[0], a[1], s, cfg),
        (X_abs2, mask), seeds)


def sharded_mcem_m2(mesh, model, X_abs2, mask, y, seeds,
                    cfg: MCEMConfig = MCEMConfig()):
    """The eager M2 engine with the utterance batch split over every
    device of the mesh; y (B, y_dim, N)."""
    reps = replicate(mesh, model)
    return _batch_sharded(
        mesh, lambda d, a, s: mcem_m2_batch(reps[d], a[0], a[1], a[2], s,
                                            cfg),
        (X_abs2, mask, y), seeds)


def sharded_mcem_fused(mesh, model, X_abs2, mask, y, seeds,
                       cfg: MCEMConfig = MCEMConfig(), axis="data",
                       **fused_kw):
    """The fused engine (K1 / K2 on CUDA) with the utterance batch split
    over the mesh's `axis`: each shard runs its rows with a generator
    seeded from its first row's seed (seeds[row] mod 2^63). No
    communication. `fused_kw` go to `mcem_batch_fused`."""
    from ..mcem.fused_engine import mcem_batch_fused

    reps = replicate(mesh, model)

    def run(d, a, s):
        gen = torch.Generator(device=d).manual_seed(int(s[0]) % 2**63)
        return mcem_batch_fused(reps[d], a[0], a[1], a[2], gen, cfg,
                                **fused_kw)

    return _batch_sharded(mesh, run, (X_abs2, mask, y), seeds, axis=axis)


def _global_nmf_init(seed, F, N, cfg, update_nmf, dtype, device):
    """One utterance's NMF start (W0 (F, K), H0 (K, N), g0 (N,)), drawn
    once for the whole recording and sliced by frame, so the run does not
    depend on the shard count: the draw single-device `mcem_run` makes
    for `seed` (H's column n is a hash of the seed and n alone). With a
    fixed noise model, Vb = Vb_fixed: W = 1, H = 0."""
    if update_nmf:
        W, H = _nmf_init(_row_keys([seed], device), F, cfg.nmf_rank, N,
                         cfg.eps)
        W, H = W[0].to(dtype), H[0].to(dtype)
    else:
        W = torch.ones((F, 1), dtype=dtype, device=device)
        H = torch.zeros((1, N), dtype=dtype, device=device)
    return W, H, torch.ones((N,), dtype=dtype, device=device)


def _frame_outputs(parts, device):
    """Per-frame results concatenated over the frame shards (the last
    axis); W and the cost, equal on every shard, from the first."""
    out = {k: torch.cat([p[k].to(device) for p in parts], dim=-1)
           for k in ("WFs", "WFn", "H", "g", "Z") + (
               ("b",) if "b" in parts[0] else ())}
    out["W"] = parts[0]["W"].to(device)
    out["cost"] = parts[0]["cost"].to(device)
    return out


def frame_sharded_mcem(mesh, model, X_abs2, mask, y, seed,
                       cfg: MCEMConfig = MCEMConfig(), axis="data",
                       update_nmf=True, Vb_fixed=None):
    """ONE long recording with its frames split over the mesh's `axis`,
    on the eager engine: X_abs2 (F, N) with N a multiple of the axis
    (pad with `pad_power` and the mask), mask (N,), y (y_dim, N) or None,
    Vb_fixed (F, N) with update_nmf=False. The chain and the H / g / b
    updates are per frame; the W update's sums and the cost are summed
    over the shards. The NMF start is drawn once for the recording
    (:func:`_global_nmf_init`) and sliced; shard j draws its chains from
    `fold_seed(seed, j)`. Returns `mcem_run`'s dict for one utterance:
    WFs / WFn (F, N), H, g, Z (and b) over all frames, W and cost (equal
    on every shard)."""
    devs = mesh.axis_devices(axis)
    n = len(devs)
    F, N = X_abs2.shape
    if N % n != 0:
        raise ValueError(f"frame count {N} must divide the mesh axis "
                         f"({n}); pad with pad_power + mask")
    X_abs2 = torch.as_tensor(X_abs2)
    W0, H0, g0 = _global_nmf_init(seed, F, N, cfg, update_nmf,
                                  X_abs2.dtype, X_abs2.device)
    group = LocalGroup(n, devs[0])
    frames = row_slices(N, n)

    def shard(j, d):
        s = (Ellipsis, frames[j])
        out = mcem_run(
            reps[d], _to(X_abs2, d, s)[None], _to(mask, d, s)[None],
            None if y is None else _to(y, d, s)[None],
            [fold_seed(seed, j)], cfg, update_nmf=update_nmf,
            Vb_fixed=None if Vb_fixed is None else _to(Vb_fixed, d, s)[None],
            init_nmf=(W0[None].to(d), H0[s][None].to(d), g0[s][None].to(d)),
            group=group.member(j))
        return {k: v[0] for k, v in out.items()}

    reps = replicate(mesh, model)
    parts = run_shards(mesh, shard, mesh.cells(axis), groups=(group,))
    return _frame_outputs(parts, devs[0])


def grid_sharded_mcem(mesh, model, X_abs2, mask, y, seeds,
                      cfg: MCEMConfig = MCEMConfig(), data_axis="data",
                      frame_axis="frame", update_nmf=True, Vb_fixed=None):
    """A batch of long recordings over a 2-D mesh: utterances split over
    `data_axis`, each utterance's frames over `frame_axis`, the sums of
    :func:`frame_sharded_mcem` along `frame_axis` only (one group per data
    index). X_abs2 (B, F, N) with B a multiple of the data axis and N of
    the frame axis; mask (B, N); y (B, y_dim, N) or None; B seeds, each
    drawing its utterance's start and folded with the frame shard's index
    as in :func:`frame_sharded_mcem`, so a B=1 run reproduces it. Returns
    the batched dict (B leading)."""
    nd, nf = mesh.shape[data_axis], mesh.shape[frame_axis]
    B, F, N = X_abs2.shape
    if B % nd != 0:
        raise ValueError(f"batch {B} must divide the {data_axis} axis "
                         f"({nd}); pad the batch (rows are masked per "
                         f"frame, duplicate + drop)")
    if N % nf != 0:
        raise ValueError(f"frame count {N} must divide the {frame_axis} "
                         f"axis ({nf}); pad with pad_power + mask")
    X_abs2 = torch.as_tensor(X_abs2)
    seeds = [int(s) for s in seeds]
    inits = [_global_nmf_init(s, F, N, cfg, update_nmf, X_abs2.dtype,
                              X_abs2.device) for s in seeds]
    W0, H0, g0 = (torch.stack(t) for t in zip(*inits))
    rows, frames = row_slices(B, nd), row_slices(N, nf)
    # shard (i, j): utterance rows i, frames j; one group per row i
    cells = [c for i in range(nd)
             for c in mesh.cells(frame_axis, **{data_axis: i})]
    groups = [LocalGroup(nf, mesh.devices[cells[i * nf]])
              for i in range(nd)]

    def shard(c, d):
        i, j = divmod(c, nf)
        r, s = rows[i], (Ellipsis, frames[j])
        return mcem_run(
            reps[d], _to(X_abs2[r], d, s), _to(mask[r], d, s),
            None if y is None else _to(y[r], d, s),
            [fold_seed(sd, j) for sd in seeds[r]], cfg,
            update_nmf=update_nmf,
            Vb_fixed=None if Vb_fixed is None else _to(Vb_fixed[r], d, s),
            init_nmf=(W0[r].to(d), H0[r][s].to(d), g0[r][s].to(d)),
            group=groups[i].member(j))

    reps = replicate(mesh, model)
    parts = run_shards(mesh, shard, cells, groups=groups)
    dev0 = mesh.devices[cells[0]]
    per_row = [_frame_outputs(parts[i * nf:(i + 1) * nf], dev0)
               for i in range(nd)]
    return _gather(per_row, dev0)
