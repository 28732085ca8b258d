"""Training loops for the four model families.

Counterpart of `guided_vae_nmf_tpu/train/trainer.py` (reference
scripts/training_M1.py, training_M2.py, training_classifier.py,
training_wiener_filter.py): Adam (lr 1e-3, betas (0.9, 0.999)), batch 128,
the IS-divergence ELBO for M1 / M2, the logits-form BCE (+ F1) for the
classifier, the mask-MSE for the Wiener DNN, per-epoch validation,
`output_batch.log` / `output_epoch.log`, per-epoch checkpoints named
`{name}_epoch_{e:03d}_vloss_{v:.2f}` and `resume_state.npz` in the JAX
package's layout, so a run started in either package resumes in the other.

The frames are copied to the device once. Each epoch's batch permutation
is drawn on the host from `numpy.random.RandomState(cfg.seed)`, as the JAX
package draws it, moved to the device in one copy and indexed there; the
losses accumulate on the device, and the host reads the device once an
epoch: one copy that holds the epoch's losses and a snapshot of the
parameters and the Adam state, which the checkpoint saver thread writes
while the next epoch runs. The reparametrisation draws of M1 / M2 come
from a `torch.Generator` seeded by `cfg.seed`: the same distribution as
JAX's key chain, not the same bits.

Data-parallel training (`mesh=`, a `parallel.Mesh`) changes where a step
runs, not what it computes, as in the JAX package: the step's
reparametrisation draws are taken once for the whole batch and split by
rows, each shard runs the forward and backward pass on its rows on a
replica of the model (one a distinct device) in a thread of its own, the
shards' gradients are weighted by their share of the batch and summed in
shard order on the first device, and one Adam step there is copied to
every replica. The losses are batch means, so this is the single-device
step up to the order of its float sums.
"""

import copy
import os
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from functools import partial

import numpy as np
import torch

from .._device import resolve_device
from ..utils import device_warmup
from ..data.h5io import frame_batches
from ..parallel.mesh import data_size, replicate, row_slices, run_shards
from ..models import (
    binary_cross_entropy_logits,
    classifier_apply,
    classifier_apply_logits,
    classifier_init,
    dgm_apply,
    dgm_init,
    elbo,
    mean_square_error_mask,
    module_from_params,
    vae_apply,
    vae_init,
)
from ..models.convert import leaf_order, static_leaves, unflatten
from .checkpoints import (
    _flat_arrays,
    best_checkpoint,
    load_params,
    load_resume_state,
    save_classifier_meta,
    save_params,
    save_resume_state,
)

# optax.adam's default epsilon; TrainConfig.eps is the losses' eps
ADAM_EPS = 1e-8


@dataclass(frozen=True)
class TrainConfig:
    """Optimizer / loop settings (reference training_M1.py:26-41)."""

    batch_size: int = 128
    learning_rate: float = 1e-3
    beta1: float = 0.9
    beta2: float = 0.999
    eps: float = 1e-8
    start_epoch: int = 1
    end_epoch: int = 200
    seed: int = 0


def make_optimizer(cfg: TrainConfig, params):
    """Adam over `params` with optax.adam's semantics: lr, betas, eps 1e-8
    (the fused update when every tensor lies on the GPU)."""
    params = list(params)
    fused = bool(params) and all(p.is_cuda for p in params)
    return torch.optim.Adam(params, lr=cfg.learning_rate,
                            betas=(cfg.beta1, cfg.beta2), eps=ADAM_EPS,
                            fused=fused or None)


# ---------------------------------------------------------------------------
# Per-family losses: (model, batch, generator, eps) -> (loss, aux)
# ---------------------------------------------------------------------------


def m1_loss(model, batch, generator, eps, noise=None):
    x, _ = batch
    r, mu, logvar = vae_apply(model, x, generator, noise)
    loss, recon, KL = elbo(x, r, mu, logvar, eps)
    return loss, {"recon": recon, "KL": KL}


def m2_loss(model, batch, generator, eps, noise=None):
    x, y = batch
    r, mu, logvar = dgm_apply(model, x, y, generator, noise)
    loss, recon, KL = elbo(x, r, mu, logvar, eps)
    return loss, {"recon": recon, "KL": KL}


def classifier_loss(model, batch, generator, eps, pos_weight=None):
    """Logits-form BCE (pos_weight: the positive-class weight, None = the
    reference's objective) with tp / tn / fp / fn of the hard decisions."""
    x, y = batch
    z = classifier_apply_logits(model, x)
    loss = binary_cross_entropy_logits(z, y, pos_weight)
    y_hard = (z > 0.0).to(torch.float32)
    aux = {
        "tp": torch.sum(y * y_hard),
        "tn": torch.sum((1 - y) * (1 - y_hard)),
        "fp": torch.sum((1 - y) * y_hard),
        "fn": torch.sum(y * (1 - y_hard)),
    }
    return loss, aux


def wiener_loss(model, batch, generator, eps):
    x, y = batch
    return mean_square_error_mask(y, classifier_apply(model, x)), {}


LOSSES = {
    "m1": m1_loss,
    "m2": m2_loss,
    "classifier": classifier_loss,
    "wiener": wiener_loss,
}


# ---------------------------------------------------------------------------
# Steps
# ---------------------------------------------------------------------------


# classifier_loss's aux entries are counts, which add over shards; the
# others (M1 / M2's recon, KL) are batch means, weighted like the loss
_COUNT_AUX = ("tp", "tn", "fp", "fn")


class _Shards:
    """The data-parallel pass over a mesh's "data" axis for one model:
    its replicas (the model itself on its own device, a copy on each other
    device) and (loss, aux, gradients) of a batch as the weighted sum of
    the shards' in shard order."""

    def __init__(self, mesh, model):
        self.mesh, self.n = mesh, data_size(mesh)
        self.cells = mesh.cells("data")
        self.model = model
        self.replicas = replicate(mesh, model)
        for m in self.replicas.values():
            if m is not model:
                for _, t in _trainable(m):
                    t.requires_grad_(True)

    def sync(self):
        """Copy the model's trained tensors into the other replicas."""
        src = [t for _, t in _trainable(self.model)]
        with torch.no_grad():
            for m in self.replicas.values():
                if m is not self.model:
                    for (_, t), v in zip(_trainable(m), src):
                        t.copy_(v)

    def __call__(self, loss_fn, batch, generator, eps, grad):
        x, y = batch
        B = len(x)
        dev0 = x.device
        noise = None
        if generator is not None:
            # one draw for the whole batch, through reparametrize (at
            # mu = log_var = 0 it returns the draw itself)
            from ..models import nets

            zero = torch.zeros((B, self.model.encoder.mu.w.shape[1]),
                               device=dev0)
            noise = nets.reparametrize(generator, zero, zero)
        slices = row_slices(B, self.n)

        def shard(i, d):
            s, m = slices[i], self.replicas[d]
            part = (x[s].to(d), None if y is None else y[s].to(d))
            kw = {} if noise is None else {"noise": noise[s].to(d)}
            if not grad:
                with torch.no_grad():
                    return loss_fn(m, part, None, eps, **kw) + (None,)
            loss, aux = loss_fn(m, part, None, eps, **kw)
            g = torch.autograd.grad(loss, [t for _, t in _trainable(m)],
                                    allow_unused=True)
            return loss.detach(), {k: v.detach() for k, v in aux.items()}, g

        parts = run_shards(self.mesh, shard, self.cells)
        w = [(s.stop - s.start) / B for s in slices]
        loss = sum(wi * p[0].to(dev0) for wi, p in zip(w, parts))
        aux = {k: sum((1.0 if k in _COUNT_AUX else wi) * p[1][k].to(dev0)
                      for wi, p in zip(w, parts)) for k in parts[0][1]}
        grads = None
        if grad:
            grads = []
            for j, (_, t) in enumerate(_trainable(self.model)):
                grads.append(sum(wi * (torch.zeros_like(t) if p[2][j] is None
                                       else p[2][j].to(dev0))
                                 for wi, p in zip(w, parts)))
        return loss, aux, grads


def make_train_step(loss_fn, optimizer, eps, mesh=None):
    """step(model, batch, generator) -> (loss, aux): one Adam update of
    the optimizer's tensors from the gradient of `loss_fn`. With a mesh,
    the batch's rows are split over its "data" axis (see the module
    docstring); `optimizer` holds the tensors of the `model` given to
    the step."""
    if mesh is not None:
        shards = {}

        def sharded(model, batch, generator=None):
            sh = shards.get(id(model))
            if sh is None:
                sh = shards[id(model)] = _Shards(mesh, model)
            loss, aux, grads = sh(loss_fn, batch, generator, eps, grad=True)
            for (_, t), g in zip(_trainable(model), grads):
                t.grad = g
            optimizer.step()
            optimizer.zero_grad(set_to_none=True)
            sh.sync()
            return loss, aux

        return sharded

    def step(model, batch, generator=None):
        loss, aux = loss_fn(model, batch, generator, eps)
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        optimizer.step()
        return loss.detach(), {k: v.detach() for k, v in aux.items()}

    return step


def make_eval_step(loss_fn, eps, mesh=None):
    """step(model, batch, generator) -> (loss, aux) without gradients;
    with a mesh, over its "data" axis."""
    if mesh is not None:
        shards = {}

        def sharded(model, batch, generator=None):
            sh = shards.get(id(model))
            if sh is None:
                sh = shards[id(model)] = _Shards(mesh, model)
            sh.sync()
            return sh(loss_fn, batch, generator, eps, grad=False)[:2]

        return sharded

    def step(model, batch, generator=None):
        with torch.no_grad():
            return loss_fn(model, batch, generator, eps)

    return step


# ---------------------------------------------------------------------------
# Trained tensors, Adam state and the host snapshot
# ---------------------------------------------------------------------------


def _trainable(model):
    """[(dotted path, tensor)] of every array leaf of the JAX tree, in
    its flatten order: the Linear parameters and, with BatchNorm, the
    scale / bias / running mean / var buffers (the JAX trainer updates
    all four by gradient; the loss reads them in eval mode)."""
    leaves = dict(model.named_parameters())
    leaves.update(model.named_buffers())
    return [(k, leaves[k]) for k in leaf_order(leaves)]


def _set_adam_state(opt, leaves, adam):
    """Load `adam` ({"count", "mu", "nu"} by path) into `opt`."""
    sd = opt.state_dict()
    sd["state"] = {
        i: {"step": torch.tensor(float(adam["count"])),
            "exp_avg": torch.as_tensor(np.asarray(adam["mu"][k])),
            "exp_avg_sq": torch.as_tensor(np.asarray(adam["nu"][k]))}
        for i, (k, _) in enumerate(leaves)}
    opt.load_state_dict(sd)


def _snapshot(values, leaves, opt):
    """One device-to-host copy of the epoch's `values` (a float32 vector),
    every leaf and its Adam moments (zeros before the first step). Returns
    (values, {path: array}, {path: mu}, {path: nu}) as numpy arrays."""
    parts = [values]
    for _, t in leaves:
        parts.append(t.detach().reshape(-1))
    for key in ("exp_avg", "exp_avg_sq"):
        for _, t in leaves:
            st = opt.state.get(t, {})
            parts.append(st[key].reshape(-1) if key in st
                         else torch.zeros_like(t).reshape(-1))
    host = torch.cat(parts).cpu().numpy()
    sizes = [p.numel() for p in parts]
    chunks = np.split(host, np.cumsum(sizes)[:-1])
    n = len(leaves)
    shaped = [c.reshape(tuple(t.shape)) for c, (_, t) in
              zip(chunks[1:], leaves * 3)]
    keys = [k for k, _ in leaves]
    return (chunks[0], dict(zip(keys, shaped[:n])),
            dict(zip(keys, shaped[n:2 * n])),
            dict(zip(keys, shaped[2 * n:])))


def _to_device(a, dev, dtype=torch.float32):
    """A host array (or tensor) as a contiguous `dtype` tensor on `dev`;
    to a GPU through pinned memory, without a host sync."""
    if isinstance(a, torch.Tensor):
        return a.to(dev, dtype)
    t = torch.as_tensor(np.ascontiguousarray(a), dtype=dtype)
    if dev.type == "cuda":
        return t.pin_memory().to(dev, non_blocking=True)
    return t


def _as_module(model):
    """A trainable copy of a module, or the module a parameter tree
    describes."""
    if isinstance(model, torch.nn.Module):
        return copy.deepcopy(model)
    return module_from_params(model)


# ---------------------------------------------------------------------------
# Generic fit loop
# ---------------------------------------------------------------------------


def _log(path, msg):
    with open(path, "a") as f:
        print(msg, file=f)


def fit(model, family, train_data, valid_data, cfg: TrainConfig, model_dir,
        name, mesh=None, resume=False, verbose=False, loss_fn=None,
        device=None):
    """Train a copy of `model` (a module, or a JAX parameter tree) of a
    model `family` on `device` (the GPU unless named).

    train_data / valid_data: (X, Y) with X (n_frames, x_dim) float32 and Y
    (n_frames, y_dim) or None (M1), numpy arrays or tensors; train_data
    may also be an `H5StreamSource`. `loss_fn` overrides the family's
    objective (same signature), e.g. a pos_weighted classifier BCE; on a
    mesh an M1 / M2 objective also takes `noise=`, its shard's rows of
    the batch's reparametrisation draws. Returns (module, history): the trained module, frozen, on `device`.

    Paths, as in the JAX package: the device-resident epoch when the
    training set holds a batch, the stream when given a source, else the
    small-set batch loop (which trains on no batch: it drops the
    remainder). Validation takes the first nb_va * bs_va frames
    unshuffled; an empty set gives va_loss 0.0.

    mesh: a `parallel.Mesh` for data-parallel steps (module docstring);
    the model then lives on its "data" axis's first device and `device`
    is unused. As in the JAX package, the device-resident epoch needs the
    batch size to divide by the axis, and the small-set loop runs
    otherwise.
    """
    if mesh is None:
        dev = resolve_device(device)
        devices = [dev]
    else:
        n_dev = data_size(mesh)
        dev = mesh.axis_devices("data")[0]
        devices = set(mesh.devices.ravel())
    for d in devices:
        device_warmup(d)
    os.makedirs(model_dir, exist_ok=True)
    loss_fn = loss_fn or LOSSES[family]
    model = _as_module(model).to(dev)
    static = static_leaves(model)
    leaves = _trainable(model)
    for _, t in leaves:
        t.requires_grad_(True)
    optimizer = make_optimizer(cfg, [t for _, t in leaves])
    train_step = make_train_step(loss_fn, optimizer, cfg.eps, mesh)
    eval_step = make_eval_step(loss_fn, cfg.eps, mesh)

    start_epoch = cfg.start_epoch
    count = 0
    if resume:
        restored = load_resume_state(model_dir)
        if restored is not None:
            start_epoch, tree, adam = restored
            start_epoch += 1
            state = {k: torch.as_tensor(np.asarray(v, np.float32))
                     for k, v in _flat_arrays(tree).items()}
            with torch.no_grad():
                for k, t in leaves:
                    t.copy_(state[k])
            count = adam["count"]
            _set_adam_state(optimizer, leaves, adam)

    batch_log = os.path.join(model_dir, "output_batch.log")
    epoch_log = os.path.join(model_dir, "output_epoch.log")
    rng = np.random.RandomState(cfg.seed)
    generator = None
    if family in ("m1", "m2"):
        generator = torch.Generator(device=dev).manual_seed(cfg.seed)
    bs = cfg.batch_size

    use_stream = hasattr(train_data, "epoch_chunks")
    if use_stream:
        source = train_data
        if source.chunk_frames % bs:
            raise ValueError("chunk_frames must be a multiple of "
                             "batch_size for the streaming trainer")
        nb_chunk = source.chunk_frames // bs
    else:
        Xtr, Ytr = train_data
    Xva, Yva = valid_data
    use_epoch = use_stream or (len(Xtr) >= bs and (
        mesh is None or bs % n_dev == 0))
    if use_epoch:
        if not use_stream:
            X_tr_d = _to_device(Xtr, dev)
            Y_tr_d = None if Ytr is None else _to_device(Ytr, dev)
            nb_tr = len(Xtr) // bs
        X_va_d = _to_device(Xva, dev)
        Y_va_d = None if Yva is None else _to_device(Yva, dev)
        nb_va = max(len(Xva) // bs, 1)
        bs_va = min(bs, len(Xva))
        idx_va = torch.arange(nb_va * bs_va, device=dev).reshape(nb_va,
                                                                 bs_va)

    def train_rows(X, Y, perm):
        """The batches of `perm` (nb, bs) on the device; their losses."""
        losses = []
        for rows in perm:
            batch = (X[rows], None if Y is None else Y[rows])
            losses.append(train_step(model, batch, generator)[0])
        return losses

    def evaluate(batches):
        """(mean loss, {aux: sum}) over `batches`, on the device."""
        losses, auxs = [], {}
        for batch in batches:
            loss, aux = eval_step(model, batch, generator)
            losses.append(loss)
            for k, v in aux.items():
                auxs.setdefault(k, []).append(v)
        if not losses:
            return torch.zeros((), device=dev), {}
        return (torch.mean(torch.stack(losses)),
                {k: torch.sum(torch.stack(v)) for k, v in auxs.items()})

    # checkpoint writes (npz of the host snapshot) run off the critical
    # path on a single saver thread
    history = []
    with ThreadPoolExecutor(max_workers=1) as saver:
        save_futs = []
        for epoch in range(start_epoch, cfg.end_epoch + 1):
            t0 = time.time()
            if use_stream:
                chunk_losses = []
                for X_c, Y_c in source.epoch_chunks(epoch):
                    X_d = _to_device(X_c, dev)
                    Y_d = _to_device(Y_c, dev)
                    idx = np.arange(len(X_c))
                    rng.shuffle(idx)
                    perm = _to_device(
                        idx[: nb_chunk * bs].reshape(nb_chunk, bs), dev,
                        torch.int64)
                    losses = train_rows(X_d, Y_d, perm)
                    chunk_losses.append(torch.mean(torch.stack(losses)))
                tr_loss = torch.mean(torch.stack(chunk_losses))
                count += nb_chunk * len(chunk_losses)
            elif use_epoch:
                idx = np.arange(len(Xtr))
                rng.shuffle(idx)
                perm = _to_device(idx[: nb_tr * bs].reshape(nb_tr, bs), dev,
                                  torch.int64)
                tr_loss = torch.mean(torch.stack(
                    train_rows(X_tr_d, Y_tr_d, perm)))
                count += nb_tr
            else:
                losses = [train_step(model, (_to_device(xb, dev),
                                             None if yb is None
                                             else _to_device(yb, dev)),
                                     generator)[0]
                          for xb, yb in frame_batches(Xtr, Ytr, bs, key=rng)]
                tr_loss = (torch.mean(torch.stack(losses)) if losses
                           else torch.zeros((), device=dev))
                count += len(losses)
            if use_epoch:
                if bs_va > 0:
                    va_loss, aux = evaluate(
                        (X_va_d[i], None if Y_va_d is None else Y_va_d[i])
                        for i in idx_va)
                else:
                    va_loss, aux = torch.zeros((), device=dev), {}
            else:
                va_loss, aux = evaluate(
                    (_to_device(xb, dev), None if yb is None
                     else _to_device(yb, dev))
                    for xb, yb in frame_batches(Xva, Yva, bs))

            # the epoch's one host read: losses, aux sums and the snapshot
            names = list(aux)
            values = torch.stack([tr_loss, va_loss] + [aux[k] for k in names])
            vals, params, mu, nu = _snapshot(values.to(torch.float32), leaves,
                                             optimizer)
            tr_loss, va_loss = float(vals[0]), float(vals[1])
            agg = {k: float(v) for k, v in zip(names, vals[2:])}
            _log(batch_log, f"Epoch: {epoch} Train loss: {tr_loss:.6f} "
                            f"time: {time.time() - t0:.2f}s")

            extra = ""
            if family == "classifier" and agg:
                tp, tn = agg.get("tp", 0), agg.get("tn", 0)
                fp, fn = agg.get("fp", 0), agg.get("fn", 0)
                f1 = 2 * tp / max(2 * tp + fp + fn, 1e-8)
                extra = f" F1: {f1:.4f}"
            _log(epoch_log, f"Epoch: {epoch} Train loss: {tr_loss:.6f} "
                            f"Valid loss: {va_loss:.6f}{extra}")
            if verbose:
                print(f"[{name}] epoch {epoch}: train {tr_loss:.4f} "
                      f"valid {va_loss:.4f}{extra}")

            tree = {**unflatten(params), **static}
            adam = {"count": count, "mu": mu, "nu": nu}

            def _save(epoch=epoch, va_loss=va_loss, tree=tree, adam=adam):
                save_params(model_dir, name, epoch, va_loss, tree)
                save_resume_state(model_dir, epoch, tree, adam)

            # fail fast on saver errors and bound the queue of snapshots
            save_futs.append(saver.submit(_save))
            while len(save_futs) > 4 or (save_futs and save_futs[0].done()):
                save_futs.pop(0).result()
            history.append({"epoch": epoch, "train": tr_loss,
                            "valid": va_loss, "time_s": time.time() - t0})

        for f in save_futs:
            f.result()  # surface saver exceptions
    for _, t in leaves:
        t.requires_grad_(False)
    return model.eval(), history


# ---------------------------------------------------------------------------
# Family-specific front doors (mirror the reference scripts)
# ---------------------------------------------------------------------------


def _init_generator(cfg):
    return torch.Generator().manual_seed(cfg.seed)


def train_m1(train_frames, valid_frames, dims=(513, 32, (128, 128)),
             cfg=TrainConfig(), model_dir="models/M1", name="M1", mesh=None,
             resume=False, verbose=False, device=None):
    """M1 VAE on clean-speech frames (reference training_M1.py)."""
    x_dim, z_dim, h_dim = dims
    model = vae_init(_init_generator(cfg), [x_dim, z_dim, list(h_dim)])
    return fit(model, "m1", (train_frames, None), (valid_frames, None),
               cfg, model_dir, name, mesh, resume, verbose, device=device)


def train_m2(train_data, valid_data, dims=(513, 513, 32, (128, 128)),
             cfg=TrainConfig(), model_dir="models/M2", name="M2", mesh=None,
             resume=False, verbose=False, device=None):
    """Guided M2 on (noisy frames, oracle labels) (reference
    training_M2.py)."""
    x_dim, y_dim, z_dim, h_dim = dims
    model = dgm_init(_init_generator(cfg), [x_dim, y_dim, z_dim,
                                            list(h_dim)])
    return fit(model, "m2", train_data, valid_data, cfg, model_dir, name,
               mesh, resume, verbose, device=device)


def calibrate_threshold(model, X_valid, Y_valid, grid=None,
                        batch_frames=65536):
    """F1-maximizing hard-decision threshold on (already transformed and
    standardized) validation frames, with `model` on its device. Returns
    (threshold, f1_at_threshold). The reference hard-codes > 0.5."""
    if grid is None:
        grid = np.round(np.arange(0.05, 0.96, 0.05), 2)
    dev = next(model.parameters()).device
    tp = np.zeros(len(grid))
    fp = np.zeros(len(grid))
    fn = np.zeros(len(grid))
    for i in range(0, len(X_valid), batch_frames):
        with torch.no_grad():
            ys = classifier_apply(model, _to_device(
                X_valid[i:i + batch_frames], dev)).cpu().numpy()
        yt = np.asarray(Y_valid[i:i + batch_frames]) > 0.5
        for gi, t in enumerate(grid):
            yh = ys > t
            tp[gi] += np.sum(yh & yt)
            fp[gi] += np.sum(yh & ~yt)
            fn[gi] += np.sum(~yh & yt)
    f1 = 2 * tp / np.maximum(2 * tp + fp + fn, 1)
    best = int(np.argmax(f1))
    return float(grid[best]), float(f1[best])


def _save_norm_stats(model_dir, mean, std):
    if mean is not None:
        os.makedirs(model_dir, exist_ok=True)
        np.save(os.path.join(model_dir, "trainset_mean.npy"), mean)
        np.save(os.path.join(model_dir, "trainset_std.npy"), std)


def train_classifier(train_data, valid_data, dims=(513, (128, 128), 513),
                     cfg=TrainConfig(), model_dir="models/classifier",
                     name="Classifier", mean=None, std=None, mesh=None,
                     resume=False, verbose=False, features="power",
                     pos_weight=None, calibrate=False, meta_extra=None,
                     device=None):
    """Supervised IBM / VAD classifier on standardized noisy frames
    (reference training_classifier.py; the train mean / std are saved as
    trainset_mean.npy / trainset_std.npy side-cars).

    features   — the input transform the caller applied before
                 standardization ('power' | 'log-power'), recorded in
                 classifier_meta.json so inference matches;
    pos_weight — optional positive-class BCE weight;
    calibrate  — after training, the F1-maximizing threshold of the best
                 checkpoint on the validation set becomes the model's
                 default.
    """
    from ..models.nets import FEATURE_MODES

    if features not in FEATURE_MODES:
        raise ValueError(f"features must be one of {FEATURE_MODES}, "
                         f"got {features!r}")
    x_dim, h_dim, y_dim = dims
    model = classifier_init(_init_generator(cfg),
                            [x_dim, list(h_dim), y_dim])
    _save_norm_stats(model_dir, mean, std)
    loss_fn = None
    if pos_weight is not None:
        loss_fn = partial(classifier_loss, pos_weight=float(pos_weight))
    out = fit(model, "classifier", train_data, valid_data, cfg, model_dir,
              name, mesh, resume, verbose, loss_fn=loss_fn, device=device)

    meta = {"features": features, "threshold": 0.5,
            "pos_weight": pos_weight}
    if calibrate:
        best = best_checkpoint(model_dir)
        m_best = out[0]
        if best:
            m_best = module_from_params(load_params(best),
                                        device=next(out[0].parameters())
                                        .device)
        Xva, Yva = valid_data
        thr, f1 = calibrate_threshold(m_best, np.asarray(Xva),
                                      np.asarray(Yva))
        meta.update(threshold=thr, valid_f1=round(f1, 4))
    meta.update(meta_extra or {})
    save_classifier_meta(model_dir, meta)
    return out


def train_wiener(train_data, valid_data, dims=(513, (128,) * 5, 513),
                 cfg=TrainConfig(), model_dir="models/wiener", name="Wiener",
                 mean=None, std=None, mesh=None, resume=False,
                 verbose=False, device=None):
    """Wiener-mask DNN baseline (reference training_wiener_filter.py:45:
    5x128 hidden, mask-MSE loss)."""
    x_dim, h_dim, y_dim = dims
    model = classifier_init(_init_generator(cfg),
                            [x_dim, list(h_dim), y_dim])
    _save_norm_stats(model_dir, mean, std)
    return fit(model, "wiener", train_data, valid_data, cfg, model_dir,
               name, mesh, resume, verbose, device=device)
