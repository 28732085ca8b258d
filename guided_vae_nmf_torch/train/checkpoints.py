"""Checkpoints, resume state and side-cars.

Counterpart of `guided_vae_nmf_tpu/train/checkpoints.py`, with the same
files, so each package reads what the other writes:

- `<model_dir>/<name>_epoch_{e:03d}_vloss_{v:.2f}.ckpt.npz`: a flat npz
  mapping dotted tree paths (`encoder.hidden.0.w`) to arrays, Linear
  weights stored (in, out);
- `resume_state.npz`: `__epoch`, the parameters under `p.<path>`, and
  optax's Adam state under `o.<i>` in optax's leaf order (the step count,
  then every first moment, then every second moment, each in the JAX
  tree-flatten order of the parameters: dict keys sorted, list items by
  index). The port holds the Adam state as {"count": int, "mu": {path:
  array}, "nu": {path: array}} (:func:`load_resume_state`);
- `trainset_mean.npy` / `trainset_std.npy` and `classifier_meta.json`.
"""

import json
import os
import re
from glob import glob

import numpy as np

from .._device import resolve_device
from ..models.convert import (_flatten, leaf_order, module_from_params,
                              params_from_module, unflatten)
from ..models.torch_import import import_classifier, import_dgm, import_vae


def checkpoint_name(name, epoch, vloss):
    """The reference's per-epoch naming (training_M1.py:143-145)."""
    return f"{name}_epoch_{epoch:03d}_vloss_{vloss:.2f}"


def _strip_static(params):
    if isinstance(params, dict):
        return {k: _strip_static(v) for k, v in params.items()
                if not isinstance(v, (bool, int, str, float))
                or hasattr(v, "shape")}
    if isinstance(params, (list, tuple)):
        return [_strip_static(v) for v in params]
    return params


def _flat_arrays(params):
    """{dotted path: numpy array} of a parameter tree or a module."""
    if not isinstance(params, dict):
        params = params_from_module(params)
    return {k: np.asarray(v) for k, v in
            _flatten(_strip_static(params)).items()}


def save_params(model_dir, name, epoch, vloss, params):
    """Write `params` (a parameter tree or a module) as
    `<name>_epoch_{e:03d}_vloss_{v:.2f}.ckpt.npz`; returns its path."""
    os.makedirs(model_dir, exist_ok=True)
    path = os.path.join(model_dir,
                        checkpoint_name(name, epoch, vloss) + ".ckpt.npz")
    np.savez(path, **_flat_arrays(params))
    return path


def load_params(path, static=None):
    """Load a parameter tree; `static` re-attaches non-array leaves (e.g.
    {'batch_norm': False, 'y_dim': 513})."""
    with np.load(path) as data:
        flat = {k: data[k] for k in data.files}
    tree = unflatten(flat)
    if static:
        tree.update(static)
    return tree


def best_checkpoint(model_dir, name=None):
    """Path of the lowest-vloss checkpoint in a model dir (None if none)."""
    pattern = os.path.join(model_dir, "*_vloss_*.ckpt.npz")
    best, best_v = None, float("inf")
    for path in glob(pattern):
        m = re.search(r"_epoch_(\d+)_vloss_([-\d.]+)\.ckpt\.npz$", path)
        if not m:
            continue
        if name is not None and not os.path.basename(path).startswith(name):
            continue
        v = float(m.group(2))
        if v < best_v:
            best, best_v = path, v
    return best


def save_resume_state(model_dir, epoch, params, adam, extra=None):
    """Write `resume_state.npz`: the epoch, `params` (a tree or a module)
    and `adam` ({"count", "mu", "nu"}, moments keyed by dotted path) in
    the JAX package's layout. Returns its path."""
    os.makedirs(model_dir, exist_ok=True)
    path = os.path.join(model_dir, "resume_state.npz")
    pflat = _flat_arrays(params)
    flat = {"__epoch": np.asarray(epoch)}
    flat.update({f"p.{k}": v for k, v in pflat.items()})
    order = leaf_order(pflat)
    flat["o.0"] = np.asarray(adam["count"], np.int32)
    for i, key in enumerate(order):
        flat[f"o.{1 + i}"] = np.asarray(adam["mu"][key], np.float32)
        flat[f"o.{1 + len(order) + i}"] = np.asarray(adam["nu"][key],
                                                     np.float32)
    for k, v in (extra or {}).items():
        flat[f"x.{k}"] = np.asarray(v)
    np.savez(path, **flat)
    return path


def load_resume_state(model_dir, static=None):
    """(epoch, parameter tree, adam) from `resume_state.npz` (either
    package's), or None when absent; `adam` is {"count": int, "mu": {path:
    array}, "nu": {path: array}}."""
    path = os.path.join(model_dir, "resume_state.npz")
    if not os.path.exists(path):
        return None
    with np.load(path) as data:
        flat = {k: data[k] for k in data.files}
    epoch = int(flat.pop("__epoch"))
    pflat = {k[2:]: v for k, v in flat.items() if k.startswith("p.")}
    params = unflatten(pflat)
    if static:
        params.update(static)
    order = leaf_order(pflat)
    n = len(order)
    if sum(k.startswith("o.") for k in flat) != 1 + 2 * n:
        raise ValueError(f"{path}: the optimizer state is not Adam's over "
                         f"the {n} parameter arrays")
    adam = {"count": int(flat["o.0"]),
            "mu": {k: flat[f"o.{1 + i}"] for i, k in enumerate(order)},
            "nu": {k: flat[f"o.{1 + n + i}"] for i, k in enumerate(order)}}
    return epoch, params, adam


def _static_leaves(kind, y_dim):
    if kind == "dgm":
        return {"y_dim": y_dim}
    if kind == "classifier":
        return {"batch_norm": False}
    return None


def load_model(path_or_dir, kind="vae", y_dim=513, device=None):
    """Load a `.ckpt.npz`, a reference PyTorch `.pt` state dict
    (`models.torch_import`) or, given a directory, its lowest-vloss
    `.ckpt.npz`, as a module on `device` (the GPU unless named). `kind`:
    'vae' | 'dgm' | 'classifier'."""
    device = resolve_device(device)
    path = path_or_dir
    if os.path.isdir(path):
        path = best_checkpoint(path)
        if path is None:
            raise FileNotFoundError(f"no checkpoints in {path_or_dir}")
    if path.endswith(".pt"):
        if kind == "classifier":
            tree = import_classifier(path)
        elif kind == "dgm":
            tree = import_dgm(path, y_dim)
        else:
            tree = import_vae(path)
    else:
        tree = load_params(path, static=_static_leaves(kind, y_dim))
    return module_from_params(tree, device=device)


def load_norm_stats(model_dir):
    """trainset_mean.npy / trainset_std.npy side-cars; (None, None) when
    absent."""
    mean_p = os.path.join(model_dir, "trainset_mean.npy")
    std_p = os.path.join(model_dir, "trainset_std.npy")
    if os.path.exists(mean_p):
        return np.load(mean_p), np.load(std_p)
    return None, None


CLASSIFIER_META_DEFAULTS = {"features": "power", "threshold": 0.5}


def save_classifier_meta(model_dir, meta):
    """Write the classifier's inference protocol, `classifier_meta.json`
    (at least {'features', 'threshold'}, plus provenance such as
    pos_weight), beside its checkpoints; returns its path."""
    os.makedirs(model_dir, exist_ok=True)
    path = os.path.join(model_dir, "classifier_meta.json")
    with open(path, "w") as f:
        json.dump(meta, f, indent=1, sort_keys=True)
    return path


def load_classifier_meta(model_dir):
    """classifier_meta.json merged over the reference-protocol defaults
    ({'features': 'power', 'threshold': 0.5})."""
    meta = dict(CLASSIFIER_META_DEFAULTS)
    path = os.path.join(model_dir, "classifier_meta.json")
    if os.path.exists(path):
        with open(path) as f:
            meta.update(json.load(f))
    return meta
