"""Reading `.ckpt.npz` checkpoints and their side-cars.

Counterpart of the loading half of `guided_vae_nmf_tpu/train/checkpoints.py`.
Files are `<model_dir>/<name>_epoch_{e:03d}_vloss_{v:.2f}.ckpt.npz`: a flat
npz mapping dotted tree paths (`encoder.hidden.0.w`) to arrays, Linear
weights stored (in, out). Both packages read the same files.
"""

import json
import os
import re
from glob import glob

import numpy as np

from .._device import resolve_device
from ..models.convert import module_from_params


def _unflatten(flat):
    """Dotted keys -> nested dicts, with all-digit key sets turned into
    lists; leaves stay numpy arrays."""
    tree = {}
    for key, val in flat.items():
        parts = key.split(".")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val

    def fix(node):
        if isinstance(node, dict):
            keys = list(node.keys())
            if keys and all(re.fullmatch(r"\d+", k) for k in keys):
                return [fix(node[str(i)]) for i in range(len(keys))]
            return {k: fix(v) for k, v in node.items()}
        return np.asarray(node)

    return fix(tree)


def load_params(path, static=None):
    """Load a parameter tree; `static` re-attaches non-array leaves (e.g.
    {'batch_norm': False, 'y_dim': 513})."""
    with np.load(path) as data:
        flat = {k: data[k] for k in data.files}
    tree = _unflatten(flat)
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


def _static_leaves(kind, y_dim):
    if kind == "dgm":
        return {"y_dim": y_dim}
    if kind == "classifier":
        return {"batch_norm": False}
    return None


def load_model(path_or_dir, kind="vae", y_dim=513, device=None):
    """Load a `.ckpt.npz` (or, given a directory, its lowest-vloss
    checkpoint) as a module on `device` (the GPU unless named). `kind`:
    'vae' | 'dgm' | 'classifier'."""
    device = resolve_device(device)
    path = path_or_dir
    if os.path.isdir(path):
        path = best_checkpoint(path)
        if path is None:
            raise FileNotFoundError(f"no checkpoints in {path_or_dir}")
    if path.endswith(".pt"):
        raise NotImplementedError(
            "reference .pt import is not ported yet (ROADMAP Queue 1, "
            "item 6); convert it with the JAX package to .ckpt.npz")
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


def load_classifier_meta(model_dir):
    """classifier_meta.json merged over the reference-protocol defaults
    ({'features': 'power', 'threshold': 0.5})."""
    meta = dict(CLASSIFIER_META_DEFAULTS)
    path = os.path.join(model_dir, "classifier_meta.json")
    if os.path.exists(path):
        with open(path) as f:
            meta.update(json.load(f))
    return meta
