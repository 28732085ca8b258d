"""Parameter trees <-> the port's modules.

A parameter tree is what the JAX package's `train/checkpoints.load_params`
returns and what :func:`guided_vae_nmf_torch.train.checkpoints.load_params`
reads from the same `.ckpt.npz` files: nested dicts and lists of arrays
(numpy or anything `np.asarray` accepts), Linear weights stored (in, out),
plus the static leaves `y_dim` (M2, the two-class classifier) and
`batch_norm` (classifiers).
"""

import re

import numpy as np
import torch

from .nets import DGM, VAE, Classifier, Classifier2, Decoder, Encoder


def _flatten(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}."))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}."))
    elif hasattr(tree, "shape"):
        out[prefix[:-1]] = tree
    return out          # bool / int static leaves carry no tensor


def unflatten(flat):
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


def leaf_order(paths):
    """Dotted leaf paths in the JAX package's tree-flatten order: dict keys
    sorted, list items by index. optax's state lists its leaves in this
    order."""
    return sorted(paths, key=lambda p: tuple(
        int(c) if c.isdigit() else c for c in p.split(".")))


# static leaves, also when a tree map turned them into 0-d arrays
STATIC = ("y_dim", "batch_norm")


def _widths(layers):
    return [int(np.shape(layer["w"])[1]) for layer in layers]


def module_from_params(tree, device="cpu", kind=None):
    """Build the module a parameter tree describes and copy its arrays in:
    `encoder`/`decoder` trees give a :class:`DGM` when `y_dim` is present
    and positive, else a :class:`VAE`; an encoder's own tree
    (`hidden`/`mu`/`log_var`, `encoder_init`'s) an :class:`Encoder`;
    `hidden`/`out` trees give a :class:`Classifier` (with BatchNorm when a
    `bn` subtree exists), or a :class:`Classifier2` when `y_dim` is present,
    or, with kind="decoder", a :class:`Decoder` (`decoder_init`'s tree,
    which has a classifier's keys)."""
    if kind not in (None, "decoder"):
        raise ValueError(f"kind must be None or 'decoder', got {kind!r}")
    if kind == "decoder":
        model = Decoder(int(np.shape(tree["hidden"][0]["w"])[0]),
                        _widths(tree["hidden"]),
                        int(np.shape(tree["out"]["w"])[1]))
    elif "mu" in tree and "log_var" in tree:
        model = Encoder(int(np.shape(tree["hidden"][0]["w"])[0]),
                        _widths(tree["hidden"]),
                        int(np.shape(tree["mu"]["w"])[1]))
    elif "encoder" in tree:
        enc = tree["encoder"]
        x_in = int(np.shape(enc["hidden"][0]["w"])[0])
        h_dim = _widths(enc["hidden"])
        z_dim = int(np.shape(enc["mu"]["w"])[1])
        y_dim = int(tree.get("y_dim", 0) or 0)
        if y_dim:
            model = DGM([x_in - y_dim, y_dim, z_dim, h_dim])
        else:
            model = VAE([x_in, z_dim, h_dim])
    elif "hidden" in tree and "out" in tree:
        x_in = int(np.shape(tree["hidden"][0]["w"])[0])
        y_dim = int(np.shape(tree["out"]["w"])[1])
        y2 = int(tree.get("y_dim", 0) or 0)
        cls = Classifier2 if y2 else Classifier
        model = cls([x_in, _widths(tree["hidden"]), y2 or y_dim],
                    batch_norm="bn" in tree)
    else:
        raise ValueError(f"unrecognised parameter tree: {sorted(tree)}")
    state = {k: torch.tensor(np.asarray(v, np.float32))
             for k, v in _flatten(tree).items() if k not in STATIC}
    model.load_state_dict(state, strict=True)
    return model.to(device).eval()


def params_from_module(model):
    """The JAX package's parameter tree of `model`: float32 numpy arrays
    (Linear weights (in, out), BatchNorm's scale / bias / mean / var under
    `bn`) and the static leaves `y_dim` (M2, two-class classifier) and
    `batch_norm` (classifiers). What the port's checkpoints write."""
    tree = unflatten({k: v.detach().cpu().numpy().copy()
                      for k, v in model.state_dict().items()})
    tree.update(static_leaves(model))
    return tree


def static_leaves(model):
    """The static leaves of `model`'s parameter tree."""
    if isinstance(model, Classifier):
        out = {"batch_norm": model.batch_norm}
        if isinstance(model, Classifier2):
            out["y_dim"] = model.y_dim
        return out
    return {"y_dim": model.y_dim} if isinstance(model, DGM) else {}
