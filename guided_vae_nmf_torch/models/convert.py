"""Parameter trees -> the port's modules.

A parameter tree is what the JAX package's `train/checkpoints.load_params`
returns and what :func:`guided_vae_nmf_torch.train.checkpoints.load_params`
reads from the same `.ckpt.npz` files: nested dicts and lists of arrays
(numpy or anything `np.asarray` accepts), Linear weights stored (in, out),
plus the static leaves `y_dim` (M2) and `batch_norm` (classifier).
"""

import numpy as np
import torch

from .nets import DGM, VAE, Classifier


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


def _widths(layers):
    return [int(np.shape(layer["w"])[1]) for layer in layers]


def module_from_params(tree, device="cpu"):
    """Build the module a parameter tree describes and copy its arrays in:
    `encoder`/`decoder` trees give a :class:`DGM` when `y_dim` is present
    and positive, else a :class:`VAE`; `hidden`/`out` trees give a
    :class:`Classifier` (with BatchNorm when a `bn` subtree exists)."""
    if "encoder" in tree:
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
        model = Classifier([x_in, _widths(tree["hidden"]), y_dim],
                           batch_norm="bn" in tree)
    else:
        raise ValueError(f"unrecognised parameter tree: {sorted(tree)}")
    state = {k: torch.tensor(np.asarray(v, np.float32))
             for k, v in _flatten(tree).items()}
    model.load_state_dict(state, strict=True)
    return model.to(device).eval()
