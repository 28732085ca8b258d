"""The models' forward passes from the shipped `.npz` checkpoints: the
tanh encoder (mu head), the tanh decoder with its exp output (a
variance), and the ReLU classifier with its sigmoid output."""

import os

import numpy as np
import torch

from .precision import cast, mm


def load_npz(model_dir):
    """The arrays of the checkpoint with the lowest validation loss in
    `model_dir` (`<name>_vloss_<loss>.ckpt.npz`)."""
    names = [n for n in os.listdir(model_dir) if n.endswith(".ckpt.npz")]
    if not names:
        raise FileNotFoundError(f"no .ckpt.npz in {model_dir}")

    def loss(n):
        return float(n.split("_vloss_")[1][: -len(".ckpt.npz")])

    with np.load(os.path.join(model_dir, min(names, key=loss))) as z:
        return {k: z[k] for k in z.files}


class Params:
    """One checkpoint's arrays as tensors of one precision on a device."""

    def __init__(self, arrays, prec, device):
        self.prec = prec
        self.t = {k: cast(v, prec).to(device) for k, v in arrays.items()}

    def layers(self, prefix):
        i, out = 0, []
        while f"{prefix}.{i}.w" in self.t:
            out.append((self.t[f"{prefix}.{i}.w"], self.t[f"{prefix}.{i}.b"]))
            i += 1
        return out

    def linear(self, name, h):
        return mm(h, self.t[name + ".w"], self.prec) + self.t[name + ".b"]


def encoder_mu(p, x):
    h = x
    for w, b in p.layers("encoder.hidden"):
        h = torch.tanh(mm(h, w, p.prec) + b)
    return p.linear("encoder.mu", h)


def label_term(p, y, z_dim):
    """The decoder's first layer on the labels plus its bias: y (..., y_dim)
    -> (..., H1); with y None (M1) the bias alone."""
    w, b = p.layers("decoder.hidden")[0]
    if y is None:
        return b
    return mm(y, w[z_dim:], p.prec) + b


def decode(p, z, ypre):
    """exp of the decoder's output from z (..., L) and the label term."""
    layers = p.layers("decoder.hidden")
    w1 = layers[0][0][: z.shape[-1]]
    h = torch.tanh(mm(z, w1, p.prec) + ypre)
    for w, b in layers[1:]:
        h = torch.tanh(mm(h, w, p.prec) + b)
    return torch.exp(p.linear("decoder.out", h))


def classifier(p, x):
    h = x
    for w, b in p.layers("hidden"):
        h = torch.relu(mm(h, w, p.prec) + b)
    return torch.sigmoid(p.linear("out", h))


def z_dim(arrays):
    return arrays["encoder.mu.w"].shape[1]
