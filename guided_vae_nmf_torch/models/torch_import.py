"""Reference PyTorch checkpoints <-> the port's parameter trees.

Counterpart of `guided_vae_nmf_tpu/models/torch_import.py`. The reference
saves `model.state_dict()` every epoch under names like
`M1_epoch_{e:03d}_vloss_{v:.2f}.pt` (reference scripts/training_M1.py:
143-145), with Linear weights stored (out, in). This module maps those
state dicts onto the parameter trees (weights (in, out), numpy arrays)
that :func:`..models.convert.module_from_params` builds modules from, and
back; `train.checkpoints.load_model` reads `.pt` files through it.
"""

import numpy as np
import torch

from .convert import params_from_module


def _np(v):
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def _t(w):
    """torch Linear stores weight (out, in); the trees store (in, out)."""
    return np.ascontiguousarray(_np(w).T)


def _load_state_dict(path_or_dict):
    """A state dict given as a dict or as a `.pt` path, as numpy arrays.
    A path loads with `weights_only=True`: a checkpoint holds tensors, and
    nothing else in a file from elsewhere gets unpickled."""
    if isinstance(path_or_dict, dict):
        sd = path_or_dict
    else:
        sd = torch.load(path_or_dict, map_location="cpu", weights_only=True)
    return {k: _np(v) for k, v in sd.items()}


def _mlp_from(sd, prefix, n_layers):
    return [
        {"w": _t(sd[f"{prefix}.{i}.weight"]),
         "b": np.asarray(sd[f"{prefix}.{i}.bias"])}
        for i in range(n_layers)
    ]


def _count_layers(sd, prefix):
    n = 0
    while f"{prefix}.{n}.weight" in sd:
        n += 1
    return n


def import_vae(path_or_dict):
    """Map a VariationalAutoencoder / DeepGenerativeModel state dict (keys
    encoder.hidden.N.*, encoder.sample.{mu,log_var}.*, decoder.hidden.N.*,
    decoder.reconstruction.*; reference models.py:90-133, 184-198) onto a
    vae / dgm parameter tree. An M2 checkpoint's tree becomes a DGM once
    `y_dim` is attached (:func:`import_dgm`)."""
    sd = _load_state_dict(path_or_dict)
    return {
        "encoder": {
            "hidden": _mlp_from(sd, "encoder.hidden",
                                _count_layers(sd, "encoder.hidden")),
            "mu": {
                "w": _t(sd["encoder.sample.mu.weight"]),
                "b": np.asarray(sd["encoder.sample.mu.bias"]),
            },
            "log_var": {
                "w": _t(sd["encoder.sample.log_var.weight"]),
                "b": np.asarray(sd["encoder.sample.log_var.bias"]),
            },
        },
        "decoder": {
            "hidden": _mlp_from(sd, "decoder.hidden",
                                _count_layers(sd, "decoder.hidden")),
            "out": {
                "w": _t(sd["decoder.reconstruction.weight"]),
                "b": np.asarray(sd["decoder.reconstruction.bias"]),
            },
        },
    }


def import_dgm(path_or_dict, y_dim):
    """Import an M2 checkpoint and record its label dimensionality."""
    params = import_vae(path_or_dict)
    params["y_dim"] = y_dim
    return params


def import_classifier(path_or_dict):
    """Map a Classifier state dict (hidden.N.*, output_layer.*; reference
    models.py:41-62) onto a classifier parameter tree."""
    sd = _load_state_dict(path_or_dict)
    return {
        "hidden": _mlp_from(sd, "hidden", _count_layers(sd, "hidden")),
        "out": {
            "w": _t(sd["output_layer.weight"]),
            "b": np.asarray(sd["output_layer.bias"]),
        },
        "batch_norm": False,
    }


def export_vae(params):
    """Inverse of :func:`import_vae`: a vae / dgm parameter tree (or a
    module, through `params_from_module`) -> a state dict of numpy arrays
    in the reference's key naming."""
    if isinstance(params, torch.nn.Module):
        params = params_from_module(params)
    enc, dec = params["encoder"], params["decoder"]
    sd = {}
    for i, layer in enumerate(enc["hidden"]):
        sd[f"encoder.hidden.{i}.weight"] = _t(layer["w"])
        sd[f"encoder.hidden.{i}.bias"] = _np(layer["b"])
    sd["encoder.sample.mu.weight"] = _t(enc["mu"]["w"])
    sd["encoder.sample.mu.bias"] = _np(enc["mu"]["b"])
    sd["encoder.sample.log_var.weight"] = _t(enc["log_var"]["w"])
    sd["encoder.sample.log_var.bias"] = _np(enc["log_var"]["b"])
    for i, layer in enumerate(dec["hidden"]):
        sd[f"decoder.hidden.{i}.weight"] = _t(layer["w"])
        sd[f"decoder.hidden.{i}.bias"] = _np(layer["b"])
    sd["decoder.reconstruction.weight"] = _t(dec["out"]["w"])
    sd["decoder.reconstruction.bias"] = _np(dec["out"]["b"])
    return sd


def record_reference_stream(seed, F, N, L, cfg):
    """Replay torch's global-RNG stream for one reference MCEM_M2 / M1 run.

    Seeding torch with `seed` and drawing in the reference engine's
    consumption order (mcem.py: init_parameters rand(F, K), rand(K, N);
    then niter E-chains of nsamples + burnin x [randn(L, N), rand(N)]
    (mcem.py:257, 271); then one WF chain of nsamples_WF + burnin_WF
    steps) gives the values a reference run launched from the same
    `torch.manual_seed(seed)` consumes: the fixed randomness of
    `mcem.engine.mcem_run(noise=..., init_nmf=...)`. Reseeds torch's
    global generator.

    Returns (W0, H0, g0, (Zn_E, U_E, Zn_WF, U_WF)) as numpy arrays.
    """
    torch.manual_seed(seed)
    K = cfg.nmf_rank
    W0 = np.maximum(torch.rand(F, K).numpy(), cfg.eps)
    H0 = np.maximum(torch.rand(K, N).numpy(), cfg.eps)
    g0 = np.ones((N,), np.float32)
    # init_parameters' Z0 = encoder(...) consumes one randn(N, L) in
    # GaussianSample.reparametrize (models.py:8-14) though only mu is kept
    torch.randn(N, L)

    def chain(steps):
        zn = np.empty((steps, L, N), np.float32)
        u = np.empty((steps, N), np.float32)
        for m in range(steps):  # call by call: torch's normal cache and
            # the randn / rand interleaving make one batched draw another
            # stream than the reference's per-step calls
            zn[m] = torch.randn(L, N).numpy()
            u[m] = torch.rand(N).numpy()
        return zn, u

    s_e = cfg.nsamples_E_step + cfg.burnin_E_step
    zn_e = np.empty((cfg.niter, s_e, L, N), np.float32)
    u_e = np.empty((cfg.niter, s_e, N), np.float32)
    for n in range(cfg.niter):
        zn_e[n], u_e[n] = chain(s_e)
    zn_wf, u_wf = chain(cfg.nsamples_WF + cfg.burnin_WF)
    return W0, H0, g0, (zn_e, u_e, zn_wf, u_wf)
