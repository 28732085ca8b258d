"""The system under test, set up from a configuration file: the port's
kernels built (into its fixed build directory inside the checkout), its
models and the classifier loaded from the shipped checkpoints, and its
MCEM settings."""

import time
from types import SimpleNamespace


def setup(root, config, device):
    import torch
    from guided_vae_nmf_torch import _build
    from guided_vae_nmf_torch.mcem import MCEMConfig
    from guided_vae_nmf_torch.train.checkpoints import (load_model,
                                                        load_norm_stats)

    dev = torch.device(device)
    t0 = time.perf_counter()
    if dev.type == "cuda":
        _build.build_all()
    build_s = time.perf_counter() - t0
    m = config["model"]
    model = load_model(str(root / m["dir"]), kind=m["kind"],
                       y_dim=m.get("y_dim", 513), device=dev)
    cls = mean = std = None
    c = config.get("classifier")
    if c:
        cls = load_model(str(root / c["dir"]), kind="classifier",
                         device=dev)
        mean, std = load_norm_stats(str(root / c["dir"]))
    return SimpleNamespace(
        dev=dev, model=model, classifier=cls, mean=mean, std=std,
        cfg=MCEMConfig(**config["mcem"]), build_s=build_s, config=config,
        label_mode=config["label_mode"], shapes=shapes(config))


def shapes(config):
    m = config["model"]
    F, L, ws = m["x_dim"], m["z_dim"], list(m["h_dim"])
    y = m.get("y_dim", 0) if m["kind"] == "dgm" else 0
    out = {"F": F, "L": L, "ws": ws, "enc": [F + y] + ws, "cls": None}
    c = config.get("classifier")
    if c:
        out["cls"] = [F] + list(c["h_dim"]) + [c["y_dim"]]
    return out


def entry_kwargs(env, noise_model):
    """enhance_waveform's arguments besides the batch, as the sweep of
    `pipeline.enhance_files` passes them."""
    dnn = env.label_mode == "dnn"
    c = env.config.get("classifier") or {}
    return dict(classifier=env.classifier if dnn else None,
                mean=env.mean if dnn else None, std=env.std if dnn else None,
                label_mode=env.label_mode, noise_model=noise_model,
                return_noise=False, features=c.get("features", "power"),
                dnn_threshold=c.get("threshold", 0.5), device=env.dev)
