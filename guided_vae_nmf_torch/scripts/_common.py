"""Shared helpers of the port's scripts (counterpart of the JAX package's
`scripts/_common.py`). Its `pin_platform` has no counterpart: a script takes
`--device` instead (:func:`device`)."""

import sys

from ..train import load_model, load_norm_stats  # noqa: F401  (re-exported)


def backend_info():
    """Device provenance for a bench's JSON line: torch's version, the
    card's name, power limit and the device count."""
    import torch

    from ..cli import nvidia_smi

    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    smi = nvidia_smi(60)
    return {
        "backend": "cuda" if n else "cpu",
        "torch": torch.__version__,
        "device": torch.cuda.get_device_name(0) if n else "cpu",
        "power_limit": (smi.splitlines()[0].split(",")[-1].strip()
                        if smi else None),
        "n_devices": n,
    }


def flag(rest, name, default=None, cast=str):
    if "--help" in rest or "-h" in rest:
        # the help surface of the flag()-parsed scripts: the script's
        # module docstring
        main_mod = sys.modules.get("__main__")
        doc = (getattr(main_mod, "__doc__", None) or "").strip()
        print(doc or "usage: see --flags in the script source")
        raise SystemExit(0)
    key = f"--{name}"
    if key in rest:
        return cast(rest[rest.index(key) + 1])
    return default


def device(rest):
    """The torch device named by `--device` (the GPU when absent; raises
    without one)."""
    from .._device import resolve_device

    return resolve_device(flag(rest, "device"))


def data_parallel(rest):
    """The mesh of `--data_parallel 1` (`parallel.data_parallel_mesh`:
    every visible card, raising without one, or the one `--device`), or
    None."""
    if flag(rest, "data_parallel", "0") not in ("1", "true"):
        return None
    from ..parallel import data_parallel_mesh

    return data_parallel_mesh(flag(rest, "device"))


def engine_config(rest):
    """(cfg, rest) from `--algorithm mcem|peem|hybrid`, parsed first, so
    that exactly one config class takes the shared flags (--niter,
    --noise_gain, ...)."""
    from ..config import MCEMConfig, apply_overrides
    from ..mcem import HybridConfig, PEEMConfig

    algo = flag(rest, "algorithm", "mcem")
    if algo == "hybrid":
        return apply_overrides(HybridConfig(), rest)
    if algo == "peem":
        return apply_overrides(PEEMConfig(), rest)
    return apply_overrides(MCEMConfig(), rest)
