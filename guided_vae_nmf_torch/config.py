"""Configuration: the reference's SETTINGS blocks as dataclasses with the
reference's defaults, resolvable from CLI `--key value` overrides.

Counterpart of `guided_vae_nmf_tpu/config.py`: `PathsConfig`, `StftConfig`,
`LabelConfig`, `ModelDims` and :func:`apply_overrides` are the port's own
copies; `MCEMConfig` (`mcem.engine`) and `TrainConfig` (`train.trainer`)
are the port's, re-exported here as the JAX module re-exports its own.
"""

import dataclasses
import os
from dataclasses import dataclass

from .mcem.engine import MCEMConfig
from .train.trainer import TrainConfig


@dataclass
class PathsConfig:
    """Data layout mirroring the reference's `data/<size>/...` tree
    (reference scripts/create_noisy_train_set.py:33-41)."""

    dataset_size: str = "subset"  # 'subset' | 'complete'
    data_root: str = "data"
    speech_dataset_name: str = "CSR-1-WSJ-0"

    @property
    def input_speech_dir(self):
        return os.path.join(self.data_root, self.dataset_size, "raw/")

    @property
    def processed_wav_dir(self):
        return os.path.join(self.data_root, self.dataset_size, "processed/")

    @property
    def pickle_dir(self):
        return os.path.join(self.data_root, self.dataset_size, "pickle/")

    @property
    def export_dir(self):
        return os.path.join(self.data_root, self.dataset_size, "export/")

    @property
    def models_dir(self):
        return os.path.join(self.data_root, self.dataset_size, "models/")

    def h5_path(self, labels):
        return os.path.join(
            self.export_dir, f"{self.speech_dataset_name}_{labels}.h5"
        )


@dataclass
class StftConfig:
    """Frozen STFT contract (reference stft conventions)."""

    fs: int = 16000
    wlen_sec: float = 64e-3
    hop_percent: float = 0.25
    win: str = "hann"
    dtype: str = "complex64"


@dataclass
class LabelConfig:
    quantile_fraction: float = 0.98
    quantile_weight: float = 0.999
    eps: float = 1e-8


@dataclass
class ModelDims:
    """Reference eval dims (scripts/evaluate_M2_ibm.py:48-62)."""

    x_dim: int = 513
    y_dim: int = 513
    z_dim: int = 32
    h_dim: tuple = (128, 128)
    h_dim_cl: tuple = (128, 128)


def apply_overrides(cfg, argv):
    """Apply `--field value` CLI overrides onto a (frozen or mutable)
    dataclass; returns a new instance. Unknown flags are returned for the
    caller.

    `--help`/`-h` anywhere in argv prints the invoking script's module
    docstring (every scripts/*.py CLI documents its usage there) plus the
    overridable fields of `cfg`, then exits 0 — apply_overrides is the
    first parse step of every CLI, so this gives all of them a uniform
    help surface without an argparse dependency.
    """
    if any(a in ("--help", "-h") for a in argv):
        import sys as _sys

        main_mod = _sys.modules.get("__main__")
        doc = (getattr(main_mod, "__doc__", None) or "").strip()
        if doc:
            print(doc)
        print(f"\n{type(cfg).__name__} overrides (--field value):")
        for f in dataclasses.fields(cfg):
            print(f"  --{f.name} (default: {getattr(cfg, f.name)!r})")
        raise SystemExit(0)
    fields = {f.name: f for f in dataclasses.fields(cfg)}
    updates, rest = {}, []
    i = 0
    while i < len(argv):
        arg = argv[i]
        if arg.startswith("--") and arg[2:] in fields and i + 1 < len(argv):
            name = arg[2:]
            raw = argv[i + 1]
            ftype = fields[name].type
            current = getattr(cfg, name)
            if isinstance(current, bool):
                updates[name] = raw.lower() in ("1", "true", "yes")
            elif isinstance(current, int):
                updates[name] = int(raw)
            elif isinstance(current, float):
                updates[name] = float(raw)
            elif isinstance(current, tuple):
                updates[name] = tuple(int(v) for v in raw.split(","))
            else:
                updates[name] = raw
            i += 2
        else:
            rest.append(arg)
            i += 1
    return dataclasses.replace(cfg, **updates), rest


__all__ = [
    "PathsConfig",
    "StftConfig",
    "LabelConfig",
    "ModelDims",
    "MCEMConfig",
    "TrainConfig",
    "apply_overrides",
]
