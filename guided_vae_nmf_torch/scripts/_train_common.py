"""Shared parsing of the training scripts: the path and TrainConfig
overrides, `--resume`, `--data_parallel` (the batch's rows over a mesh,
`_common.data_parallel`) and `--device`."""

from ..config import PathsConfig, TrainConfig, apply_overrides
from ..data.h5io import H5FrameReader
from ._common import data_parallel, device, flag


def parse(argv, end_epoch):
    """(paths, cfg, resume, device, mesh, rest) of a training script."""
    paths, rest = apply_overrides(PathsConfig(), argv)
    cfg, rest = apply_overrides(TrainConfig(end_epoch=end_epoch), rest)
    resume = flag(rest, "resume", "0") in ("1", "true")
    mesh = data_parallel(rest)
    return paths, cfg, resume, device(rest), mesh, rest


def h_dim(rest, default):
    return flag(rest, "h_dim", default,
                lambda v: tuple(int(h) for h in v.split(",")))


def load_store(h5, standardize=False, eps=1e-8):
    """(Xtr, Ytr), (Xva, Yva), mean, std of an H5 frame store; with
    `standardize`, X in units of the train set's mean / std (reference
    training_classifier.py:97-108)."""
    rtr = H5FrameReader(h5, "train")
    Xtr, Ytr = rtr.load_all()
    mean = rtr.mean[:, 0] if rtr.mean is not None else Xtr.mean(0)
    std = rtr.std[:, 0] if rtr.std is not None else Xtr.std(0)
    rva = H5FrameReader(h5, "validation")
    Xva, Yva = rva.load_all()
    rtr.close()
    rva.close()
    if standardize:
        Xtr = ((Xtr - mean) / (std + eps)).astype("float32")
        Xva = ((Xva - mean) / (std + eps)).astype("float32")
    return (Xtr, Ytr), (Xva, Yva), mean, std
