"""Train the M1 VAE on clean-speech frames (reference
scripts/training_M1.py).

Usage: python -m guided_vae_nmf_torch.scripts.training_M1
       [--dataset_size subset] [--data_root data] [--z_dim 16]
       [--h_dim 128] [--end_epoch 200] [--batch_size 128]
       [--learning_rate 1e-3] [--seed 0] [--resume true]
       [--data_parallel 0] [--device cuda|cpu]
"""

import os
import sys

from ..data import read_dataset
from ..train import train_m1
from . import _train_common as tc
from ._common import flag


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    paths, cfg, resume, dev, mesh, rest = tc.parse(argv, end_epoch=200)
    z_dim = flag(rest, "z_dim", 16, int)
    h_dim = tc.h_dim(rest, (128,))

    # frames from the H5 export when present, else the pickle store
    # (reference training_M1.py:46-47)
    h5 = paths.h5_path("labels")
    if os.path.exists(h5):
        (Xtr, _), (Xva, _), _, _ = tc.load_store(h5)
    else:
        Xtr = read_dataset(paths.pickle_dir, "train", "frames").T
        Xva = read_dataset(paths.pickle_dir, "validation", "frames").T

    name = (f"M1_hdim_{h_dim[0]:03d}_zdim_{z_dim:03d}"
            f"_end_epoch_{cfg.end_epoch:03d}")
    model_dir = os.path.join(paths.models_dir, name)
    model, hist = train_m1(
        Xtr, Xva, dims=(513, z_dim, h_dim), cfg=cfg, model_dir=model_dir,
        name="M1", mesh=mesh, resume=resume, verbose=True, device=dev)
    print(f"done; best valid {min(h['valid'] for h in hist):.2f}; "
          f"checkpoints in {model_dir}")
    return model_dir


if __name__ == "__main__":
    main()
