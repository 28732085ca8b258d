"""Train the guided M2 VAE on noisy frames with oracle labels (reference
scripts/training_M2.py).

Usage: python -m guided_vae_nmf_torch.scripts.training_M2
       [--dataset_size subset] [--data_root data]
       [--labels noisy_labels|noisy_vad_labels] [--z_dim 32]
       [--h_dim 128,128] [--end_epoch 200] [--batch_size 128]
       [--learning_rate 1e-3] [--seed 0] [--resume true]
       [--data_parallel 0] [--device cuda|cpu]
"""

import os
import sys

from ..train import train_m2
from . import _train_common as tc
from ._common import flag


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    paths, cfg, resume, dev, mesh, rest = tc.parse(argv, end_epoch=200)
    labels = flag(rest, "labels", "noisy_labels")
    z_dim = flag(rest, "z_dim", 32, int)
    h_dim = tc.h_dim(rest, (128, 128))
    y_dim = 1 if "vad" in labels else 513

    train, valid, _, _ = tc.load_store(paths.h5_path(labels))
    name = (f"M2_hdim_{'_'.join(f'{h:03d}' for h in h_dim)}"
            f"_zdim_{z_dim:03d}_end_epoch_{cfg.end_epoch:03d}")
    model_dir = os.path.join(paths.models_dir, name)
    model, hist = train_m2(
        train, valid, dims=(513, y_dim, z_dim, h_dim), cfg=cfg,
        model_dir=model_dir, name="M2", mesh=mesh, resume=resume,
        verbose=True, device=dev)
    print(f"done; best valid {min(h['valid'] for h in hist):.2f}; "
          f"checkpoints in {model_dir}")
    return model_dir


if __name__ == "__main__":
    main()
