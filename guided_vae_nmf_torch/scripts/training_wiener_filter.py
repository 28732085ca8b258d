"""Train the Wiener-mask DNN baseline (reference
scripts/training_wiener_filter.py: 5x128 hidden, mask-MSE loss).

Usage: python -m guided_vae_nmf_torch.scripts.training_wiener_filter
       [--dataset_size subset] [--data_root data] [--end_epoch 100]
       [--batch_size 128] [--learning_rate 1e-3] [--seed 0]
       [--resume true] [--data_parallel 0] [--device cuda|cpu]
"""

import os
import sys

from ..train import train_wiener
from . import _train_common as tc


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    paths, cfg, resume, dev, mesh, rest = tc.parse(argv, end_epoch=100)

    train, valid, mean, std = tc.load_store(
        paths.h5_path("noisy_wiener_labels"), standardize=True)
    name = f"Wiener_hdim_5x128_end_epoch_{cfg.end_epoch:03d}"
    model_dir = os.path.join(paths.models_dir, name)
    model, hist = train_wiener(
        train, valid, dims=(513, (128,) * 5, 513), cfg=cfg,
        model_dir=model_dir, name="Wiener", mean=mean, std=std,
        mesh=mesh, resume=resume, verbose=True, device=dev)
    print(f"done; best valid mask-MSE {min(h['valid'] for h in hist):.4f}; "
          f"checkpoints in {model_dir}")
    return model_dir


if __name__ == "__main__":
    main()
