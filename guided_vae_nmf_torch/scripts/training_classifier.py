"""Train the supervised IBM/VAD classifier on standardized noisy frames
(reference scripts/training_classifier.py).

Usage: python -m guided_vae_nmf_torch.scripts.training_classifier
       [--dataset_size subset] [--data_root data]
       [--labels noisy_labels|noisy_vad_labels] [--h_dim 128,128]
       [--end_epoch 100] [--batch_size 128] [--learning_rate 1e-3]
       [--seed 0] [--resume true] [--data_parallel 0]
       [--device cuda|cpu]
"""

import os
import sys

from ..train import train_classifier
from . import _train_common as tc
from ._common import flag


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    paths, cfg, resume, dev, mesh, rest = tc.parse(argv, end_epoch=100)
    labels = flag(rest, "labels", "noisy_labels")
    h_dim = tc.h_dim(rest, (128, 128))
    y_dim = 1 if "vad" in labels else 513

    train, valid, mean, std = tc.load_store(paths.h5_path(labels),
                                            standardize=True)
    name = (f"Classifier_hdim_{'_'.join(f'{h:03d}' for h in h_dim)}"
            f"_end_epoch_{cfg.end_epoch:03d}")
    model_dir = os.path.join(paths.models_dir, name)
    model, hist = train_classifier(
        train, valid, dims=(513, h_dim, y_dim), cfg=cfg, model_dir=model_dir,
        name="Classifier", mean=mean, std=std, mesh=mesh, resume=resume,
        verbose=True, device=dev)
    print(f"done; best valid BCE {min(h['valid'] for h in hist):.2f}; "
          f"checkpoints in {model_dir}")
    return model_dir


if __name__ == "__main__":
    main()
