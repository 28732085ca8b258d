"""Clean-speech training frame store (reference scripts/create_train_set.py).

Usage: python -m guided_vae_nmf_torch.scripts.create_train_set
       [--dataset_size subset] [--data_root data]
       [--labels labels|vad_labels] [--quantile_fraction 0.999]
"""

import os
import sys

from ..config import PathsConfig, apply_overrides
from ..data import create_clean_frames
from ._common import flag


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    paths, rest = apply_overrides(PathsConfig(), argv)
    labels = flag(rest, "labels", "labels")
    quantile_fraction = flag(rest, "quantile_fraction", 0.999, float)

    out = paths.h5_path(labels)
    os.makedirs(os.path.dirname(out), exist_ok=True)
    create_clean_frames(
        paths.input_speech_dir, out,
        dataset_types=("train", "validation"), labels=labels,
        quantile_fraction=quantile_fraction,
    )
    print(f"wrote {out}")
    return out


if __name__ == "__main__":
    main()
