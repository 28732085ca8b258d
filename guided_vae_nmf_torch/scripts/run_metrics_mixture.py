"""No-processing floor: metrics of the raw mixtures against clean speech
(reference scripts/run_metrics_mixture.py).

Usage: python -m guided_vae_nmf_torch.scripts.run_metrics_mixture
       [--dataset_size subset] [--data_root data]
"""

import sys

from ..config import PathsConfig, apply_overrides
from ..metrics import run_metrics


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    paths, rest = apply_overrides(PathsConfig(), argv)
    return run_metrics(paths.input_speech_dir, paths.processed_wav_dir,
                       est_dir=None, mixture_floor=True)


if __name__ == "__main__":
    main()
