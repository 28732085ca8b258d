"""Metrics for the Wiener-DNN baseline's outputs: a serial loop and
stats.json (reference scripts/run_metrics_wiener.py:194-214).

Usage: python -m guided_vae_nmf_torch.scripts.run_metrics_wiener
       --est_dir <enhanced-dir> [--dataset_size subset] [--data_root data]
"""

import sys

from ..config import PathsConfig, apply_overrides
from ..metrics import run_metrics
from ._common import flag


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    paths, rest = apply_overrides(PathsConfig(), argv)
    est_dir = flag(rest, "est_dir", paths.models_dir + "wiener_enhanced/")
    return run_metrics(paths.input_speech_dir, paths.processed_wav_dir,
                       est_dir, with_f1=False, save_json=True, serial=True)


if __name__ == "__main__":
    main()
