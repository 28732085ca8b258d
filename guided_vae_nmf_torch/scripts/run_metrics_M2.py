"""Metrics for M2-enhanced outputs, with mask F1 against the oracle label
(reference scripts/run_metrics_M2.py:102-244). The metrics are numpy: the
sweep's spawn pool never opens the GPU.

Usage: python -m guided_vae_nmf_torch.scripts.run_metrics_M2
       --est_dir <enhanced-dir> [--target ibm|vad] [--dataset_size subset]
       [--data_root data] [--save_json true]
"""

import sys

from ..config import PathsConfig, apply_overrides
from ..metrics import run_metrics
from ._common import flag


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    paths, rest = apply_overrides(PathsConfig(), argv)
    est_dir = flag(rest, "est_dir",
                   paths.models_dir + "M2_ibm_dnn_enhanced/")
    target = flag(rest, "target", "ibm")
    save_json = flag(rest, "save_json", "false") in ("1", "true")
    figures = flag(rest, "figures", "false") in ("1", "true")
    return run_metrics(paths.input_speech_dir, paths.processed_wav_dir,
                       est_dir, with_f1=True, target=target,
                       save_json=save_json, make_figures=figures)


if __name__ == "__main__":
    main()
