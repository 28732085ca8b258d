"""Metrics for M1-enhanced outputs (reference scripts/run_metrics_M1.py):
SI-SDR / SIR / SAR, ESTOI and PESQ-wb, 95 % confidence intervals overall
and per input SNR, and POLQA where its proprietary backend is importable.
The metrics are numpy: the sweep's spawn pool never opens the GPU.

Usage: python -m guided_vae_nmf_torch.scripts.run_metrics_M1
       --est_dir <enhanced-dir> [--dataset_size subset] [--data_root data]
       [--save_json true] [--polqa true]
"""

import sys

from ..config import PathsConfig, apply_overrides
from ..metrics import run_metrics
from ._common import flag


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    paths, rest = apply_overrides(PathsConfig(), argv)
    est_dir = flag(rest, "est_dir", paths.models_dir + "M1_enhanced/")
    save_json = flag(rest, "save_json", "false") in ("1", "true")
    figures = flag(rest, "figures", "false") in ("1", "true")
    out = run_metrics(paths.input_speech_dir, paths.processed_wav_dir,
                      est_dir, with_f1=False, save_json=save_json,
                      make_figures=figures)
    if flag(rest, "polqa", "false") in ("1", "true"):
        from ..metrics import run_polqa

        run_polqa(paths.input_speech_dir, paths.processed_wav_dir, est_dir)
    return out


if __name__ == "__main__":
    main()
