"""Optional POLQA evaluation (ITU-T P.863).

Capability parity with the reference's `main_polqa` path
(scripts/run_metrics_M1.py:178-259): POLQA is a proprietary licensed
metric reachable only through the `uhh_sp.evaluation` package; when that
package is importable the sweep runs batched POLQA with the reference's
3-second zero-padding workaround for short files and aggregates with
`compute_stats_noisnr`; otherwise `HAS_POLQA` is False and callers skip.

The port's own copy of `guided_vae_nmf_tpu/metrics/polqa.py`.
"""

import os

import numpy as np

try:  # pragma: no cover - proprietary, typically absent
    from uhh_sp.evaluation import polqa as _polqa

    HAS_POLQA = True
except ImportError:  # pragma: no cover
    _polqa = None
    HAS_POLQA = False

from ..data import read_wav, speech_list
from .stats import compute_stats_noisnr

FS = 16000
MIN_SEC = 3.0  # POLQA needs >= 3 s of signal (reference workaround)


def _pad_min(x, fs=FS, min_sec=MIN_SEC):
    need = int(min_sec * fs) - len(x)
    if need > 0:
        x = np.concatenate([x, np.zeros(need)])
    return x


def run_polqa(input_speech_dir, processed_dir, est_dir, dataset_type="test",
              confidence=0.95, save_json=True):
    """POLQA MOS for every (clean, enhanced) pair; returns the stats dict
    or None when the proprietary backend is unavailable."""
    if not HAS_POLQA:
        print("POLQA backend (uhh_sp.evaluation) not available; skipping")
        return None

    files = speech_list(input_speech_dir, dataset_type)
    refs, tests = [], []
    for path in files:
        base_p = os.path.join(processed_dir, os.path.splitext(path)[0])
        base_e = os.path.join(est_dir, os.path.splitext(path)[0])
        s, _ = read_wav(base_p + "_s.wav")
        s_hat, _ = read_wav(base_e + "_s_est.wav")
        refs.append(_pad_min(s))
        tests.append(_pad_min(s_hat))

    scores = _polqa(refs, tests, FS)  # pragma: no cover
    rows = [(float(v),) for v in scores]
    return compute_stats_noisnr(["POLQA"], rows, est_dir,
                                confidence=confidence, save_json=save_json)
