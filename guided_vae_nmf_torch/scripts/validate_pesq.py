"""Conformance check of the port's first-party PESQ against the ITU C
extension (counterpart of the JAX package's scripts/validate_pesq.py).

Where the `pesq` wheel is not importable there is nothing to compare
against, and the script says so and exits 0; run it in any environment
that has the wheel to get per-utterance MOS-LQO deltas on a data root's
test mixtures (reference protocol: run_metrics_M1.py:76-84). Exits
non-zero if the mean |delta| exceeds the threshold.

Usage: python -m guided_vae_nmf_torch.scripts.validate_pesq
       [--data_root data/subset] [--threshold 0.1]

--data_root is the subset directory itself (its raw/ and processed/).
"""

import argparse
import os
import sys

import numpy as np

from ..data import read_wav, speech_list
from ..metrics.pesq import pesq as pesq_fp


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--data_root", default="data/subset")
    ap.add_argument("--threshold", type=float, default=0.1)
    args = ap.parse_args(argv)

    try:
        from pesq import pesq as pesq_itu
    except ImportError:
        print("pesq wheel not importable in this environment; nothing to "
              "validate (the first-party implementation is the fallback).")
        return 0

    raw = os.path.join(args.data_root, "raw/")
    processed = os.path.join(args.data_root, "processed/")
    deltas = []
    for path in speech_list(raw, "test"):
        base = os.path.join(processed, os.path.splitext(path)[0])
        s, _ = read_wav(base + "_s.wav")
        x, _ = read_wav(base + "_x.wav")
        n = min(len(s), len(x))
        a = pesq_itu(16000, s[:n], x[:n], "wb")
        b = pesq_fp(16000, s[:n], x[:n], "wb")
        deltas.append(b - a)
        print(f"{path}: itu={a:.3f} first-party={b:.3f} delta={b - a:+.3f}")
    deltas = np.asarray(deltas)
    print(f"mean|delta|={np.mean(np.abs(deltas)):.4f} "
          f"max|delta|={np.max(np.abs(deltas)):.4f}")
    return 0 if np.mean(np.abs(deltas)) <= args.threshold else 1


if __name__ == "__main__":
    sys.exit(main())
