"""Conformance check of the port's first-party STOI / ESTOI (and objective
measures) against the canonical packages, when importable (counterpart of
the JAX package's scripts/validate_stoi.py).

Where `pystoi` is not importable there is nothing to compare against, and
the script says so and exits 0; run it wherever `pystoi` (and `pysepm`) is
installed. The framing and resampler conventions follow pystoi (exclusive
final frame, Octave-style Kaiser anti-aliasing FIR), so the expected ESTOI
delta is < 1e-6.

Usage: python -m guided_vae_nmf_torch.scripts.validate_stoi
       [--data_root data/subset] [--threshold 1e-3]

--data_root is the subset directory itself (its processed/).
"""

import argparse
import glob
import os
import sys

import numpy as np

from ..data import read_wav
from ..metrics.stoi import stoi as stoi_fp


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--data_root", default="data/subset")
    ap.add_argument("--threshold", type=float, default=1e-3)
    args = ap.parse_args(argv)

    try:
        from pystoi import stoi as stoi_canon
    except ImportError:
        print("pystoi not importable in this environment; nothing to "
              "validate (goldens in tests/metrics/test_goldens.py pin "
              "the implementation against drift).")
        return 0

    pattern = os.path.join(args.data_root,
                           "processed/CSR-1-WSJ-0/**/*_x.wav")
    deltas = []
    for path in sorted(glob.glob(pattern, recursive=True)):
        b = path[:-6]
        s, _ = read_wav(b + "_s.wav")
        x, _ = read_wav(b + "_x.wav")
        m = min(len(s), len(x))
        s, x = s[:m], x[:m]
        for ext in (False, True):
            a = stoi_canon(s, x, 16000, extended=ext)
            f = stoi_fp(s, x, 16000, extended=ext)
            deltas.append(f - a)
            name = "ESTOI" if ext else "STOI"
            print(f"{os.path.basename(b)} {name}: canon={a:.6f} "
                  f"first-party={f:.6f} delta={f - a:+.2e}")

    try:
        import pysepm

        from ..metrics.objective import fw_seg_snr, llr, wss

        for path in sorted(glob.glob(pattern, recursive=True))[:3]:
            b = path[:-6]
            s, _ = read_wav(b + "_s.wav")
            x, _ = read_wav(b + "_x.wav")
            m = min(len(s), len(x))
            print(f"{os.path.basename(b)} fwSegSNR: "
                  f"canon={pysepm.fwSNRseg(s[:m], x[:m], 16000):.4f} "
                  f"first-party={fw_seg_snr(s[:m], x[:m], 16000):.4f}")
            print(f"{os.path.basename(b)} LLR: "
                  f"canon={pysepm.llr(s[:m], x[:m], 16000):.4f} "
                  f"first-party={llr(s[:m], x[:m], 16000):.4f}")
            print(f"{os.path.basename(b)} WSS: "
                  f"canon={pysepm.wss(s[:m], x[:m], 16000):.4f} "
                  f"first-party={wss(s[:m], x[:m], 16000):.4f}")
    except ImportError:
        print("(pysepm absent: objective-measure deltas skipped)")

    deltas = np.asarray(deltas)
    print(f"mean|delta|={np.mean(np.abs(deltas)):.2e} "
          f"max|delta|={np.max(np.abs(deltas)):.2e}")
    return 0 if np.max(np.abs(deltas)) <= args.threshold else 1


if __name__ == "__main__":
    sys.exit(main())
