"""Live-stream enhancement demo (counterpart of the JAX package's
examples/demo_streaming.py): feed a test mixture to the streaming
Wiener-DNN enhancer in 100 ms chunks, as a real-time caller would, and
report the per-chunk latency and the SI-SDR improvement.

Usage: python -m guided_vae_nmf_torch.examples.demo_streaming
       [--data_root data/subset] [--device cuda|cpu]
       [--artifacts artifacts/pretrained]
"""

import os
import sys
import time

import numpy as np
from scipy.signal import lfilter

from ..data import read_wav, speech_list
from ..metrics import energy_ratios
from ..streaming import StreamingWienerEnhancer
from ..train import load_model, load_norm_stats
from ._args import device, parser

FS = 16000
CHUNK = FS // 10  # 100 ms


def mixture(data_root):
    """A matched-noise mixture (the model's training domain): the first
    clean test utterance and low-pass synthetic noise at 0 dB. Returns
    (relative path, x, s, n) as float32."""
    raw = os.path.join(data_root, "raw") + "/"
    rel = speech_list(raw, "test")[0]
    s, _ = read_wav(os.path.join(raw, rel))
    s = s[int(0.1 * FS):] / np.max(np.abs(s))
    rng = np.random.RandomState(0)
    n = lfilter([1], [1, -0.9], rng.randn(len(s))).astype(np.float64)
    n *= np.sqrt(np.sum(s**2) / np.sum(n**2))
    peak = np.max(np.abs(s + n)) * 1.01
    s, n = (s / peak).astype(np.float32), (n / peak).astype(np.float32)
    return rel, s + n, s, n


def main(argv=None):
    args = parser(__doc__).parse_args(sys.argv[1:] if argv is None else argv)
    dev = device(args)
    wdir = os.path.join(args.artifacts, "wiener")
    w = load_model(wdir, kind="classifier", device=dev)
    mean, std = load_norm_stats(wdir)
    rel, x, s, n = mixture(args.data_root)

    enh = StreamingWienerEnhancer(w, mean=mean, std=std, device=dev)
    enh.push(x[:CHUNK])  # the first push allocates outside the loop

    enh.reset()
    out, lat = [], []
    for lo in range(0, len(x), CHUNK):
        t0 = time.perf_counter()
        out.append(enh.push(x[lo:lo + CHUNK]))
        lat.append(time.perf_counter() - t0)
    out.append(enh.flush())
    s_hat = np.concatenate(out)

    L = min(len(s_hat), len(s))
    before = energy_ratios(x[:L], s[:L], n[:L])[0]
    after = energy_ratios(s_hat[:L], s[:L], n[:L])[0]
    print(f"chunks: {len(lat)} x 100 ms | per-chunk compute "
          f"p50 {np.percentile(lat, 50)*1e3:.1f} ms / "
          f"p99 {np.percentile(lat, 99)*1e3:.1f} ms "
          f"(budget 100 ms) | algorithmic latency 64 ms")
    print(f"SI-SDR {before:.1f} -> {after:.1f} dB "
          f"({os.path.basename(rel)}, streaming Wiener-DNN)")
    return {"s_hat": s_hat, "latency_s": lat, "si_sdr": (before, after)}


if __name__ == "__main__":
    main()
