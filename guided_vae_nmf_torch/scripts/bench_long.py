"""Long-recording benchmark (counterpart of the JAX package's
scripts/bench_long.py): ONE continuous recording of --minutes (default 30)
enhanced on one card, the "very long recordings" scenario.

Builds a synthetic mixture by looping the test speech of a data root
(`<data_root>/<dataset_size>/raw/`, the reference layout) against AR(1)
colored noise at 0 dB, runs the full M2 MCEM sweep (oracle IBM labels, fast
mode, niter configurable) on the single file twice (cold, then warm), and
prints a JSON line with the realtime factor and the E-step sample buffer's
size as a bfloat16 dump. The recording's frames go through K1 / K2 in one
launch each a step.

Usage: python -m guided_vae_nmf_torch.scripts.bench_long [--minutes 30]
       [--niter 100] [--work <dir>] [--data_root data]
       [--dataset_size subset] [--device cuda|cpu]

--work defaults to a temporary directory, removed at the end; a given one
is emptied first and kept (`est/` and `est2/` hold the two runs' output).
"""

import json
import os
import shutil
import sys
import tempfile
import time

import numpy as np
from scipy.signal import lfilter

from ..config import PathsConfig, apply_overrides
from ._common import backend_info, device, flag, load_model

FS = 16000
REL = "CSR-1-WSJ-0/WAV/wsj0/si_et_05/440/long000.wav"


def long_mixture(subset, minutes):
    """(x, s) float32: the test speech of `subset` looped to `minutes`,
    plus AR(1) noise at 0 dB, jointly scaled to a peak of 1/1.01."""
    from ..data import read_wav, speech_list

    base = speech_list(os.path.join(subset, "raw") + "/", "test")
    if not base:
        raise SystemExit(f"no test utterances under {subset}/raw/")
    parts = []
    for name in base:
        x, fs = read_wav(os.path.join(subset, "raw", name))
        if fs != FS:
            raise ValueError(f"{name}: {fs} Hz, expected {FS}")
        parts.append(x[int(0.1 * FS):] / np.abs(x).max())
    s = np.concatenate(parts)
    target_len = int(minutes * 60 * FS)
    s = np.tile(s, target_len // len(s) + 1)[:target_len]
    rng = np.random.RandomState(0)
    n = lfilter([1], [1, -0.9], rng.randn(target_len)).astype(np.float64)
    n *= np.sqrt(np.sum(s**2) / np.sum(n**2))  # 0 dB
    x = (s + n).astype(np.float32)
    peak = np.abs(x).max() * 1.01
    return x / peak, (s / peak).astype(np.float32)


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    paths, argv = apply_overrides(PathsConfig(), argv)
    minutes = flag(argv, "minutes", 30, float)
    niter = flag(argv, "niter", 100, int)
    work = flag(argv, "work", None)
    dev = device(argv)

    from ..data import write_wav
    from ..mcem import MCEMConfig
    from ..pipeline import enhance_files

    x, s = long_mixture(os.path.join(paths.data_root, paths.dataset_size),
                        minutes)
    own = work is None
    if own:
        work = tempfile.mkdtemp(prefix="gvnmf_long_")
    else:
        shutil.rmtree(work, ignore_errors=True)
    try:
        proc = os.path.join(work, "proc") + "/"
        bp = os.path.join(proc, os.path.splitext(REL)[0])
        os.makedirs(os.path.dirname(bp), exist_ok=True)
        write_wav(bp + "_x.wav", x, FS)
        write_wav(bp + "_s.wav", s, FS)

        m2 = load_model("artifacts/pretrained/M2_ibm", kind="dgm",
                        y_dim=513, device=dev)
        cfg = MCEMConfig(niter=niter)
        audio_sec = len(x) / FS
        n_frames = len(x) // 256 + 1
        buf_gb = cfg.nsamples_E_step * n_frames * 513 * 2 / 1e9  # bf16 dump
        kw = dict(model_type="m2", classif_type="oracle", cfg=cfg,
                  batch_size=32, fast=True, device=dev)

        walls = []
        for est in ("est", "est2"):
            t0 = time.perf_counter()
            enhance_files([REL], proc, os.path.join(work, est), m2, **kw)
            walls.append(time.perf_counter() - t0)
    finally:
        if own:
            shutil.rmtree(work, ignore_errors=True)
    cold, warm = walls
    row = {
        **backend_info(),
        "minutes": minutes,
        "frames": int(n_frames),
        "niter": niter,
        "sample_buffer_gb": round(buf_gb, 2),
        "cold_s": round(cold, 1),
        "warm_s": round(warm, 1),
        "rtf_warm": round(audio_sec / warm, 1),
    }
    print(json.dumps(row))
    return row


if __name__ == "__main__":
    main()
