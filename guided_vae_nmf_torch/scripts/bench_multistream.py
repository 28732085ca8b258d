"""Concurrent-streaming capacity bench on the GPU: the
MultiStreamM2Enhancer pool (one batched tick for every live stream)
against dedicated per-stream enhancers run one after another (one tick a
stream).

Both paths run the same streaming configuration (M2 + labels + SPP noise,
blockwise warm-started EM) over B concurrent synthetic streams fed in
real-time-ordered chunks. Reports, per B: wall for pooled and serial, the
pooled speedup, and the card's total realtime factor (B streams x 1x audio
each); a realtime factor >= B means the card sustains B live streams.

Usage: python -m guided_vae_nmf_torch.scripts.bench_multistream
       [--streams 2,4,8] [--seconds 8] [--max_streams 0]
       [--chunk_frames 4] [--context_frames 24] [--label_mode timo]
       [--block_iters 6] [--e_steps 4] [--device cuda|cpu]

`--data_parallel 1` raises NotImplementedError (ROADMAP Queue 1, item 5).
"""

import json
import sys
import time

import numpy as np

from ._common import (backend_info, device, flag, load_model,
                      load_norm_stats, no_data_parallel)

FS = 16000


def _signal(seed, n):
    rng = np.random.RandomState(seed)
    t = np.arange(n) / FS
    s = 0.1 * np.sin(2 * np.pi * np.cumsum(
        120 + 30 * np.sin(2 * np.pi * (0.7 + 0.1 * seed) * t)) / FS)
    s *= np.clip(np.sin(2 * np.pi * 1.6 * t + seed), 0, None)
    return (s + 0.02 * rng.randn(n)).astype(np.float32)


def _sync(dev):
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _run_pooled(dgm, kw, sigs, chunk_samples, max_streams):
    from ..streaming import MultiStreamM2Enhancer

    pool = MultiStreamM2Enhancer(dgm, max_streams=max_streams, **kw)
    sids = [pool.open() for _ in sigs]
    n = len(sigs[0])
    t0 = time.perf_counter()
    for lo in range(0, n, chunk_samples):
        for sid, x in zip(sids, sigs):
            pool.feed(sid, x[lo:lo + chunk_samples])
        pool.step()
    for sid in sids:
        pool.flush(sid)
        pool.close(sid)
    _sync(kw["device"])
    return time.perf_counter() - t0


def _run_serial(dgm, kw, sigs, chunk_samples):
    from ..streaming import StreamingM2Enhancer

    enhs = [StreamingM2Enhancer(dgm, **kw) for _ in sigs]
    n = len(sigs[0])
    t0 = time.perf_counter()
    for lo in range(0, n, chunk_samples):
        for enh, x in zip(enhs, sigs):
            enh.push(x[lo:lo + chunk_samples])
    for enh in enhs:
        enh.flush()
    _sync(kw["device"])
    return time.perf_counter() - t0


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    streams = [int(b) for b in flag(argv, "streams", "2,4,8").split(",")]
    # 0 = size the pool to each B (full occupancy)
    max_streams = flag(argv, "max_streams", 0, int)
    seconds = flag(argv, "seconds", 8.0, float)
    chunk_frames = flag(argv, "chunk_frames", 4, int)
    context_frames = flag(argv, "context_frames", 24, int)
    label_mode = flag(argv, "label_mode", "timo")
    block_iters = flag(argv, "block_iters", 6, int)
    e_steps = flag(argv, "e_steps", 4, int)
    no_data_parallel(argv)
    dev = device(argv)

    from ..streaming import HOP

    kw = dict(label_mode=label_mode, chunk_frames=chunk_frames,
              context_frames=context_frames, block_iters=block_iters,
              e_steps=e_steps, device=dev)
    dgm = load_model("artifacts/pretrained/M2_ibm", kind="dgm", device=dev)
    if label_mode == "dnn":
        kw["classifier"] = load_model(
            "artifacts/pretrained/classifier_ibm", kind="classifier",
            device=dev)
        kw["mean"], kw["std"] = load_norm_stats(
            "artifacts/pretrained/classifier_ibm")

    n = int(seconds * FS)
    chunk_samples = chunk_frames * HOP  # feed cadence = one block latency
    rows = []
    for B in streams:
        sigs = [_signal(7 + i, n) for i in range(B)]
        pool_size = max_streams or B
        # warm both paths (the pool's and a dedicated stream's)
        _run_pooled(dgm, kw, [s[: 4 * chunk_samples] for s in sigs],
                    chunk_samples, pool_size)
        _run_serial(dgm, kw, [sigs[0][: 4 * chunk_samples]], chunk_samples)
        t_pool = _run_pooled(dgm, kw, sigs, chunk_samples, pool_size)
        t_serial = _run_serial(dgm, kw, sigs, chunk_samples)
        audio_s = B * seconds
        rows.append({
            "streams": B,
            "pool_size": pool_size,
            "pooled_wall_s": t_pool,
            "serial_wall_s": t_serial,
            "pooled_rtf_total": audio_s / t_pool,
            "serial_rtf_total": audio_s / t_serial,
            "speedup": t_serial / t_pool,
            "sustains_live": bool(audio_s / t_pool >= B),
        })
        print(json.dumps(rows[-1]))
    print(json.dumps({"bench": "multistream", **backend_info(),
                      "chunk_frames": chunk_frames,
                      "seconds": seconds, "rows": rows}))
    return rows


if __name__ == "__main__":
    main()
