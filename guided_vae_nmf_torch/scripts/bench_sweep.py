"""Reproducible full-pipeline sweep benchmark (counterpart of the JAX
package's scripts/bench_sweep.py): replicates the test mixtures of a data
root (made by `create_test_set --synthetic_noise 1`, the reference layout
`<data_root>/<dataset_size>/{raw,processed}/`) to `--n` utterances, runs
`enhance_files` (oracle-IBM M2, the full MCEMConfig()) twice, cold then
warm, and prints a JSON summary of the end-to-end wav -> wav realtime
factors. MCEMConfig fields take `--field value` overrides (e.g.
`--niter 10`), as the evaluate scripts' do. No mesh.

Usage: python -m guided_vae_nmf_torch.scripts.bench_sweep [--n 100]
       [--batch_size 32] [--fast 1] [--profile <trace dir>]
       [--data_root data] [--dataset_size subset]
       [--model artifacts/pretrained/M2_ibm] [--work <dir>]
       [--device cuda|cpu]

--work defaults to a temporary directory, removed at the end.
"""

import json
import os
import shutil
import sys
import tempfile
import time
from contextlib import nullcontext

from ..config import PathsConfig, apply_overrides
from ._common import backend_info, device, engine_config, flag, load_model

FS = 16000


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    paths, argv = apply_overrides(PathsConfig(), argv)
    cfg, argv = engine_config(argv)
    n_utts = flag(argv, "n", 100, int)
    batch_size = flag(argv, "batch_size", 32, int)
    fast = bool(flag(argv, "fast", 1, int))  # bf16 dumps + approx recip
    profile_dir = flag(argv, "profile")      # write a trace here
    model_dir = flag(argv, "model", "artifacts/pretrained/M2_ibm")
    work = flag(argv, "work", None)
    dev = device(argv)

    from ..data import read_wav, speech_list
    from ..ops.profiling import profile_trace
    from ..pipeline import enhance_files

    own = work is None
    work = tempfile.mkdtemp(prefix="gvnmf_sweep_") if own else work
    try:
        proc = os.path.join(work, "proc") + "/"
        base = speech_list(paths.input_speech_dir, "test")
        if not base:
            raise SystemExit(f"no test utterances under "
                             f"{paths.input_speech_dir}")
        names = []
        for i in range(n_utts):
            src = os.path.join(paths.processed_wav_dir,
                               os.path.splitext(base[i % len(base)])[0])
            rel = f"CSR-1-WSJ-0/WAV/wsj0/si_et_05/440/u{i:03d}.wav"
            dst = os.path.join(proc, os.path.splitext(rel)[0])
            os.makedirs(os.path.dirname(dst), exist_ok=True)
            for suf in ("_x.wav", "_s.wav", "_n.wav"):
                if not os.path.exists(dst + suf):
                    os.link(src + suf, dst + suf)
            names.append(rel)
        audio_sec = sum(len(read_wav(os.path.join(
            proc, os.path.splitext(n)[0]) + "_x.wav")[0])
            for n in names) / FS
        m2 = load_model(model_dir, kind="dgm", y_dim=513, device=dev)
        kw = dict(model_type="m2", classif_type="oracle", cfg=cfg,
                  batch_size=batch_size, fast=fast, device=dev)

        t0 = time.perf_counter()
        enhance_files(names, proc, os.path.join(work, "est_cold"), m2, **kw)
        cold = time.perf_counter() - t0
        ctx = profile_trace(profile_dir) if profile_dir else nullcontext()
        t0 = time.perf_counter()
        with ctx:
            enhance_files(names, proc, os.path.join(work, "est_warm"), m2,
                          **kw)
        warm = time.perf_counter() - t0
    finally:
        if own:
            shutil.rmtree(work, ignore_errors=True)
    row = {**backend_info(), "utterances": n_utts,
           "audio_sec": round(audio_sec, 1), "cold_s": round(cold, 1),
           "warm_s": round(warm, 1), "rtf_cold": round(audio_sec / cold, 1),
           "rtf_warm": round(audio_sec / warm, 1)}
    print(json.dumps(row))
    return row


if __name__ == "__main__":
    main()
