"""Latency / quality curve of the online M2 flagship (StreamingM2Enhancer)
on the GPU.

Enhances the test mixtures of a data root (`<data_root>/<dataset_size>/`,
the reference layout) through the blockwise warm-started stream at several
chunk sizes and compares each configuration against (a) the mixture floor
and (b) the offline flagship configuration (M2 + SPP noise model) on
SI-SDR / ESTOI / PESQ. Latency = chunk_frames x 16 ms block + 64 ms STFT
window.

Usage: python -m guided_vae_nmf_torch.scripts.eval_streaming_m2
       [--data_root data] [--dataset_size subset]
       [--artifacts artifacts/pretrained] [--chunks 4,8,16,32]
       [--label_mode dnn|timo] [--niter_offline 100]
       [--soft_labels 0] [--residual 0] [--noise_gain 0]
       [--noise_gain_init ones] [--noise_gain_bands 1]
       [--adaptive_iters 0] [--escalate_reinit 0] [--lookahead 0]
       [--block_iters 6] [--e_steps 4] [--context_frames 24]
       [--profile <name>] [--skip_offline 0] [--work <dir>]
       [--device cuda|cpu]

--residual 1 enables causal residual noise tracking (the streaming
analogue of the offline 'spp2' two-pass model). --noise_gain 1 learns a
per-frame noise gain inside each block. --work defaults to a temporary
directory, removed at the end.
"""

import os
import sys
import tempfile
import time

import numpy as np

from ..config import PathsConfig, apply_overrides
from ..data import read_wav, speech_list
from ..mcem import MCEMConfig
from ..metrics import energy_ratios, pesq, stoi
from ..pipeline import enhance_files
from ..streaming import FS, HOP, StreamingM2Enhancer
from ._common import device, flag, load_model, load_norm_stats


def mets(s, n, sh):
    L = min(len(s), len(sh))
    return (energy_ratios(sh[:L], s[:L], n[:L])[0],
            stoi(s[:L], sh[:L], FS, True), pesq(FS, s[:L], sh[:L], "wb"))


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    paths, argv = apply_overrides(PathsConfig(), argv)
    artifacts = flag(argv, "artifacts", "artifacts/pretrained")
    chunks = [int(c) for c in flag(argv, "chunks", "4,8,16,32").split(",")]
    label_mode = flag(argv, "label_mode", "dnn")
    niter = flag(argv, "niter_offline", 100, int)
    work = flag(argv, "work", None)
    soft = flag(argv, "soft_labels", "0") in ("1", "true")
    residual = flag(argv, "residual", "0") in ("1", "true")
    noise_gain = flag(argv, "noise_gain", "0") in ("1", "true")
    ng_init = flag(argv, "noise_gain_init", "ones")
    ng_bands = flag(argv, "noise_gain_bands", 1, int)
    adaptive_iters = flag(argv, "adaptive_iters", 0, int)
    escalate_reinit = flag(argv, "escalate_reinit", "0") in ("1", "true")
    lookahead = flag(argv, "lookahead", "0") in ("1", "true")
    block_iters = flag(argv, "block_iters", 6, int)
    e_steps = flag(argv, "e_steps", 4, int)
    context = flag(argv, "context_frames", 24, int)
    skip_offline = flag(argv, "skip_offline", "0") in ("1", "true")
    dev = device(argv)

    profile = flag(argv, "profile", None)
    if profile is not None:
        # a validated preset (profiles.py): authoritative for the managed
        # streaming knobs; the label source and niter_offline keep their
        # flags
        from ..profiles import streaming_settings

        st = streaming_settings(profile)

        def pick(key, flagged, current):
            # an explicit flag beats the profile (ablation sweeps)
            if flag(argv, flagged) is not None:
                return current
            return st.get(key, current)

        soft = pick("soft_guidance", "soft_labels", soft)
        residual = pick("residual_tracking", "residual", residual)
        noise_gain = pick("noise_gain", "noise_gain", noise_gain)
        ng_bands = pick("noise_gain_bands", "noise_gain_bands", ng_bands)
        adaptive_iters = pick("adaptive_iters", "adaptive_iters",
                              adaptive_iters)
        escalate_reinit = pick("escalate_reinit", "escalate_reinit",
                               escalate_reinit)
        lookahead = pick("lookahead", "lookahead", lookahead)
        block_iters = pick("block_iters", "block_iters", block_iters)
        e_steps = pick("e_steps", "e_steps", e_steps)
        context = pick("context_frames", "context_frames", context)
        if "chunk_frames" in st and flag(argv, "chunks") is None:
            chunks = [st["chunk_frames"]]

    files = speech_list(paths.input_speech_dir, "test")
    processed = paths.processed_wav_dir
    m2 = load_model(os.path.join(artifacts, "M2_ibm"), kind="dgm",
                    device=dev)
    cls = mean = std = None
    features, dnn_threshold = "power", 0.5
    if label_mode == "dnn":
        from ..train import load_classifier_meta

        cdir = os.path.join(artifacts, "classifier_ibm")
        cls = load_model(cdir, kind="classifier", device=dev)
        mean, std = load_norm_stats(cdir)
        cmeta = load_classifier_meta(cdir)
        features, dnn_threshold = cmeta["features"], cmeta["threshold"]

    utts = []
    for p in files:
        bp = os.path.join(processed, os.path.splitext(p)[0])
        s, _ = read_wav(bp + "_s.wav")
        n, _ = read_wav(bp + "_n.wav")
        x, _ = read_wav(bp + "_x.wav")
        utts.append((os.path.basename(p)[:-4], s, n, x))

    print(f"{'config':<26}{'latency':>9}" + "".join(
        f"{u[0]:>26}" for u in utts))
    row = [f"{energy_ratios(x, s, n)[0]:+.2f} "
           f"{stoi(s, x, FS, True):.3f} {pesq(FS, s, x, 'wb'):.2f}"
           for _, s, n, x in utts]
    print(f"{'mixture floor':<26}{'-':>9}" + "".join(
        f"{c:>26}" for c in row))

    with tempfile.TemporaryDirectory(prefix="gvnmf_stream_eval_") as tmp:
        # the offline flagship (M2 + SPP noise), the configuration the
        # stream approximates
        out = os.path.join(work or tmp, "offline")
        if not skip_offline:
            enhance_files(files, processed, out, m2, model_type="m2",
                          classif_type="oracle" if label_mode == "timo"
                          else label_mode,
                          classifier=cls, mean=mean, std=std,
                          cfg=MCEMConfig(niter=niter), batch_size=4,
                          noise_model="spp", device=dev)
            row = []
            for p, (name, s, n, x) in zip(files, utts):
                sh, _ = read_wav(os.path.join(
                    out, os.path.splitext(p)[0]) + "_s_est.wav")
                a, b, c = mets(s, n, sh)
                row.append(f"{a:+.2f} {b:.3f} {c:.2f}")
            print(f"{'offline M2+SPP (MCEM)':<26}{'inf':>9}" + "".join(
                f"{c:>26}" for c in row))

    for cf in chunks:
        # latency = chunk buffering + 64 ms STFT window (+ one more chunk
        # when the lookahead mode delays emission by a tick)
        lat_ms = cf * HOP * 1000 // FS + 64
        if lookahead:
            lat_ms += cf * HOP * 1000 // FS
        row = []
        t0 = time.perf_counter()
        for name, s, n, x in utts:
            enh = StreamingM2Enhancer(
                m2, classifier=cls, mean=mean, std=std,
                chunk_frames=cf, label_mode=label_mode,
                soft_guidance=soft, residual_tracking=residual,
                noise_gain=noise_gain, noise_gain_init=ng_init,
                noise_gain_bands=ng_bands,
                adaptive_iters=adaptive_iters,
                escalate_reinit=escalate_reinit, lookahead=lookahead,
                block_iters=block_iters, e_steps=e_steps,
                context_frames=context, features=features,
                dnn_threshold=dnn_threshold, device=dev)
            outs = []
            for lo in range(0, len(x), 4096):
                outs.append(enh.push(x[lo:lo + 4096]))
            outs.append(enh.flush())
            sh = np.concatenate(outs)
            a, b, c = mets(s, n, sh)
            row.append(f"{a:+.2f} {b:.3f} {c:.2f}")
        wall = time.perf_counter() - t0
        print(f"{f'stream chunk={cf}':<26}{f'{lat_ms} ms':>9}" + "".join(
            f"{c:>26}" for c in row) + f"   [{wall:.0f}s]")
    print("(cells: SI-SDR dB, ESTOI, PESQ-wb)")


if __name__ == "__main__":
    main()
