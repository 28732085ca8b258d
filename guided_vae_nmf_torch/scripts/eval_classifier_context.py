"""Classifier temporal-context experiment at campaign scale (counterpart of
the JAX package's scripts/eval_classifier_context.py).

The reference's IBM classifier (reference models.py:41-62) sees one
513-dim power frame, no temporal context. This experiment trains the same
MLP with the input widened to a stack of 2k+1 standardized frames (k = 0
is the reference architecture; stacking is edge-padded within each
utterance, never across utterance boundaries) on eval_campaign's
speaker-disjoint bank, and scores F1 against the reference metric
protocol's oracle (clean_speech_IBM at quantile 0.98 / 0.999, reference
run_metrics_M2.py:52-53) on the campaign's corpus, per noise family and
per SNR.

Usage: python -m guided_vae_nmf_torch.scripts.eval_classifier_context
         [--work <dir>] [--contexts 0,1,2] [--epochs 100]
         [--thresholds 0.5,0.7] [--train_voices 5] [--data_root data]
         [--dataset_size subset] [--device cuda|cpu]

Needs an eval_campaign work dir with at least its corpus built (--work
defaults to eval_campaign's, `<temp dir>/gvnmf_campaign`); trains its own
classifiers under <work>/ctx/ and writes <work>/ctx/context_f1.json.
"""

import json
import os
import sys
import tempfile
import time

import numpy as np

from ..config import PathsConfig, apply_overrides
from ._common import backend_info, device, flag

FS = 16000


def stack_context(X, k):
    """(N, F) -> (N, F*(2k+1)): each frame concatenated with its k
    neighbours on each side, edge-replicated at the utterance ends.
    k=0 is the identity (reference architecture)."""
    if k == 0:
        return X
    N = X.shape[0]
    idx = np.arange(N)
    cols = [X[np.clip(idx + d, 0, N - 1)] for d in range(-k, k + 1)]
    return np.concatenate(cols, axis=1)


def build_utt_frames(clean, noise, seed, n_mix, snrs, include_clean):
    """Per-utterance (X_frames, Y_frames) lists: pretrain_subset.build's
    mixing protocol, keeping utterance boundaries so context stacking never
    crosses them. Each noise window comes from numpy's global RNG,
    reseeded from `RandomState(seed)` before each mixture."""
    from ..data.noise import noise_segment
    from ..dsp import clean_speech_IBM, stft

    rng = np.random.RandomState(seed)
    types = list(noise)
    utts = []
    for x in clean:
        s_tf = stft(x)
        y = clean_speech_IBM(s_tf, 0.999, 0.999).T  # (N, 513)
        mixes = n_mix + (1 if include_clean else 0)
        for m in range(mixes):
            snr = rng.choice(snrs) if m < n_mix else 40.0
            np.random.seed(rng.randint(1 << 30))
            nz = noise_segment(noise, types[rng.randint(len(types))], x)
            k = np.sum(x**2) * 10 ** (-snr / 10) / np.sum(nz**2)
            X = (np.abs(stft(x + nz * np.sqrt(k))) ** 2).astype(
                np.float32).T                        # (N, 513)
            utts.append((X, y.astype(np.float32)))
    return utts


def assemble(utts, mean, std, k, eps=1e-8):
    """Standardize-then-stack: per-utterance context windows over
    normalized frames, flattened to one (sum_N, 513*(2k+1)) matrix.
    Standardizing before stacking keeps the deployable side-car the plain
    513-dim trainset_mean/std."""
    Xs, Ys = [], []
    for X, y in utts:
        Xs.append(stack_context((X - mean) / (std + eps), k))
        Ys.append(y)
    return (np.concatenate(Xs).astype(np.float32),
            np.concatenate(Ys).astype(np.float32))


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    paths, argv = apply_overrides(PathsConfig(), argv)
    work = flag(argv, "work", os.path.join(tempfile.gettempdir(),
                                           "gvnmf_campaign"))
    contexts = [int(c) for c in flag(argv, "contexts", "0,1,2").split(",")]
    epochs = flag(argv, "epochs", 100, int)
    ths = [float(t) for t in flag(argv, "thresholds", "0.5,0.7").split(",")]
    train_voices = flag(argv, "train_voices", 5, int)
    dev = device(argv)

    import torch

    from ..data import read_wav
    from ..data.noise import synthetic_noise_bank
    from ..data.synthesis import VOICE_VARIANTS, augment_clean, voice_variants
    from ..dsp import clean_speech_IBM, stft
    from ..models import classifier_apply
    from ..train import (TrainConfig, best_checkpoint, load_model,
                         train_classifier)
    from .eval_campaign import _load_clean, campaign_splits

    corpus = os.path.join(work, "corpus")
    with open(os.path.join(corpus, "manifest.json")) as f:
        manifest = json.load(f)

    # --- per-utterance training bank (campaign protocol, boundaries kept)
    tr_paths, va_paths, _ = campaign_splits(
        os.path.join(paths.data_root, paths.dataset_size))
    base_tr = [_load_clean(p) for p in tr_paths]
    clean_tr = []
    for x in base_tr:
        clean_tr.extend(voice_variants(x, VOICE_VARIANTS[:train_voices]))
    clean_tr = augment_clean(clean_tr, factors=(), gains=(0.7, 1.4))
    clean_va = [_load_clean(p) for p in va_paths]
    noise = synthetic_noise_bank(base_tr, seed=11, rich=True)
    t0 = time.perf_counter()
    utts_tr = build_utt_frames(
        clean_tr, noise, 0, n_mix=3,
        snrs=(-7.5, -5, -2.5, 0, 2.5, 5.0, 7.5, 10.0), include_clean=True)
    utts_va = build_utt_frames(clean_va, noise, 1, n_mix=4,
                               snrs=(-5, -2.5, 0, 2.5, 5.0),
                               include_clean=False)
    Xall = np.concatenate([u[0] for u in utts_tr])
    mean, std = Xall.mean(0), Xall.std(0)
    print(f"bank: {Xall.shape[0]} train frames "
          f"({time.perf_counter() - t0:.0f}s)", flush=True)
    del Xall

    results = {"config": {"contexts": contexts, "epochs": epochs,
                          "thresholds": ths, **backend_info()}}
    for k in contexts:
        mdir = os.path.join(work, "ctx", f"k{k}")
        ck = best_checkpoint(mdir)
        if ck is None:
            Xtr, Ytr = assemble(utts_tr, mean, std, k)
            Xva, Yva = assemble(utts_va, mean, std, k)
            cfg = TrainConfig(end_epoch=epochs, batch_size=256)
            t0 = time.perf_counter()
            _, hist = train_classifier(
                (Xtr, Ytr), (Xva, Yva),
                dims=(513 * (2 * k + 1), (128, 128), 513), cfg=cfg,
                model_dir=mdir, name="Classifier", mean=mean, std=std,
                device=dev)
            print(f"k={k}: best valid "
                  f"{min(h['valid'] for h in hist):.2f} "
                  f"({time.perf_counter() - t0:.0f}s)", flush=True)
            ck = best_checkpoint(mdir)
            del Xtr, Ytr, Xva, Yva
        model = load_model(ck, kind="classifier", device=dev)

        # --- corpus F1 (frame-weighted tp/fp/fn aggregation) ------------
        agg = {t: {} for t in ths}   # th -> (fam|snr|all) -> [tp, fp, fn]
        for e in manifest["entries"]:
            base = os.path.splitext(e["name"])[0]
            x, _ = read_wav(os.path.join(corpus, base + "_x.wav"))
            s, _ = read_wav(os.path.join(corpus, base + "_s.wav"))
            X = (np.abs(stft(x)) ** 2).astype(np.float32).T
            y = clean_speech_IBM(stft(s), 0.98, 0.999).T > 0.5
            xin = np.ascontiguousarray(
                stack_context((X - mean) / (std + 1e-8), k), np.float32)
            with torch.no_grad():
                soft = classifier_apply(
                    model, torch.from_numpy(xin).to(dev)).cpu().numpy()
            nc = min(soft.shape[0], y.shape[0])
            yv = y[:nc].reshape(-1)
            for t in ths:
                pv = soft[:nc].reshape(-1) > t
                tpfpfn = np.array([np.sum(pv & yv), np.sum(pv & ~yv),
                                   np.sum(~pv & yv)], np.int64)
                for key in ("all", f"fam:{e['family']}",
                            f"snr:{e['snr']:+.0f}"):
                    agg[t][key] = agg[t].get(key, 0) + tpfpfn

        res = {}
        for t in ths:
            res[str(t)] = {}
            for key, (tp, fp, fn) in sorted(agg[t].items()):
                p = tp / max(tp + fp, 1)
                r = tp / max(tp + fn, 1)
                f1 = 2 * p * r / max(p + r, 1e-9)
                res[str(t)][key] = {"P": round(float(p), 3),
                                    "R": round(float(r), 3),
                                    "F1": round(float(f1), 3)}
            line = "  ".join(f"{key}={v['F1']:.3f}"
                             for key, v in res[str(t)].items())
            print(f"k={k} th={t}: {line}", flush=True)
        results[f"k{k}"] = res

    out = os.path.join(work, "ctx", "context_f1.json")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    with open(out, "w") as f:
        json.dump(results, f, indent=1)
    print(json.dumps({"context_experiment": "done", **backend_info()}))
    return results


if __name__ == "__main__":
    main()
