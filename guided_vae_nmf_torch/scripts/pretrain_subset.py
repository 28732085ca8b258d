"""Reproduce the shipped pretrained checkpoints (artifacts/pretrained) from
a data root's subset (counterpart of the JAX package's
scripts/pretrain_subset.py): build a diverse-noise labeled frame set from
the clean utterances of `<data_root>/<dataset_size>/raw/` (WSJ0 si_tr_s /
si_dt_05 and NTCD-TIMIT), train all six model families, and copy the best
checkpoint of each into --out.

Usage: python -m guided_vae_nmf_torch.scripts.pretrain_subset
       [--out artifacts/pretrained] [--epochs 300] [--augment 0]
       [--work <dir>] [--data_root data] [--dataset_size subset]
       [--device cuda|cpu]

--out defaults to the committed checkpoints' directory, which a run
overwrites: give another one unless that is what you want. --work (the
training runs' model directories) defaults to a temporary directory,
removed at the end.
"""

import glob
import os
import shutil
import sys
import tempfile

import numpy as np

from ..config import PathsConfig, apply_overrides
from ..data import read_wav
from ..data.noise import noise_segment, synthetic_noise_bank
from ..dsp import clean_speech_IBM, clean_speech_VAD, ideal_wiener_mask, stft
from ._common import device, flag

FS = 16000


def load_clean(p):
    x, fs = read_wav(p)
    if x.ndim > 1:
        x = x[:, 0]
    x = x[int(0.1 * FS):]
    return x / np.max(np.abs(x))


def clean_frames(clean):
    return np.concatenate(
        [(np.abs(stft(x)) ** 2).astype(np.float32) for x in clean], 1
    ).T


def clean_labeled_frames(clean, label_quantile=0.999):
    """Clean-speech frame set + clean-derived labels: the reference's M2
    training protocol (create_train_set.py:117-148 reads clean speech only;
    training_M2.py:70-73 consumes that file). The speech prior p(s|z,y) is
    a clean-speech model; only the classifier / wiener discriminators train
    on noisy mixtures (create_noisy_train_set.py:268-292).

    label_quantile: Lorenz quantile_fraction of the IBM / VAD labels (the
    reference's create_train_set.py uses 0.999; the eval-side oracle uses
    0.98, run_metrics_M2.py:52-53)."""
    X, Yibm, Yvad = [], [], []
    for x in clean:
        s_tf = stft(x)
        X.append((np.abs(s_tf) ** 2).astype(np.float32))
        Yibm.append(clean_speech_IBM(s_tf, label_quantile, 0.999))
        Yvad.append(clean_speech_VAD(s_tf, label_quantile, 0.999))
    cat = lambda a: np.concatenate(a, 1).T  # noqa: E731
    return cat(X), cat(Yibm), cat(Yvad)


def build(clean, noise, seed, n_mix=4,
          snrs=(-5, -2.5, 0, 2.5, 5.0), include_clean=False,
          label_quantile=0.999):
    """(X, Yibm, Yvad, Ywf) frames of `n_mix` noisy mixtures of each clean
    stream. Each noise window comes from numpy's global RNG, reseeded from
    `RandomState(seed)` before each mixture, as the JAX package does."""
    rng = np.random.RandomState(seed)
    types = list(noise)
    X, Yibm, Yvad, Ywf = [], [], [], []
    for x in clean:
        s_tf = stft(x)
        y_ibm = clean_speech_IBM(s_tf, label_quantile, 0.999)
        y_vad = clean_speech_VAD(s_tf, label_quantile, 0.999)
        for _ in range(n_mix):
            snr = rng.choice(snrs)
            np.random.seed(rng.randint(1 << 30))
            nz = noise_segment(noise, types[rng.randint(len(types))], x)
            k = np.sum(x**2) * 10 ** (-snr / 10) / np.sum(nz**2)
            nz = nz * np.sqrt(k)
            X.append((np.abs(stft(x + nz)) ** 2).astype(np.float32))
            Yibm.append(y_ibm)
            Yvad.append(y_vad)
            Ywf.append(ideal_wiener_mask(s_tf, stft(nz)).astype(np.float32))
        if include_clean:
            # near-clean frames (40 dB floor) teach the classifiers and
            # the guided decoder the speech-dominated regime real SPP
            # deployments hit between noise bursts
            nz = noise_segment(noise, types[rng.randint(len(types))], x)
            k = np.sum(x**2) * 1e-4 / np.sum(nz**2)
            nz = nz * np.sqrt(k)
            X.append((np.abs(stft(x + nz)) ** 2).astype(np.float32))
            Yibm.append(y_ibm)
            Yvad.append(y_vad)
            Ywf.append(ideal_wiener_mask(s_tf, stft(nz)).astype(np.float32))
    cat = lambda a: np.concatenate(a, 1).T  # noqa: E731
    return cat(X), cat(Yibm), cat(Yvad), cat(Ywf)


def load_subset_clean(subset):
    """(clean_train, clean_valid) waveform lists from a subset directory."""
    raw = os.path.join(subset, "raw")
    wsj = sorted(glob.glob(os.path.join(
        raw, "CSR-1-WSJ-0/WAV/wsj0/si_tr_s/**/*.wav"), recursive=True))
    wsj_dt = sorted(glob.glob(os.path.join(
        raw, "CSR-1-WSJ-0/WAV/wsj0/si_dt_05/**/*.wav"), recursive=True))
    ntcd = sorted(glob.glob(os.path.join(raw, "ntcd_timit/**/*.wav"),
                            recursive=True))
    clean_tr = [load_clean(p) for p in wsj + ntcd[:10]]
    clean_va = [load_clean(p) for p in wsj_dt + ntcd[10:]]
    if not clean_tr or not clean_va:
        raise SystemExit(f"no training / validation utterances under {raw}")
    return clean_tr, clean_va


def build_dataset(subset):
    """((Xtr, Yibm_tr), (Xva, Yibm_va)): the M2-IBM frame set the shipped
    checkpoints were trained on (for reuse by bench_train)."""
    clean_tr, clean_va = load_subset_clean(subset)
    noise = synthetic_noise_bank(clean_tr)
    Xtr, Yibm_tr, _, _ = build(clean_tr, noise, 0)
    Xva, Yibm_va, _, _ = build(clean_va, noise, 1)
    return (Xtr, Yibm_tr), (Xva, Yibm_va)


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    paths, argv = apply_overrides(PathsConfig(), argv)
    out = flag(argv, "out", "artifacts/pretrained")
    epochs = flag(argv, "epochs", 300, int)
    work = flag(argv, "work", None)
    augment = flag(argv, "augment", 0, int)
    dev = device(argv)

    from ..train import (TrainConfig, best_checkpoint, train_classifier,
                         train_m1, train_m2, train_wiener)

    clean_tr, clean_va = load_subset_clean(
        os.path.join(paths.data_root, paths.dataset_size))

    if augment:
        # speed-perturbed + gain-varied clean copies, the rich noise bank,
        # more SNR draws over a wider range, and near-clean mixtures
        from ..data.synthesis import augment_clean

        bank_streams = clean_tr
        clean_tr = augment_clean(clean_tr)
        noise = synthetic_noise_bank(bank_streams, rich=True)
        Xtr, Yibm_tr, Yvad_tr, Ywf_tr = build(
            clean_tr, noise, 0, n_mix=5,
            snrs=(-7.5, -5, -2.5, 0, 2.5, 5.0, 7.5, 10.0),
            include_clean=True)
        Xva, Yibm_va, Yvad_va, Ywf_va = build(
            clean_va, noise, 1, n_mix=4,
            snrs=(-5, -2.5, 0, 2.5, 5.0))
    else:
        noise = synthetic_noise_bank(clean_tr)
        Xtr, Yibm_tr, Yvad_tr, Ywf_tr = build(clean_tr, noise, 0)
        Xva, Yibm_va, Yvad_va, Ywf_va = build(clean_va, noise, 1)
    print(f"frames: train {Xtr.shape} valid {Xva.shape}")

    # The generative models (M1 / M2) train on clean speech frames per the
    # reference protocol (see clean_labeled_frames); the discriminative
    # models (classifier / wiener) train on the noisy mixtures.
    Xc_tr, Yc_ibm_tr, Yc_vad_tr = clean_labeled_frames(clean_tr)
    Xc_va, Yc_ibm_va, Yc_vad_va = clean_labeled_frames(clean_va)

    cfg = TrainConfig(end_epoch=epochs, batch_size=256)
    cfg_cls = TrainConfig(end_epoch=max(1, epochs // 2), batch_size=256)
    eps = 1e-8
    mean, std = Xtr.mean(0), Xtr.std(0)
    Xn_tr = ((Xtr - mean) / (std + eps)).astype(np.float32)
    Xn_va = ((Xva - mean) / (std + eps)).astype(np.float32)

    jobs = [
        ("M1", lambda d: train_m1(
            clean_frames(clean_tr), clean_frames(clean_va),
            dims=(513, 32, (128, 128)), cfg=cfg, model_dir=d, name="M1",
            device=dev)),
        ("M2_ibm", lambda d: train_m2(
            (Xc_tr, Yc_ibm_tr), (Xc_va, Yc_ibm_va),
            dims=(513, 513, 32, (128, 128)),
            cfg=cfg, model_dir=d, name="M2", device=dev)),
        ("M2_vad", lambda d: train_m2(
            (Xc_tr, Yc_vad_tr), (Xc_va, Yc_vad_va),
            dims=(513, 1, 32, (128, 128)),
            cfg=cfg, model_dir=d, name="M2", device=dev)),
        ("classifier_ibm", lambda d: train_classifier(
            (Xn_tr, Yibm_tr), (Xn_va, Yibm_va),
            dims=(513, (128, 128), 513), cfg=cfg_cls, model_dir=d,
            name="Classifier", mean=mean, std=std, device=dev)),
        ("classifier_vad", lambda d: train_classifier(
            (Xn_tr, Yvad_tr), (Xn_va, Yvad_va), dims=(513, (128, 128), 1),
            cfg=cfg_cls, model_dir=d, name="Classifier", mean=mean,
            std=std, device=dev)),
        ("wiener", lambda d: train_wiener(
            (Xn_tr, Ywf_tr), (Xn_va, Ywf_va), dims=(513, (128,) * 5, 513),
            cfg=cfg_cls, model_dir=d, name="Wiener", mean=mean, std=std,
            device=dev)),
    ]
    own = work is None
    if own:
        work = tempfile.mkdtemp(prefix="gvnmf_pretrain_")
    try:
        for name, job in jobs:
            mdir = os.path.join(work, name)
            _, hist = job(mdir)
            best = best_checkpoint(mdir)
            dst = os.path.join(out, name)
            os.makedirs(dst, exist_ok=True)
            shutil.copy(best, dst)
            for side in ("trainset_mean.npy", "trainset_std.npy"):
                p = os.path.join(mdir, side)
                if os.path.exists(p):
                    shutil.copy(p, dst)
            print(f"{name}: best valid "
                  f"{min(h['valid'] for h in hist):.3f} -> {dst}")
    finally:
        if own:
            shutil.rmtree(work, ignore_errors=True)


if __name__ == "__main__":
    main()
