"""Noisy training frame store with DEMAND noise (reference
scripts/create_noisy_train_set.py).

Usage: python -m guided_vae_nmf_torch.scripts.create_noisy_train_set
       [--dataset_size subset] [--data_root data]
       [--labels noisy_labels|noisy_vad_labels|noisy_wiener_labels]
       [--noise_dir data/complete/raw/Demand/]
       [--processed_noise_dir data/complete/processed/Demand/]
       [--synthetic_noise 1]   # the six-family synthetic bank for DEMAND
"""

import os
import sys

import numpy as np

from ..config import PathsConfig, apply_overrides
from ..data import (
    create_noisy_frames,
    demand_noise_list,
    noise_list_preprocessed,
    preprocess_noise,
    read_wav,
    synthetic_noise_bank,
    write_preprocessed_noise,
)
from ..data.noise import DEMAND_RECORDINGS
from ._common import flag


def prepare_demand_noise(input_noise_dir, output_noise_dir):
    """Concatenate + resample the per-type DEMAND recordings into single
    16 kHz wavs (reference create_noisy_train_set.py:83-130)."""
    audios = {}
    for dataset_type in ("train", "validation"):
        noise_paths = demand_noise_list(input_noise_dir, dataset_type)
        per_split = {}
        for noise_type, paths in noise_paths.items():
            chunks = []
            for p in paths:
                audio, fs = read_wav(p)
                chunks.append(preprocess_noise(audio, fs))
            audio = np.concatenate(chunks)
            write_preprocessed_noise(output_noise_dir, dataset_type,
                                     noise_type, audio)
            per_split[noise_type] = audio
        audios[dataset_type] = per_split
    return audios


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    paths, rest = apply_overrides(PathsConfig(), argv)
    labels = flag(rest, "labels", "noisy_labels")
    noise_dir = flag(rest, "noise_dir", "data/complete/raw/Demand/")
    processed_noise_dir = flag(rest, "processed_noise_dir",
                               "data/complete/processed/Demand/")

    if flag(rest, "synthetic_noise", "0") in ("1", "true"):
        # DEMAND unavailable: the six-family synthetic bank (the one the
        # shipped pretrained checkpoints were trained with)
        bank = synthetic_noise_bank()
        names = sorted(bank)
        audios = {
            "train": {t: bank[t] for t in names[: len(names) // 2 + 1]},
            "validation": {t: bank[t] for t in names[len(names) // 2 + 1:]},
        }
    else:
        # preprocessed noise if present, else preprocess raw DEMAND
        audios = {}
        try:
            for dataset_type in ("train", "validation"):
                types = list(DEMAND_RECORDINGS[dataset_type].keys())
                audios[dataset_type] = noise_list_preprocessed(
                    processed_noise_dir, dataset_type, types)
        except (FileNotFoundError, OSError):
            audios = prepare_demand_noise(noise_dir, processed_noise_dir)

    out = paths.h5_path(labels)
    os.makedirs(os.path.dirname(out), exist_ok=True)
    snr_lists = create_noisy_frames(
        paths.input_speech_dir, out, audios,
        dataset_types=("train", "validation"), labels=labels,
        quantile_fraction=0.999,
        output_wav_dir=(paths.processed_wav_dir
                        if paths.dataset_size == "subset" else None),
    )
    print(f"wrote {out}; SNR draws: "
          f"{ {k: len(v) for k, v in snr_lists.items()} }")
    return out


if __name__ == "__main__":
    main()
