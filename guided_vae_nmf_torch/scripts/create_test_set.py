"""Test mixtures with QUT noise (reference scripts/create_test_set.py).

Usage: python -m guided_vae_nmf_torch.scripts.create_test_set
       [--dataset_size subset] [--data_root data]
       [--noise_dir data/complete/raw/]
       [--processed_noise_dir data/complete/processed/QUT-NOISE/]
       [--synthetic_noise 1]   # four synthetic families under QUT's names
"""

import sys
import time

from ..config import PathsConfig, apply_overrides
from ..data import (
    create_test_mixtures,
    noise_list_preprocessed,
    preprocess_noise,
    qut_noise_list,
    read_wav,
    synthetic_noise_bank,
    write_preprocessed_noise,
)
from ._common import flag


def prepare_qut_noise(input_noise_dir, output_noise_dir):
    """Preprocess the four QUT recordings (reference
    create_test_set.py / qut_database.py:63-113)."""
    audios = {}
    for noise_type, path in qut_noise_list(input_noise_dir).items():
        audio, fs = read_wav(path)
        audio = preprocess_noise(audio, fs, noise_type=noise_type)
        write_preprocessed_noise(output_noise_dir, "test", noise_type, audio)
        audios[noise_type] = audio
    return audios


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    paths, rest = apply_overrides(PathsConfig(), argv)
    noise_dir = flag(rest, "noise_dir", "data/complete/raw/")
    processed_noise_dir = flag(rest, "processed_noise_dir",
                               "data/complete/processed/QUT-NOISE/")

    noise_types = ("cafe", "home", "street", "car")
    if flag(rest, "synthetic_noise", "0") in ("1", "true"):
        # QUT unavailable: four synthetic families under the QUT type
        # names, so downstream tooling sees the same layout
        bank = synthetic_noise_bank()
        audios = dict(zip(noise_types, (bank["white"], bank["low"],
                                        bank["mid"], bank["brown"])))
    else:
        try:
            audios = noise_list_preprocessed(processed_noise_dir, "test",
                                             list(noise_types))
        except (FileNotFoundError, OSError):
            audios = prepare_qut_noise(noise_dir, processed_noise_dir)

    t0 = time.perf_counter()
    all_snr = create_test_mixtures(
        paths.input_speech_dir, paths.processed_wav_dir, audios,
        dataset_type="test", snrs=(-5.0, 0.0, 5.0),
        noise_types=noise_types,
    )
    print(f"Finished in {time.perf_counter() - t0:.1f} seconds; "
          f"{len(all_snr)} mixtures, SNRs {sorted(set(all_snr))}")
    return all_snr


if __name__ == "__main__":
    main()
