"""Waveform + spectrogram + IBM / VAD label inspection figures for the
raw clean utterances of a split (reference scripts/visualization.py:
41-107). Host-side numpy: no model and no device work, so the script
takes no --device.

Usage: python -m guided_vae_nmf_torch.scripts.visualization
       [--dataset_size subset] [--data_root data]
       [--dataset_type train] [--labels ibm|vad] [--output <dir>]
"""

import os
import sys

import numpy as np

from ..config import PathsConfig, apply_overrides
from ..data import read_wav, speech_list
from ..dsp import clean_speech_IBM, noise_robust_clean_speech_VAD, stft
from ..viz import display_wav_spectro_mask
from ._common import flag


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    paths, rest = apply_overrides(PathsConfig(), argv)
    dataset_type = flag(rest, "dataset_type", "train")
    labels = flag(rest, "labels", "ibm")
    output = flag(rest, "output", "figures/")

    written = []
    for path in speech_list(paths.input_speech_dir, dataset_type):
        x, fs = read_wav(os.path.join(paths.input_speech_dir, path))
        x = x[int(0.1 * fs):]
        x = x / np.max(np.abs(x))
        x_tf = stft(x)
        if labels == "vad":
            mask = noise_robust_clean_speech_VAD(x_tf)
        else:
            mask = clean_speech_IBM(x_tf)
        fig = display_wav_spectro_mask(x, x_tf, mask)
        out = os.path.join(output,
                           os.path.splitext(path)[0] + f"_{labels}.png")
        os.makedirs(os.path.dirname(out), exist_ok=True)
        fig.savefig(out, dpi=40)
        written.append(out)
        print(f"wrote {out}")
    return written


if __name__ == "__main__":
    main()
