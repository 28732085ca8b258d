"""Qualitative DNN-classifier masks and F1 against the oracle label: the
classifier runs on the device over each test mixture (reference
scripts/reconstruct_dnn_classif.py:166-226).

Usage: python -m guided_vae_nmf_torch.scripts.reconstruct_dnn_classif
       --classifier <ckpt-or-dir> [--target ibm|vad]
       [--dataset_size subset] [--data_root data] [--output <dir>]
       [--device cuda|cpu]
"""

import os
import sys

import numpy as np

from ..config import PathsConfig, apply_overrides
from ..data import read_wav, speech_list
from ..dsp import clean_speech_IBM, clean_speech_VAD, stft
from ..models.losses import f1_loss
from ..pipeline import load_mixture, make_labels
from ..viz import display_wav_spectro_mask
from ._common import device, flag, load_model, load_norm_stats


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    paths, rest = apply_overrides(PathsConfig(), argv)
    classifier_path = flag(rest, "classifier", paths.models_dir)
    target = flag(rest, "target", "ibm")
    output = flag(rest, "output", paths.models_dir + "classif_figures/")
    dev = device(rest)

    classifier = load_model(classifier_path, kind="classifier", device=dev)
    cdir = (classifier_path if os.path.isdir(classifier_path)
            else os.path.dirname(classifier_path))
    mean, std = load_norm_stats(cdir)

    scores = {}
    for path in speech_list(paths.input_speech_dir, "test"):
        base = os.path.join(paths.processed_wav_dir,
                            os.path.splitext(path)[0])
        x_t, _, X_tf = load_mixture(base)
        power = np.abs(X_tf) ** 2
        _, y_hard = make_labels("dnn", power, classifier=classifier,
                                mean=mean, std=std, target=target)

        s_t, _ = read_wav(base + "_s.wav")
        fn = clean_speech_VAD if target == "vad" else clean_speech_IBM
        y_oracle = fn(stft(s_t))
        if target == "vad":
            y_oracle = y_oracle.reshape(1, -1)
        n = min(y_hard.shape[1], y_oracle.shape[1])
        acc, prec, rec, f1 = (float(v) for v in f1_loss(
            y_hard[:, :n].reshape(-1), y_oracle[:, :n].reshape(-1)))

        fig = display_wav_spectro_mask(x_t, X_tf, y_hard)
        fig.suptitle(f"F1 = {f1:.3f}  acc = {acc:.3f}  "
                     f"prec = {prec:.3f}  recall = {rec:.3f}")
        out = os.path.join(
            output, os.path.splitext(path)[0] + f"_fig_{target}.png")
        os.makedirs(os.path.dirname(out), exist_ok=True)
        fig.savefig(out, dpi=40)
        scores[out] = (acc, prec, rec, f1)
        print(f"{path}: F1 {f1:.3f} -> {out}")
    return scores


if __name__ == "__main__":
    main()
