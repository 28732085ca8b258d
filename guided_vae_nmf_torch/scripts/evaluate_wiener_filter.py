"""Wiener-mask DNN baseline enhancement (reference
scripts/evaluate_wiener_filter.py): mask = model(x_norm); S_hat = mask * X.

Usage: python -m guided_vae_nmf_torch.scripts.evaluate_wiener_filter
       --model <ckpt-or-dir> [--dataset_size subset] [--data_root data]
       [--output <dir>] [--device cuda|cpu]
"""

import os
import sys
import time

from ..config import PathsConfig, apply_overrides
from ..data import speech_list
from ..pipeline import enhance_files_wiener
from ._common import device, flag, load_model, load_norm_stats


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    paths, rest = apply_overrides(PathsConfig(), argv)
    model_path = flag(rest, "model", paths.models_dir)
    output = flag(rest, "output", paths.models_dir + "wiener_enhanced/")
    dev = device(rest)

    model = load_model(model_path, kind="classifier", device=dev)
    mdir = (model_path if os.path.isdir(model_path)
            else os.path.dirname(model_path))
    mean, std = load_norm_stats(mdir)

    files = speech_list(paths.input_speech_dir, "test")
    t0 = time.perf_counter()
    enhance_files_wiener(files, paths.processed_wav_dir, output, model,
                         mean=mean, std=std, verbose=True, device=dev)
    print(f"Finished in {time.perf_counter() - t0:.1f} seconds "
          f"({len(files)} utterances)")


if __name__ == "__main__":
    main()
