"""Qualitative SPP ("timo") masks, soft and hard figures: the SPP tracker
(`mcem.spp.timo_mask` / `timo_vad`) runs on the device over each test
mixture (reference scripts/reconstruct_timo_classif.py:95-173).

Usage: python -m guided_vae_nmf_torch.scripts.reconstruct_timo_classif
       [--target ibm|vad] [--dataset_size subset] [--data_root data]
       [--output <dir>] [--device cuda|cpu]
"""

import os
import sys

import numpy as np
import torch

from ..config import PathsConfig, apply_overrides
from ..data import speech_list
from ..mcem.spp import timo_mask, timo_vad
from ..pipeline import load_mixture
from ..viz import display_wav_spectro_mask
from ._common import device, flag


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    paths, rest = apply_overrides(PathsConfig(), argv)
    target = flag(rest, "target", "ibm")
    output = flag(rest, "output", paths.models_dir + "timo_figures/")
    dev = device(rest)

    written = []
    for path in speech_list(paths.input_speech_dir, "test"):
        base = os.path.join(paths.processed_wav_dir,
                            os.path.splitext(path)[0])
        x_t, _, X_tf = load_mixture(base)
        power = torch.as_tensor(np.abs(X_tf) ** 2, device=dev)
        with torch.no_grad():
            y_soft = (timo_vad(power)[None] if target == "vad"
                      else timo_mask(power)).cpu().numpy()
        y_hard = (y_soft > 0.5).astype(np.float32)

        for kind, mask in (("soft", y_soft), ("hard", y_hard)):
            fig = display_wav_spectro_mask(x_t, X_tf, mask)
            out = os.path.join(
                output,
                os.path.splitext(path)[0] + f"_fig_timo_{target}_{kind}.png",
            )
            os.makedirs(os.path.dirname(out), exist_ok=True)
            fig.savefig(out, dpi=40)
            written.append(out)
        print(f"{path}: wrote soft/hard timo figures")
    return written


if __name__ == "__main__":
    main()
