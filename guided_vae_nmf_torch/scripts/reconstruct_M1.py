"""Qualitative VAE analysis-resynthesis: for each test utterance, run the
M1 VAE forward on the device over the noisy power spectrogram and save a
3-panel dB-spectrogram figure (reference scripts/reconstruct_M1.py:
66-163).

Usage: python -m guided_vae_nmf_torch.scripts.reconstruct_M1
       --model <ckpt-or-dir> [--dataset_size subset] [--data_root data]
       [--output <dir>] [--device cuda|cpu]
"""

import os
import sys

import numpy as np
import torch

from ..config import PathsConfig, apply_overrides
from ..data import speech_list
from ..pipeline import load_mixture
from ..viz import Figure, grid, power_to_db
from ._common import device, flag, load_model


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    paths, rest = apply_overrides(PathsConfig(), argv)
    model_path = flag(rest, "model", paths.models_dir)
    output = flag(rest, "output", paths.models_dir + "M1_reconstruct/")
    dev = device(rest)

    vae = load_model(model_path, kind="vae", device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    written = []
    for path in speech_list(paths.input_speech_dir, "test"):
        base = os.path.join(paths.processed_wav_dir,
                            os.path.splitext(path)[0])
        _, _, X_tf = load_mixture(base)
        power = np.abs(X_tf) ** 2
        with torch.no_grad():
            r, _, _ = vae(torch.as_tensor(power.T, device=dev), gen)
        recon = r.cpu().numpy().T  # decoded variance, (bins, frames)

        fig = Figure((12, 12))
        cells = grid(3, 2, width_ratios=[20, 1], hspace=0.3, wspace=0.05)
        for i, (title, S) in enumerate([
            ("noisy power", power),
            ("VAE reconstruction (variance)", recon),
            ("residual (dB difference)", np.abs(power - recon)),
        ]):
            fig.image(cells[i][0], power_to_db(S), -40, 20, title=title)
            fig.colorbar(cells[i][1], -40, 20)
        out = os.path.join(output, os.path.splitext(path)[0] + "_recon.png")
        os.makedirs(os.path.dirname(out), exist_ok=True)
        fig.savefig(out, dpi=60)
        written.append(out)
        print(f"wrote {out}")
    return written


if __name__ == "__main__":
    main()
