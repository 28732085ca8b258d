"""Script equivalents of the reference's three jupyter notebooks
(counterpart of the JAX package's examples/notebook_tours.py; reference
jupyter/inspection.ipynb, training.ipynb, visualization.ipynb):

  inspection    - load the frame / label pickles and render the dB
                  spectrogram and binary-label images;
  training      - a small SVI-based M2 training demo (the notebook's
                  DeepGenerativeModel + SVI flow: models.variational.svi
                  on the same frames);
  visualization - STFT and Lorenz-quantile IBM of the first test utterance
                  rendered as a figure.

The figures are drawn with numpy + Pillow (`viz`), in its magma colours,
and written as PNG, where the JAX tours write PDF through matplotlib
(Pillow's PDF writer needs its JPEG encoder, which not every Pillow
build has).

Usage: python -m guided_vae_nmf_torch.examples.notebook_tours
       [inspection|training|visualization ...]
       [--data_root data/subset] [--out <temp dir>/gvnmf_tours]
       [--device cuda|cpu]
       (default: all three; figures under --out)
"""

import os
import sys

import numpy as np

from ._args import device, parser


def tour_inspection(args):
    from ..data import read_dataset
    from ..viz import Figure, grid

    pickles = os.path.join(args.data_root, "pickle") + "/"
    frames = read_dataset(pickles, "train", "frames")
    labels = read_dataset(pickles, "train", "labels")
    fig = Figure((13, 8))
    (a,), (b,) = grid(2, 1, hspace=0.3)
    db = 20 * np.log10(np.maximum(frames, 1e-12))
    fig.image(a, db, float(db.min()), float(db.max()),
              title="training frames (dB)")
    fig.image(b, labels, 0.0, 1.0, title="IBM labels")
    path = os.path.join(args.out, "inspection.png")
    fig.savefig(path)
    print(f"[inspection] frames {frames.shape}, labels {labels.shape} "
          f"-> {path}")
    return {"frames": frames.shape, "labels": labels.shape, "path": path}


def tour_training(args):
    import torch

    from ..data import read_dataset
    from ..models import dgm_init
    from ..models.losses import ikatura_saito_divergence
    from ..models.variational import svi

    dev = device(args)
    pickles = os.path.join(args.data_root, "pickle") + "/"
    X = read_dataset(pickles, "train", "frames").T
    Y = read_dataset(pickles, "train", "labels").T
    model = dgm_init(torch.Generator().manual_seed(0),
                     [513, 513, 128, [256, 128]]).to(dev)
    xb = torch.tensor(X[:16].astype(np.float32), device=dev)
    yb = torch.tensor(Y[:16].astype(np.float32), device=dev)
    # the notebook's likelihood choice: IS divergence, not BCE (power
    # frames are unbounded, BCE would NaN) - jupyter/training.ipynb
    with torch.no_grad():
        out = svi(model, xb, torch.Generator(device=dev).manual_seed(1),
                  y=yb, likelihood=ikatura_saito_divergence)
    loss = float(out[0])
    print(f"[training] SVI labelled loss on a 16-frame batch: "
          f"{loss:.2f} (notebook flow: DGM z=128 h=[256,128])")
    return {"loss": loss}


def tour_visualization(args):
    from ..data import read_wav, speech_list
    from ..dsp import clean_speech_IBM, stft
    from ..viz import display_wav_spectro_mask

    raw = os.path.join(args.data_root, "raw") + "/"
    path = speech_list(raw, "test")[0]
    x, fs = read_wav(os.path.join(raw, path))
    x = x / np.max(np.abs(x))
    x_tf = stft(x)
    ibm = clean_speech_IBM(x_tf, 0.98, 0.999)
    fig = display_wav_spectro_mask(x, x_tf, ibm)
    out = os.path.join(args.out, "visualization.png")
    fig.savefig(out)
    print(f"[visualization] {os.path.basename(path)}: spectro+IBM -> {out}")
    return {"ibm": ibm, "path": out}


TOURS = {"inspection": tour_inspection, "training": tour_training,
         "visualization": tour_visualization}


def main(argv=None):
    ap = parser(__doc__, out="gvnmf_tours")
    ap.add_argument("tours", nargs="*", metavar="tour",
                    help=" | ".join(TOURS) + " (default: all three)")
    args = ap.parse_args(sys.argv[1:] if argv is None else argv)
    unknown = [t for t in args.tours if t not in TOURS]
    if unknown:
        ap.error(f"unknown tour(s) {unknown}: choose from {list(TOURS)}")
    os.makedirs(args.out, exist_ok=True)
    return {name: TOURS[name](args) for name in (args.tours or list(TOURS))}


if __name__ == "__main__":
    main()
