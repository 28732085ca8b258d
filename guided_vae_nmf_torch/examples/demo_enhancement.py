"""End-to-end demo on a subset-layout data root and the shipped pretrained
checkpoints (counterpart of the JAX package's examples/demo_enhancement.py):
synthesize noisy mixtures, enhance them with MCEM and PEEM, report
SI-SDR / ESTOI against the mixture floor, and render an inspection figure.

Usage: python -m guided_vae_nmf_torch.examples.demo_enhancement
       [--data_root data/subset] [--out <temp dir>/gvnmf_demo]
       [--niter 50] [--device cuda|cpu] [--artifacts artifacts/pretrained]
"""

import os
import sys
import time

import numpy as np
from scipy.signal import lfilter

from ..data import create_test_mixtures, read_wav, speech_list
from ..dsp import stft
from ..mcem import MCEMConfig, PEEMConfig
from ..metrics import energy_ratios, stoi
from ..pipeline import enhance_files
from ..train import load_model
from ..viz import display_multiple_signals
from ._args import device, parser

FS = 16000


def noise_bank():
    def make(seed, kind):
        r = np.random.RandomState(seed)
        n = r.randn(FS * 60)
        if kind == "lowpass":
            n = lfilter([1], [1, -0.9], n)
        return n / np.abs(n).max()

    return {"white": make(1, "white"), "low": make(2, "lowpass")}


def report(tag, proc, est, files):
    """Prints the per-utterance lines; returns [(SI-SDR in, out, ESTOI in,
    out)]."""
    rows = []
    for name in files:
        bp = os.path.join(proc, os.path.splitext(name)[0])
        be = os.path.join(est, os.path.splitext(name)[0])
        s, _ = read_wav(bp + "_s.wav")
        n, _ = read_wav(bp + "_n.wav")
        x, _ = read_wav(bp + "_x.wav")
        sh, _ = read_wav(be + "_s_est.wav")
        ln = min(len(s), len(sh))
        row = (energy_ratios(x[:ln], s[:ln], n[:ln])[0],
               energy_ratios(sh[:ln], s[:ln], n[:ln])[0],
               stoi(s[:ln], x[:ln], FS, True), stoi(s[:ln], sh[:ln], FS, True))
        rows.append(row)
        print(f"  [{tag}] {os.path.basename(name)}: "
              f"SI-SDR {row[0]:+.2f} -> {row[1]:+.2f} dB | "
              f"ESTOI {row[2]:.3f} -> {row[3]:.3f}")
    return rows


def main(argv=None):
    ap = parser(__doc__, out="gvnmf_demo")
    ap.add_argument("--niter", type=int, default=50,
                    help="EM iterations of MCEM and of PEEM")
    args = ap.parse_args(sys.argv[1:] if argv is None else argv)
    dev = device(args)
    raw = os.path.join(args.data_root, "raw") + "/"
    proc = os.path.join(args.out, "proc") + "/"

    print("1) synthesizing test mixtures (0 dB SNR, 2 noise types)...")
    create_test_mixtures(raw, proc, noise_bank(), dataset_type="test",
                         snrs=(0.0,), noise_types=("white", "low"))
    files = speech_list(raw, "test")

    m2 = load_model(os.path.join(args.artifacts, "M2_ibm"), kind="dgm",
                    y_dim=513, device=dev)

    print(f"2) MCEM enhancement (oracle IBM guidance, {args.niter} EM "
          "iterations)...")
    t0 = time.time()
    est = os.path.join(args.out, "est_mcem")
    enhance_files(files, proc, est, m2, model_type="m2",
                  classif_type="oracle", cfg=MCEMConfig(niter=args.niter),
                  batch_size=4, device=dev)
    print(f"   {time.time() - t0:.1f}s for {len(files)} utterances "
          "(includes the kernels' one-time build on a fresh checkout)")
    out = {"MCEM": report("MCEM", proc, est, files)}

    print(f"3) PEEM enhancement (gradient E-step, {args.niter} EM "
          "iterations)...")
    t0 = time.time()
    est_p = os.path.join(args.out, "est_peem")
    enhance_files(files, proc, est_p, m2, model_type="m2",
                  classif_type="oracle", cfg=PEEMConfig(niter=args.niter),
                  batch_size=4, device=dev)
    print(f"   {time.time() - t0:.1f}s")
    out["PEEM"] = report("PEEM", proc, est_p, files)

    print("4) inspection figure...")
    name = files[0]
    bp = os.path.join(proc, os.path.splitext(name)[0])
    be = os.path.join(est, os.path.splitext(name)[0])
    x, _ = read_wav(bp + "_x.wav")
    s, _ = read_wav(bp + "_s.wav")
    sh, _ = read_wav(be + "_s_est.wav")
    fig = display_multiple_signals(
        [[s, stft(s), None], [x, stft(x), None], [sh, stft(sh), None]],
        titles=["clean", "mixture", "enhanced"],
    )
    fig_path = os.path.join(args.out, "demo.png")
    fig.savefig(fig_path, dpi=50)
    print(f"   wrote {fig_path}")
    out["figure"] = fig_path
    return out


if __name__ == "__main__":
    main()
