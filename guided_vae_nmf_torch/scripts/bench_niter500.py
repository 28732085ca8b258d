"""Paper-config (500 EM iterations) kernel experiment harness, with its
quality gate (counterpart of the JAX package's scripts/bench_niter500.py).

Times the fused engine at niter=500 on a (B, F, N) batch across kernel
variants (exact, fast, fast + bf16 matmuls, fast + bit-arithmetic exp /
log) through `guided_vae_nmf_torch.bench_niter500`, which prints its JSON
line; `--quality 1` then checks quality neutrality of the fastest variant
against exact mode on the test mixtures of a data root (oracle IBM labels,
the shipped M2-IBM; |dSI-SDR| / |dESTOI| / |dPESQ| over `--seeds`) and
prints a last JSON line with the harness's keys and "quality".

Usage: python -m guided_vae_nmf_torch.scripts.bench_niter500 [--batch 32]
       [--n 512] [--niter 500] [--peem 0] [--hybrid 0]
       [--quality 1 --seeds 4 [--approx_trans 0]]
       [--data_root data] [--dataset_size subset] [--device cuda|cpu]
"""

import json
import os
import sys

import numpy as np

from ..config import PathsConfig, apply_overrides
from ._common import device, flag

# the flags this script reads itself; the rest go to the harness
OWN = ("quality", "seeds", "approx_trans")


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    paths, argv = apply_overrides(PathsConfig(), argv)
    quality = flag(argv, "quality", 0, int)
    seeds = flag(argv, "seeds", 4, int)
    approx_trans = bool(flag(argv, "approx_trans", 0, int))
    niter = flag(argv, "niter", 500, int)
    refine = flag(argv, "hybrid", 0, int)
    rest, i = [], 0
    while i < len(argv):
        if argv[i][2:] in OWN:
            i += 2
            continue
        rest.append(argv[i])
        i += 1

    from .. import bench_niter500 as harness

    out = harness.main(rest)
    if quality:
        out["quality"] = _quality_check(
            niter, seeds, os.path.join(paths.data_root, paths.dataset_size),
            device(argv), refine=refine, approx_trans=approx_trans)
        print(json.dumps(out), flush=True)
    return out


def _quality_check(niter, seeds, subset, dev, refine=0, approx_trans=False):
    """Seed-averaged |delta| of the fastest variant against exact mode on a
    data root's test mixtures (oracle labels, shipped pretrained M2)."""
    import torch

    from ..bench_niter500 import FAST, MODEL_DIR, VARIANTS
    from ..data import read_wav, speech_list
    from ..dsp import clean_speech_IBM, istft, stft
    from ..mcem import (MCEMConfig, PEEMConfig, mcem_batch_fused,
                        peem_mcem_m2_batch)
    from ..mcem.engine import pad_power
    from ..metrics import energy_ratios, pesq, stoi
    from ._common import load_model

    m2 = load_model(MODEL_DIR, kind="dgm", y_dim=513, device=dev)
    files = speech_list(os.path.join(subset, "raw") + "/", "test")
    if not files:
        raise SystemExit(f"no test utterances under {subset}/raw/")
    base = os.path.join(subset, "processed") + "/"
    cfg = MCEMConfig(niter=niter)

    utts = []
    for p in files:
        bp = os.path.join(base, os.path.splitext(p)[0])
        x, _ = read_wav(bp + "_x.wav")
        s, _ = read_wav(bp + "_s.wav")
        n, _ = read_wav(bp + "_n.wav")
        X_tf = stft(x)
        yy = clean_speech_IBM(stft(s), 0.98, 0.999)
        utts.append((bp, x, s, n, X_tf, yy))
    N_pad = max((u[4].shape[1] + 127) // 128 * 128 for u in utts)

    def fused(m2_, Xp, m, yp, gen, **kw):
        return mcem_batch_fused(m2_, Xp, m, yp, gen, cfg, **kw)

    def run_mode(seed, engine=fused, **kw):
        mets = []
        for bp, x, s, n, X_tf, yy in utts:
            Xp, m = pad_power(torch.tensor(
                (np.abs(X_tf) ** 2).astype(np.float32), device=dev), N_pad)
            yp = torch.zeros((yy.shape[0], N_pad), device=dev)
            yp[:, :yy.shape[1]] = torch.from_numpy(
                np.asarray(yy, np.float32))
            gen = torch.Generator(device=dev).manual_seed(seed)
            out = engine(m2, Xp[None], m[None], yp[None], gen, **kw)
            WFs = out["WFs"][0].float().cpu().numpy()[:, :X_tf.shape[1]]
            sh = istft(WFs * X_tf, max_len=len(x))
            L = min(len(s), len(sh))
            mets.append((
                energy_ratios(sh[:L], s[:L], n[:L])[0],
                stoi(s[:L], sh[:L], 16000, True),
                pesq(16000, s[:L], sh[:L], "wb"),
            ))
        return np.asarray(mets)

    fast_kw = dict(VARIANTS["fast_bf16mm"])
    if approx_trans:
        fast_kw = dict(VARIANTS["fast_trans_r3"])
    engine = fused
    if refine:
        pcfg = PEEMConfig(niter=niter)
        mcfg = MCEMConfig(niter=refine)
        fast_kw = dict(FAST)

        def engine(m2_, Xp, m, yp, gen, **kw):
            return peem_mcem_m2_batch(m2_, Xp, m, yp, gen, pcfg, mcfg, **kw)
    ex, fa = [], []
    for k in range(seeds):
        ex.append(run_mode(k))
        fa.append(run_mode(k, engine=engine, **fast_kw))
        print(f"quality seed {k} done", flush=True)
    ex = np.mean(np.asarray(ex), axis=0)   # (utt, 3) seed-avg
    fa = np.mean(np.asarray(fa), axis=0)
    for i, (bp, *_rest) in enumerate(utts):
        print(f"  utt {os.path.basename(bp)}: signed d(SI-SDR/ESTOI/PESQ) "
              f"{fa[i,0]-ex[i,0]:+.3f} {fa[i,1]-ex[i,1]:+.4f} "
              f"{fa[i,2]-ex[i,2]:+.4f}", flush=True)
    d = np.abs(fa - ex)
    res = {
        "seeds": seeds,
        "mode": ("hybrid" if refine else
                 "fast_trans_r3" if approx_trans else "fast_bf16mm"),
        "mean_abs_dSISDR": round(float(d[:, 0].mean()), 4),
        "mean_abs_dESTOI": round(float(d[:, 1].mean()), 4),
        "mean_abs_dPESQ": round(float(d[:, 2].mean()), 4),
    }
    print("quality:", res, flush=True)
    return res


if __name__ == "__main__":
    main()
