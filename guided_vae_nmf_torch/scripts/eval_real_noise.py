"""Real-noise system matrix on a data root's test mixtures (counterpart of
the JAX package's scripts/eval_real_noise.py).

Each system enhances the test mixtures of `<data_root>/<dataset_size>/`
(the reference layout) and the script prints SI-SDR (mixture -> enhanced),
ESTOI and PESQ-wb per utterance. Systems: `m2dnn_<noise model>` (M2-IBM
with the DNN classifier), `m2oracle_<noise model>` (oracle IBM labels),
`m1_<noise model>` (unguided M1) and `wiener` (the Wiener-DNN baseline),
with the noise models nmf, spp, spp2 and hybrid.

Usage: python -m guided_vae_nmf_torch.scripts.eval_real_noise
       [--artifacts artifacts/pretrained] [--niter 100]
       [--systems m2dnn_spp,m2oracle_spp,wiener,m1_spp]
       [--work <dir>] [--noise_gain 0] [--noise_gain_bands 1]
       [--soft_labels 0] [--seeds 1] [--algorithm mcem|peem]
       [--profile <name>] [--data_root data] [--dataset_size subset]
       [--device cuda|cpu]

--noise_gain 1 enables the per-frame noise gain (MCEMConfig.noise_gain)
on the fixed-noise systems (spp/spp2 suffixes only). --seeds N repeats
each MCEM system with N independent seeds and reports mean±sd per
utterance. --profile names a validated preset (profiles.py), authoritative
for the noise model, soft labels and noise gain; without --systems it
selects `m2dnn_<its noise model>`. --work defaults to a temporary
directory, removed at the end; a given one keeps every system's output
under `<work>/<artifacts with / as _>/<system>[_soft]_seed<k>/`.
"""

import os
import shutil
import sys
import tempfile
import time

import numpy as np

from ..config import PathsConfig, apply_overrides
from ..data import read_wav, speech_list
from ..metrics import energy_ratios, pesq, stoi
from ._common import device, flag, load_model, load_norm_stats

FS = 16000


def metrics_for(processed, est_dir, files):
    rows = []
    for p in files:
        bp = os.path.join(processed, os.path.splitext(p)[0])
        be = os.path.join(est_dir, os.path.splitext(p)[0])
        s, _ = read_wav(bp + "_s.wav")
        n, _ = read_wav(bp + "_n.wav")
        x, _ = read_wav(bp + "_x.wav")
        sh, _ = read_wav(be + "_s_est.wav")
        L = min(len(s), len(sh))
        s, n, x, sh = s[:L], n[:L], x[:L], sh[:L]
        rows.append((
            energy_ratios(x, s, n)[0], energy_ratios(sh, s, n)[0],
            stoi(s, sh, FS, True), pesq(FS, s, sh, "wb"),
        ))
    return rows


def system_dir(work, artifacts, sysname, suffix, seed):
    return os.path.join(work, artifacts.replace("/", "_"),
                        sysname + suffix + f"_seed{seed}")


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    paths, argv = apply_overrides(PathsConfig(), argv)
    artifacts = flag(argv, "artifacts", "artifacts/pretrained")
    niter = flag(argv, "niter", 100, int)
    work = flag(argv, "work", None)
    systems = flag(
        argv, "systems", "m2dnn_spp,m2oracle_spp,wiener,m1_spp").split(",")
    soft_labels = flag(argv, "soft_labels", "0") in ("1", "true")
    noise_gain = flag(argv, "noise_gain", "0") in ("1", "true")
    ng_bands = flag(argv, "noise_gain_bands", 1, int)
    seeds = flag(argv, "seeds", 1, int)
    algo = flag(argv, "algorithm", "mcem")
    dev = device(argv)

    profile = flag(argv, "profile", None)
    if profile is not None:
        # validated preset (profiles.py): authoritative for the managed
        # knobs; also selects the flagship system at the preset's noise
        # model unless --systems was given explicitly
        from ..profiles import get_profile

        prof = get_profile(profile)
        soft_labels = prof.soft_guidance
        if not prof.offline:
            raise SystemExit(f"profile {profile!r} is streaming-only "
                             "(use eval_streaming_m2)")
        noise_gain = prof.cfg_overrides.get("noise_gain", False)
        ng_bands = prof.cfg_overrides.get("noise_gain_bands", 1)
        if flag(argv, "systems") is None:
            systems = [f"m2dnn_{prof.noise_model}"]

    from ..mcem import MCEMConfig, PEEMConfig
    from ..pipeline import enhance_files, enhance_files_wiener

    subset = os.path.join(paths.data_root, paths.dataset_size)
    files = speech_list(os.path.join(subset, "raw") + "/", "test")
    processed = os.path.join(subset, "processed") + "/"
    cfg_cls = PEEMConfig if algo == "peem" else MCEMConfig
    cfg = cfg_cls(niter=niter, noise_gain=noise_gain,
                  noise_gain_bands=ng_bands)

    own = work is None
    if own:
        work = tempfile.mkdtemp(prefix="gvnmf_real_noise_")
    try:
        m2 = load_model(os.path.join(artifacts, "M2_ibm"), kind="dgm",
                        y_dim=513, device=dev)
        results = {}
        for sysname in systems:
            suffix = ("_soft" if soft_labels and sysname.startswith("m2dnn_")
                      else "")
            t0 = time.perf_counter()
            # model weights / norm stats are seed-independent: load once
            if sysname.startswith("m2dnn_"):
                cls = load_model(os.path.join(artifacts, "classifier_ibm"),
                                 kind="classifier", device=dev)
                mean, std = load_norm_stats(
                    os.path.join(artifacts, "classifier_ibm"))
            elif sysname.startswith("m1_"):
                m1 = load_model(os.path.join(artifacts, "M1"), kind="vae",
                                device=dev)
            elif sysname == "wiener":
                w = load_model(os.path.join(artifacts, "wiener"),
                               kind="classifier", device=dev)
                mean, std = load_norm_stats(os.path.join(artifacts,
                                                         "wiener"))
            elif not sysname.startswith("m2oracle_"):
                raise SystemExit(f"unknown system {sysname}")
            per_seed = []
            # deterministic systems run once whatever --seeds says: the
            # wiener baseline has no sampling, and PEEM's only use of the
            # seed is the NMF init, bypassed by the fixed-noise models
            deterministic = sysname == "wiener" or (
                algo == "peem"
                and sysname.split("_", 1)[-1] in ("spp", "spp2"))
            for seed in range(1 if deterministic else seeds):
                out = system_dir(work, artifacts, sysname, suffix, seed)
                nm = sysname.split("_", 1)[-1]
                if sysname.startswith("m2dnn_"):
                    enhance_files(files, processed, out, m2, model_type="m2",
                                  classif_type="dnn", classifier=cls,
                                  mean=mean, std=std, cfg=cfg, batch_size=4,
                                  noise_model=nm, soft_guidance=soft_labels,
                                  seed=seed, device=dev)
                elif sysname.startswith("m2oracle_"):
                    enhance_files(files, processed, out, m2, model_type="m2",
                                  classif_type="oracle", cfg=cfg,
                                  batch_size=4, noise_model=nm, seed=seed,
                                  device=dev)
                elif sysname.startswith("m1_"):
                    enhance_files(files, processed, out, m1, model_type="m1",
                                  cfg=cfg, batch_size=4, noise_model=nm,
                                  seed=seed, device=dev)
                else:
                    enhance_files_wiener(files, processed, out, w, mean=mean,
                                         std=std, device=dev)
                per_seed.append(metrics_for(processed, out, files))
            results[sysname] = per_seed
            print(f"[{sysname}] done in {time.perf_counter() - t0:.1f}s "
                  f"({len(per_seed)} seed(s))", flush=True)
    finally:
        if own:
            shutil.rmtree(work, ignore_errors=True)

    print(f"\nReal-noise QUT table ({artifacts}, niter={niter}, "
          f"seeds={seeds}):")
    print(f"{'system':<14}" + "".join(
        f"{os.path.basename(f)[:-4]:>30}" for f in files))
    for sysname, per_seed in results.items():
        arr = np.asarray(per_seed)          # (S, n_files, 4)
        mean_ = arr.mean(axis=0)
        sd = arr.std(axis=0)
        cells = []
        for j in range(arr.shape[1]):
            a, bdb, e, p = mean_[j]
            if arr.shape[0] > 1:
                cells.append(f"{a:+.2f}->{bdb:+.2f}±{sd[j][1]:.2f} "
                             f"{e:.3f} {p:.2f}")
            else:
                cells.append(f"{a:+.2f}->{bdb:+.2f} {e:.3f} {p:.2f}")
        print(f"{sysname:<14}" + "".join(f"{c:>30}" for c in cells))
    print("(cells: SI-SDR mix->enh dB [±sd over seeds], ESTOI, PESQ-wb)")
    return results


if __name__ == "__main__":
    main()
