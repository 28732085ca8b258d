"""Behavioral parity harness (counterpart of the JAX package's
scripts/validate_parity.py): train a subset M2, enhance a data root's test
mixtures with the port's batched MCEM and, where the reference repository
is given, with the reference's torch MCEM loaded with identical weights,
and print side-by-side SI-SDR / ESTOI / PESQ.

The port's half ("ours") always runs; the reference half needs the
reference repository's Python tree (`--reference <dir>` holding
`python/models/`) and is skipped without it.

Without `--seeds`, both halves run once (`--engine` other than report /
paired / paired-report does not matter there). Engines (`--engine`) with
`--seeds K`: both (default) | ours | peem | ref, seed-averaged (per-seed
metrics persist in `<work>/gate_<engine>_niter<N>.json`, so runs
resume); report (the seed-averaged table); paired
(common random numbers: the reference's torch RNG stream for seed k,
replayed by `models.torch_import.record_reference_stream` through the
eager engine `mcem.engine.mcem_run(noise=..., init_nmf=...)`; per-seed
engine deltas where the reference runs too); paired-report.

Usage: python -m guided_vae_nmf_torch.scripts.validate_parity
       [--work <dir>] [--epochs 150] [--niter 50] [--seeds 0]
       [--engine both|ours|peem|ref|report|paired|paired-report]
       [--utts <substring[,substring]>] [--reference <dir>]
       [--data_root data] [--dataset_size subset] [--device cuda|cpu]

--work defaults to `<temp dir>/gvnmf_quality` and is kept (the training
store, the test mixtures, the M2 and the gate stores are reused).
"""

import json
import os
import sys
import tempfile
import time

import numpy as np

from ..config import PathsConfig, apply_overrides
from ..data import read_wav, speech_list
from ..dsp import clean_speech_IBM, istft, stft
from ..metrics import energy_ratios, pesq, stoi
from ._common import device, flag

FS = 16000


def make_noise(seed, kind):
    r = np.random.RandomState(seed)
    n = r.randn(FS * 60)
    if kind == "lowpass":
        from scipy.signal import lfilter

        n = lfilter([1], [1, -0.9], n)
    return n / np.abs(n).max()


def collect_metrics(bp, s_hat):
    """(si_sdr, estoi, pesq_wb) of an enhanced track against the sources."""
    s, _ = read_wav(bp + "_s.wav")
    n, _ = read_wav(bp + "_n.wav")
    L = min(len(s), len(s_hat))
    s, n, sh = s[:L], n[:L], s_hat[:L]
    return (energy_ratios(sh, s, n)[0], stoi(s, sh, FS, True),
            pesq(FS, s, sh, "wb"))


def metrics_line(tag, name, bp, s_hat):
    s, _ = read_wav(bp + "_s.wav")
    n, _ = read_wav(bp + "_n.wav")
    x, _ = read_wav(bp + "_x.wav")
    L = min(len(s), len(s_hat))
    s, n, x = s[:L], n[:L], x[:L]
    sdr, est, psq = collect_metrics(bp, s_hat)
    print(f"{name} {tag}: SI-SDR {energy_ratios(x, s, n)[0]:.1f} -> "
          f"{sdr:.1f} dB | "
          f"ESTOI {stoi(s, x, FS, True):.3f} -> {est:.3f}"
          f" | PESQ {pesq(FS, s, x, 'wb'):.2f} -> {psq:.2f}")


def has_reference(reference):
    return bool(reference) and os.path.isdir(os.path.join(reference,
                                                           "python"))


def reference_model(m2, reference):
    """The reference's torch `DeepGenerativeModel` loaded with the port's
    M2 weights (via export_vae), frozen for inference."""
    import torch

    from ..models import export_vae

    if reference not in sys.path:
        sys.path.insert(0, reference)
    from python.models.models import DeepGenerativeModel

    tm = DeepGenerativeModel([513, 513, 32, [128, 128]], None)
    sd = {k: torch.from_numpy(np.asarray(v).copy())
          for k, v in export_vae(m2).items()}
    tm.load_state_dict(sd)
    tm.eval()
    for p in tm.parameters():
        p.requires_grad = False
    return tm


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    paths, argv = apply_overrides(PathsConfig(), argv)
    work = flag(argv, "work", os.path.join(tempfile.gettempdir(),
                                           "gvnmf_quality"))
    epochs = flag(argv, "epochs", 150, int)
    niter = flag(argv, "niter", 50, int)
    reference = flag(argv, "reference", None)
    dev = device(argv)
    os.makedirs(work, exist_ok=True)

    from ..data import create_noisy_frames, create_test_mixtures
    from ..data.h5io import H5FrameReader
    from ..mcem import MCEMConfig
    from ..pipeline import enhance_files
    from ..train import TrainConfig, best_checkpoint, load_model, train_m2

    raw = os.path.join(paths.data_root, paths.dataset_size, "raw") + "/"
    proc = os.path.join(work, "proc") + "/"
    noise = {"white": make_noise(1, "white"), "low": make_noise(2, "lowpass")}
    h5 = os.path.join(work, "noisy.h5")
    if not os.path.exists(h5):
        create_noisy_frames(raw, h5, {"train": noise, "validation": noise},
                            dataset_types=("train", "validation"),
                            labels="noisy_labels", quantile_fraction=0.999,
                            snrs=(-5, 0, 5))
        create_test_mixtures(raw, proc, noise, dataset_type="test",
                             snrs=(0.0,), noise_types=("white", "low"))

    mdir = os.path.join(work, "M2")
    if best_checkpoint(mdir) is None:
        r = H5FrameReader(h5, "train")
        Xtr, Ytr = r.load_all()
        r.close()
        r = H5FrameReader(h5, "validation")
        Xva, Yva = r.load_all()
        r.close()
        cfg = TrainConfig(end_epoch=epochs, batch_size=256)
        _, hist = train_m2((Xtr, Ytr), (Xva, Yva),
                           dims=(513, 513, 32, (128, 128)), cfg=cfg,
                           model_dir=mdir, name="M2", device=dev)
        print(f"M2 best valid {min(h['valid'] for h in hist):.1f}")
    m2 = load_model(best_checkpoint(mdir), kind="dgm", y_dim=513,
                    device=dev)

    files = speech_list(raw, "test")
    # --utts <substring[,substring]>: restrict the gate study to matching
    # utterances
    only = flag(argv, "utts")
    if only:
        subs = only.split(",")
        files = [f for f in files if any(s in f for s in subs)]
        if not files:
            raise SystemExit(f"--utts {only!r} matched nothing")
    mc = MCEMConfig(niter=niter)
    seeds = flag(argv, "seeds", 0, int)
    engine = flag(argv, "engine", "both")
    if engine == "report":
        return gate_report(work, files, niter)
    if engine == "paired":
        return paired_seeds(work, files, m2, mc, seeds or 8, reference)
    if engine == "paired-report":
        return paired_report(work, files, niter)
    if seeds:
        return seed_averaged(work, files, m2, mc, seeds, engine, reference,
                             dev)

    est = os.path.join(work, "est") + "/"
    t0 = time.time()
    enhance_files(files, proc, est, m2, model_type="m2",
                  classif_type="oracle", cfg=mc, batch_size=4, device=dev)
    print(f"[ours] batched enhancement: {time.time() - t0:.1f}s total")
    for name in files:
        bp = os.path.join(proc, os.path.splitext(name)[0])
        sh, _ = read_wav(os.path.join(est, os.path.splitext(name)[0])
                         + "_s_est.wav")
        metrics_line("OURS", os.path.basename(name), bp, sh)

    if not has_reference(reference):
        print("reference tree absent; skipping torch half")
        return None
    tm = reference_model(m2, reference)
    for name in files:
        bp = os.path.join(proc, os.path.splitext(name)[0])
        t0 = time.time()
        sh = run_reference_engine(tm, bp, mc)
        metrics_line(f"REF ({time.time() - t0:.0f}s)",
                     os.path.basename(name), bp, sh)
    return None


def run_reference_engine(tm, bp, mc):
    """One utterance through the reference's torch MCEM_M2 (oracle IBM).

    Takes the full MCEMConfig (not just niter) so nmf_rank / eps always
    match what record_reference_stream reads: the common-random-numbers
    pairing desynchronizes if the two halves ever disagree."""
    import torch

    from python.models.mcem import MCEM_M2

    x_t, _ = read_wav(bp + "_x.wav")
    s_t, _ = read_wav(bp + "_s.wav")
    X = stft(x_t).T
    y = clean_speech_IBM(stft(s_t), 0.98, 0.999)
    mcem = MCEM_M2(niter=mc.niter, nsamples_E_step=mc.nsamples_E_step,
                   burnin_E_step=mc.burnin_E_step, nsamples_WF=mc.nsamples_WF,
                   burnin_WF=mc.burnin_WF, var_RW=mc.var_RW)
    mcem.init_parameters(X=X, y=torch.from_numpy(y.T.copy()), vae=tm,
                         nmf_rank=mc.nmf_rank, eps=mc.eps, device="cpu")
    mcem.run()
    return istft(mcem.S_hat, max_len=len(x_t))


def _gate_store(work, engine, niter):
    return os.path.join(work, f"gate_{engine}_niter{niter}.json")


def _load_gate(path):
    if os.path.exists(path):
        with open(path) as f:
            return json.load(f)
    return {}


def _save_gate(path, data):
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(data, f)
    os.replace(tmp, path)


def seed_averaged(work, files, m2, mc, seeds, engine="both", reference=None,
                  dev=None):
    """Quality gate over seeds: the MH trajectories are stochastic, so one
    run's PESQ / ESTOI carries MH sampling noise ~0.05. Averaging K
    independent seeds on both engines isolates the systematic
    engine-against-engine delta.

    Per-seed metrics persist to gate_{ours,peem,ref}_niter{N}.json in
    `work`, so long runs resume where they stopped and the two engine
    halves can run as separate processes. `--engine report` prints the
    table with 95% t-CIs on every delta from whatever has accumulated."""
    from ..mcem import PEEMConfig
    from ..pipeline import enhance_files

    proc = os.path.join(work, "proc") + "/"
    if engine in ("both", "ours", "peem"):
        tag = "ours" if engine != "peem" else "peem"
        cfg = mc if tag == "ours" else PEEMConfig(niter=mc.niter)
        path = _gate_store(work, tag, mc.niter)
        done = _load_gate(path)
        for k in range(seeds):
            if str(k) in done:
                continue
            est = os.path.join(work, f"est_{tag}_s{k}") + "/"
            t0 = time.time()
            enhance_files(files, proc, est, m2, model_type="m2",
                          classif_type="oracle", cfg=cfg, batch_size=4,
                          seed=k, device=dev)
            wall = time.time() - t0
            row = {}
            for name in files:
                bp = os.path.join(proc, os.path.splitext(name)[0])
                be = os.path.join(est, os.path.splitext(name)[0])
                sh, _ = read_wav(be + "_s_est.wav")
                row[name] = collect_metrics(bp, sh)
            row["_wall_s"] = wall
            done[str(k)] = row
            _save_gate(path, done)
            print(f"[{tag}] seed {k} done ({wall:.1f}s)", flush=True)

    if engine in ("both", "ref"):
        if not has_reference(reference):
            print("reference tree absent; skipping torch half")
        else:
            import torch

            tm = reference_model(m2, reference)
            path = _gate_store(work, "ref", mc.niter)
            done = _load_gate(path)
            for k in range(seeds):
                if str(k) in done:
                    continue
                torch.manual_seed(k)
                row = {}
                for name in files:
                    bp = os.path.join(proc, os.path.splitext(name)[0])
                    sh = run_reference_engine(tm, bp, mc)
                    row[name] = collect_metrics(bp, sh)
                done[str(k)] = row
                _save_gate(path, done)
                print(f"[ref] seed {k} done", flush=True)

    gate_report(work, files, mc.niter)


def gate_report(work, files, niter):
    """Seed-averaged delta table with 95% t-CIs from the persisted
    per-seed stores (the seeds present in both engines' stores)."""
    from scipy import stats as sps

    o_all = _load_gate(_gate_store(work, "ours", niter))
    r_all = _load_gate(_gate_store(work, "ref", niter))
    common = sorted(set(o_all) & set(r_all), key=int)
    if not common:
        print("no common seeds recorded yet")
        return
    K = len(common)
    print(f"\nSeed-averaged engine-vs-engine deltas ({K} seeds, "
          f"niter={niter}):")
    hdr = ("utterance", "metric", "ours mean±sd", "ref mean±sd",
           "Δmean", "95% CI")
    print("{:<14} {:<7} {:>14} {:>14} {:>8} {:>18}".format(*hdr))
    # K=1: sd / CI are undefined (ddof=1 variance of one sample, t with
    # df=0): print means with zero spread instead of NaNs
    tcrit = sps.t.ppf(0.975, K - 1) if K > 1 else 0.0
    sd = ((lambda v: v.std(ddof=1)) if K > 1
          else (lambda v: 0.0))
    var1 = ((lambda v: v.var(ddof=1)) if K > 1
            else (lambda v: 0.0))
    agg = {"SI-SDR": [], "ESTOI": [], "PESQ": []}
    for name in files:
        o = np.asarray([o_all[s][name] for s in common])
        r = np.asarray([r_all[s][name] for s in common])
        for i, met in enumerate(("SI-SDR", "ESTOI", "PESQ")):
            # seeds are independent draws of the same MH process, so the
            # unpaired Welch CI bounds the mean difference
            d = o[:, i].mean() - r[:, i].mean()
            se = np.sqrt(var1(o[:, i]) / K + var1(r[:, i]) / K)
            agg[met].append(d)
            print("{:<14} {:<7} {:>7.3f}±{:<5.3f} {:>7.3f}±{:<5.3f} "
                  "{:>+8.3f} [{:+.3f}, {:+.3f}]".format(
                      os.path.basename(name), met,
                      o[:, i].mean(), sd(o[:, i]),
                      r[:, i].mean(), sd(r[:, i]), d,
                      d - tcrit * se, d + tcrit * se))
    for met, ds in agg.items():
        print(f"mean |Δ{met}| over utterances: "
              f"{np.abs(np.asarray(ds)).mean():.4f}")

    p_all = _load_gate(_gate_store(work, "peem", niter))
    if p_all:
        pk = sorted(p_all, key=int)
        Kp = len(pk)
        print(f"\nPEEM (gradient E-step) vs MCEM ours, {Kp} seeds, "
              f"niter={niter}:")
        print("{:<14} {:<7} {:>14} {:>14} {:>8}".format(
            "utterance", "metric", "peem mean±sd", "mcem mean±sd",
            "Δ(peem-mcem)"))
        for name in files:
            p = np.asarray([p_all[s][name] for s in pk])
            o = np.asarray([o_all[s][name] for s in common])
            for i, met in enumerate(("SI-SDR", "ESTOI", "PESQ")):
                print("{:<14} {:<7} {:>7.3f}±{:<5.3f} {:>7.3f}±{:<5.3f} "
                      "{:>+8.3f}".format(
                          os.path.basename(name), met,
                          p[:, i].mean(), p[:, i].std(ddof=1),
                          o[:, i].mean(), o[:, i].std(ddof=1),
                          p[:, i].mean() - o[:, i].mean()))
        pw = [p_all[s].get("_wall_s") for s in pk]
        ow = [o_all[s].get("_wall_s") for s in common]
        pw = [w for w in pw if w]
        ow = [w for w in ow if w]
        if pw and ow:
            # steady-state walls (skip each store's first seed)
            ps = np.median(pw[1:] or pw)
            osd = np.median(ow[1:] or ow)
            print(f"wall/seed (3-utt batch, median): peem {ps:.1f}s, "
                  f"mcem {osd:.1f}s -> speedup x{osd / ps:.1f}")


def ours_replayed(m2, bp, seed, mc):
    """One utterance through the port's eager engine under the reference's
    recorded randomness for torch seed `seed` (oracle IBM); returns the
    enhanced waveform."""
    import torch

    from ..mcem.engine import mcem_run
    from ..models import record_reference_stream

    dev = m2.decoder.out.w.device
    x_t, _ = read_wav(bp + "_x.wav")
    s_t, _ = read_wav(bp + "_s.wav")
    X = stft(x_t).T  # (N, F) complex
    y = clean_speech_IBM(stft(s_t), 0.98, 0.999)  # (F, N)
    Nfrm, Fdim = X.shape
    L = m2.encoder.mu.w.shape[1]
    W0, H0, g0, noise = record_reference_stream(seed, Fdim, Nfrm, L, mc)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32))[
            None].to(dev)

    out = mcem_run(m2, t(np.abs(X.T) ** 2), t(np.ones((Nfrm,))), t(y), [0],
                   mc, init_nmf=(t(W0), t(H0), t(g0)),
                   noise=tuple(t(a) for a in noise))
    return istft(out["WFs"][0].cpu().numpy() * X.T, max_len=len(x_t))


def paired_seeds(work, files, m2, mc, seeds, reference=None):
    """Common-random-numbers gate: the reference run from
    torch.manual_seed(k), and its exact RNG stream replayed through the
    port's eager engine (record_reference_stream -> mcem_run(noise=...,
    init_nmf=...)); the two halves are differenced per seed, so the MH
    randomness cancels and the per-seed delta is the numerical engine
    difference. Without the reference tree only the port's half runs and
    its metrics are recorded."""
    import torch

    with_ref = has_reference(reference)
    if with_ref:
        tm = reference_model(m2, reference)
    else:
        print("reference tree absent; the port's half only")
    proc = os.path.join(work, "proc") + "/"
    path = _gate_store(work, "paired", mc.niter)
    done = _load_gate(path)
    for k in range(seeds):
        # resume at (seed, utterance) granularity
        row = dict(done.get(str(k), {}))
        for name in files:
            if name in row and ("ref" in row[name] or not with_ref):
                continue
            bp = os.path.join(proc, os.path.splitext(name)[0])
            rec = {}
            t_ref = 0.0
            if with_ref:
                torch.manual_seed(k)
                t0 = time.time()
                sh_ref = run_reference_engine(tm, bp, mc)
                t_ref = time.time() - t0
                rec["ref"] = collect_metrics(bp, sh_ref)
            t0 = time.time()
            sh_ours = ours_replayed(m2, bp, k, mc)
            t_ours = time.time() - t0
            rec["ours"] = collect_metrics(bp, sh_ours)
            if with_ref:
                rec["wav_rel_l2"] = float(np.linalg.norm(sh_ours - sh_ref)
                                          / np.linalg.norm(sh_ref))
                print(f"[paired] seed {k} {os.path.basename(name)}: "
                      f"dPESQ {rec['ours'][2] - rec['ref'][2]:+.4f}"
                      f" wav_rel_l2 {rec['wav_rel_l2']:.2e}"
                      f" (ref {t_ref:.0f}s ours {t_ours:.0f}s)", flush=True)
            else:
                print(f"[paired] seed {k} {os.path.basename(name)}: ours "
                      f"SI-SDR {rec['ours'][0]:.2f} ESTOI "
                      f"{rec['ours'][1]:.3f} PESQ {rec['ours'][2]:.3f} "
                      f"({t_ours:.0f}s)", flush=True)
            row[name] = rec
            done[str(k)] = row
            _save_gate(path, done)
    paired_report(work, files, mc.niter)


def paired_report(work, files, niter):
    """Paired per-seed delta table (mean, sd, 95% t-CI) from the
    gate_paired store (the records that hold both halves)."""
    from scipy import stats as sps

    all_ = _load_gate(_gate_store(work, "paired", niter))
    ks = sorted(all_, key=int)
    if not any("ref" in r for s in ks for r in all_[s].values()):
        print("no paired seeds recorded yet")
        return
    K = len(ks)
    print(f"\nPaired (common-random-numbers) engine deltas "
          f"({K} seeds, niter={niter}; randomness cancelled, numerical "
          f"difference only):")
    tcrit = sps.t.ppf(0.975, K - 1) if K > 1 else 0.0
    for name in files:
        rows = [all_[s][name] for s in ks
                if name in all_[s] and "ref" in all_[s][name]]
        if not rows:
            continue
        d = np.asarray([np.asarray(r["ours"]) - np.asarray(r["ref"])
                        for r in rows])
        l2 = np.asarray([r["wav_rel_l2"] for r in rows])
        for i, met in enumerate(("SI-SDR", "ESTOI", "PESQ")):
            m, s = d[:, i].mean(), (d[:, i].std(ddof=1) if K > 1 else 0.0)
            se = s / np.sqrt(K)
            print(f"  {os.path.basename(name):<14} {met:<7} "
                  f"paired Δ {m:+.4f} ± {s:.4f}  "
                  f"95% CI [{m - tcrit * se:+.4f}, {m + tcrit * se:+.4f}]")
        print(f"  {os.path.basename(name):<14} wav_rel_l2 "
              f"mean {l2.mean():.3e} max {l2.max():.3e}")


if __name__ == "__main__":
    main()
