"""Designed-scale evaluation campaign (counterpart of the JAX package's
scripts/eval_campaign.py): runs the reference's full metric protocol
(per-input-SNR 95%-CI aggregation, reference python/metrics.py:70-130,
scripts/run_metrics_M2.py:236-244) over a synthesized corpus.

It synthesizes a speaker-disjoint multi-speaker test corpus (phase-vocoder
voice variants x balanced SNR grid x rotating noise families), retrains
every model family on an enlarged speaker-disjoint bank, sweeps the
systems / profiles, and prints the reference-format mean±CI tables per
input SNR, plus the per-noise-family classifier F1.

Speaker-disjoint splits over the clean utterances of
`<data_root>/<dataset_size>/raw/` (the reference subset: 21 utterances,
7 speakers):
  train: WSJ 011 (si_tr_s) + NTCD Lipspkr1, 01M          (9 utts)
  valid: WSJ 050 (si_dt_05)                              (3 utts)
  test : WSJ 440 (si_et_05) + NTCD 08F, 34M              (9 utts)
Test noise is drawn from a different bank seed than training (held-out
noise instances); babble is built from training speech only.

Usage: python -m guided_vae_nmf_torch.scripts.eval_campaign [--work <dir>]
       [--models <dir>|retrain] [--voices 9] [--snrs -5,0,5] [--niter 100]
       [--epochs 200] [--train_voices 5] [--systems mixture,...]
       [--batch_size 16] [--seed 0] [--seeds 1] [--max_workers 8]
       [--objective 1] [--cls_features log-power] [--cls_quantile 0.98]
       [--cls_pos_weight auto] [--cls_calibrate 1] [--smoke 1]
       [--prep_only 1] [--skip_done 1] [--data_root data]
       [--dataset_size subset] [--device cuda|cpu]

--work defaults to `<temp dir>/gvnmf_campaign` (`_smoke` appended with
--smoke 1) and is kept: the corpus, the training bank, the models, each
system's output and `campaign_results.json`, into which later runs merge.
"""

import glob
import json
import os
import shutil
import sys
import tempfile
import time

import numpy as np

from ..config import PathsConfig, apply_overrides
from .pretrain_subset import load_clean as _load_clean
from ._common import backend_info, device, flag, load_model, load_norm_stats

FS = 16000
# QUT-analogue test families (reference qut_database.py:46-51 uses
# {cafe, car, home-kitchen, street-city}; the synthetic analogues are
# cafe / car / clatter (impulsive kitchen) / babble)
TEST_FAMILIES = ("cafe", "car", "clatter", "babble")
TEST_BANK_SEED = 202         # != the training bank's seed (11)

ALL_SYSTEMS = ("mixture", "m2dnn_reference", "m2dnn_real-noise",
               "m2dnn_impulse-noise", "wiener", "m1_spp",
               "m1spp_real-noise", "m1spp_impulse-noise",
               "m2oracle_reference", "m2oracle_real-noise",
               "m2vaddnn_real-noise", "m2vadoracle_real-noise")

# Systems whose MCEM E-step is MH-stochastic: only these need per-seed
# replication for error bars (wiener / mixture are deterministic)
STOCHASTIC_PREFIXES = ("m2dnn_", "m2oracle_", "m2vaddnn_", "m2vadoracle_",
                       "m1_spp", "m1spp_")


def _wsj(subset, split, spk):
    return sorted(glob.glob(os.path.join(
        subset, "raw", "CSR-1-WSJ-0", "WAV", "wsj0", split, spk, "*.wav")))


def _ntcd(subset, spk):
    return sorted(glob.glob(os.path.join(
        subset, "raw", "ntcd_timit", "Clean", "*", spk, "straightcam",
        "*.wav")))


def campaign_splits(subset):
    """Speaker-disjoint (paths_train, paths_valid, paths_test)."""
    train = (_wsj(subset, "si_tr_s", "011") + _ntcd(subset, "Lipspkr1")
             + _ntcd(subset, "01M"))
    valid = _wsj(subset, "si_dt_05", "050")
    test = (_wsj(subset, "si_et_05", "440") + _ntcd(subset, "08F")
            + _ntcd(subset, "34M"))
    if not (len(train) == 9 and len(valid) == 3 and len(test) == 9):
        raise ValueError(f"{subset}: expected 9 / 3 / 9 train / valid / "
                         f"test utterances, found {len(train)} / "
                         f"{len(valid)} / {len(test)}")
    return train, valid, test


def build_test_corpus(work, n_voices, snrs, train_clean, subset):
    """Synthesize the balanced test corpus: every (test utterance x voice
    variant) mixed at every SNR with a deterministically rotating noise
    family (each family appears equally at each SNR). Writes the
    reference's `<utt>_{s,n,x}.wav` triples (joint max-normalization,
    create_test_set.py:99-103) plus a manifest. Returns the manifest."""
    from ..data import write_wav
    from ..data.noise import noise_segment, synthetic_noise_bank
    from ..data.synthesis import VOICE_VARIANTS, voice_variants

    corpus = os.path.join(work, "corpus")
    manifest_path = os.path.join(corpus, "manifest.json")
    want = {"n_voices": n_voices, "snrs": list(snrs),
            "families": list(TEST_FAMILIES), "seed": TEST_BANK_SEED,
            "naming": "speaker-prefixed"}
    if os.path.exists(manifest_path):
        with open(manifest_path) as f:
            m = json.load(f)
        if m.get("config") == want:
            return m
    os.makedirs(corpus, exist_ok=True)

    # held-out noise instances: new seed; babble from training speech
    bank = synthetic_noise_bank(train_clean, seed=TEST_BANK_SEED,
                                rich=True)
    bank = {f: bank[f] for f in TEST_FAMILIES}

    _, _, test_paths = campaign_splits(subset)
    variants = VOICE_VARIANTS[:n_voices]
    rng = np.random.RandomState(7)
    entries = []
    fam_i = 0
    for p in test_paths:
        x = _load_clean(p)
        base = os.path.splitext(os.path.basename(p))[0]
        spk = os.path.basename(os.path.dirname(
            os.path.dirname(p) if "straightcam" in p else p))
        for vi, v in enumerate(voice_variants(x, variants)):
            for snr in snrs:
                fam = TEST_FAMILIES[fam_i % len(TEST_FAMILIES)]
                fam_i += 1
                np.random.seed(rng.randint(1 << 30))
                nz = noise_segment(bank, fam, v)
                k = np.sum(v ** 2) * 10 ** (-snr / 10) / np.sum(nz ** 2)
                nz = nz * np.sqrt(k)
                mix = v + nz
                # reference create_test_set.py:99-103: joint max-norm
                norm = max(np.abs(v).max(), np.abs(nz).max(),
                           np.abs(mix).max())
                # speaker prefix: NTCD wav basenames repeat across
                # speakers (08F/sa2.wav and 34M/sa2.wav)
                name = f"{spk}_{base}_v{vi}_snr{int(snr):+d}"
                out = os.path.join(corpus, name)
                write_wav(out + "_s.wav", (v / norm).astype(np.float32),
                          FS)
                write_wav(out + "_n.wav", (nz / norm).astype(np.float32),
                          FS)
                write_wav(out + "_x.wav", (mix / norm).astype(np.float32),
                          FS)
                entries.append({"name": name + ".wav", "snr": snr,
                                "family": fam, "speaker": spk,
                                "voice": vi})
    names = [e["name"] for e in entries]
    if len(set(names)) != len(names):
        raise ValueError("corpus names must be unique")
    manifest = {"config": want, "entries": entries}
    with open(manifest_path, "w") as f:
        json.dump(manifest, f)
    print(f"corpus: {len(entries)} mixtures "
          f"({len(test_paths)} utts x {len(variants)} voices x "
          f"{len(snrs)} SNRs), families {TEST_FAMILIES}", flush=True)
    return manifest


def retrain(work, epochs, train_voices, subset, dev, cls_features="power",
            cls_quantile=0.999, cls_pos_weight=None, cls_calibrate=False):
    """Retrain M1 / M2-IBM / M2-VAD / classifiers / wiener on the enlarged
    speaker-disjoint bank: voice-variant + gain augmented clean speech,
    rich 10-family synthetic noise (training seed), wide SNR grid. Reuses
    pretrain_subset's build / train plumbing.

    Classifier levers (the defaults keep the exact reference protocol):
      cls_features   - classifier input transform ('power' | 'log-power')
      cls_quantile   - Lorenz quantile of the classifier's training labels
                       (the reference trains at 0.999, create_train_set.py,
                       but evals F1 against a 0.98-quantile oracle,
                       run_metrics_M2.py:52-53; 0.98 aligns them)
      cls_pos_weight - 'auto' (neg/pos frame ratio), a float, or None
      cls_calibrate  - sweep + persist the F1-max decision threshold
    The generative models (M1 / M2) keep the reference protocol."""
    import torch

    from ..data.noise import synthetic_noise_bank
    from ..data.synthesis import VOICE_VARIANTS, augment_clean, voice_variants
    from ..models import classifier_features
    from ..train import (TrainConfig, best_checkpoint, train_classifier,
                         train_m1, train_m2, train_wiener)
    from .pretrain_subset import build, clean_labeled_frames

    models = os.path.join(work, "models")
    all_jobs = ("M1", "M2_ibm", "M2_vad", "classifier_ibm",
                "classifier_vad", "wiener")
    if all(os.path.exists(os.path.join(models, j)) for j in all_jobs):
        print(f"models: reusing {models}", flush=True)
        return models

    # the frame bank is expensive to build (voice variants + mixing + STFT
    # of ~400 streams); cached so an interrupted retrain resumes per job,
    # keyed by the classifier label quantile
    bank_npz = os.path.join(
        work, f"train_bank_v2_q{int(round(cls_quantile * 1000))}.npz")
    bank_keys = ("Xtr", "Yibm_tr", "Yvad_tr", "Ywf_tr",
                 "Xva", "Yibm_va", "Yvad_va", "Ywf_va",
                 "Xc_tr", "Yc_ibm_tr", "Yc_vad_tr",
                 "Xc_va", "Yc_ibm_va", "Yc_vad_va")
    if os.path.exists(bank_npz):
        with np.load(bank_npz) as z:
            (Xtr, Yibm_tr, Yvad_tr, Ywf_tr, Xva, Yibm_va, Yvad_va, Ywf_va,
             Xc_tr, Yc_ibm_tr, Yc_vad_tr, Xc_va, Yc_ibm_va, Yc_vad_va) = (
                z[k] for k in bank_keys)
        print(f"bank: cached {Xtr.shape[0]} noisy / "
              f"{Xc_tr.shape[0]} clean train frames", flush=True)
    else:
        tr_paths, va_paths, _ = campaign_splits(subset)
        base_tr = [_load_clean(p) for p in tr_paths]
        clean_va = [_load_clean(p) for p in va_paths]
        # synthetic speakers + level diversity on the training side
        clean_tr = []
        for x in base_tr:
            clean_tr.extend(
                voice_variants(x, VOICE_VARIANTS[:train_voices]))
        clean_tr = augment_clean(clean_tr, factors=(), gains=(0.7, 1.4))

        noise = synthetic_noise_bank(base_tr, seed=11, rich=True)
        t0 = time.perf_counter()
        Xtr, Yibm_tr, Yvad_tr, Ywf_tr = build(
            clean_tr, noise, 0, n_mix=3,
            snrs=(-7.5, -5, -2.5, 0, 2.5, 5.0, 7.5, 10.0),
            include_clean=True, label_quantile=cls_quantile)
        Xva, Yibm_va, Yvad_va, Ywf_va = build(
            clean_va, noise, 1, n_mix=4, snrs=(-5, -2.5, 0, 2.5, 5.0),
            label_quantile=cls_quantile)
        # M2 training labels keep the reference protocol (0.999,
        # create_train_set.py): only the discriminators' targets move
        Xc_tr, Yc_ibm_tr, Yc_vad_tr = clean_labeled_frames(clean_tr)
        Xc_va, Yc_ibm_va, Yc_vad_va = clean_labeled_frames(clean_va)
        np.savez(bank_npz, **dict(zip(bank_keys, (
            Xtr, Yibm_tr, Yvad_tr, Ywf_tr, Xva, Yibm_va, Yvad_va, Ywf_va,
            Xc_tr, Yc_ibm_tr, Yc_vad_tr, Xc_va, Yc_ibm_va, Yc_vad_va))))
        print(f"bank: {Xtr.shape[0]} noisy / {Xc_tr.shape[0]} clean train "
              f"frames ({time.perf_counter() - t0:.0f}s to build)",
              flush=True)

    def features(X):
        return classifier_features(torch.from_numpy(X), cls_features).numpy()

    eps = 1e-8
    # wiener keeps the reference's raw-power protocol; the classifiers'
    # mean/std are computed on the transformed features so the persisted
    # side-cars standardize exactly what inference feeds the net
    mean, std = Xtr.mean(0), Xtr.std(0)
    Xn_tr = ((Xtr - mean) / (std + eps)).astype(np.float32)
    Xn_va = ((Xva - mean) / (std + eps)).astype(np.float32)
    Xf_tr = features(Xtr)
    mean_c, std_c = Xf_tr.mean(0), Xf_tr.std(0)
    Xcn_tr = ((Xf_tr - mean_c) / (std_c + eps)).astype(np.float32)
    Xcn_va = ((features(Xva) - mean_c) / (std_c + eps)).astype(np.float32)
    if cls_pos_weight == "auto":
        p = float(Yibm_tr.mean())
        pos_w = min((1.0 - p) / max(p, 1e-6), 20.0)
        p_vad = float(Yvad_tr.mean())
        pos_w_vad = min((1.0 - p_vad) / max(p_vad, 1e-6), 20.0)
        print(f"pos_weight auto: ibm {pos_w:.2f} (p={p:.3f}), "
              f"vad {pos_w_vad:.2f} (p={p_vad:.3f})", flush=True)
    else:
        pos_w = pos_w_vad = (
            float(cls_pos_weight) if cls_pos_weight else None)
    cfg = TrainConfig(end_epoch=epochs, batch_size=256)
    cfg_cls = TrainConfig(end_epoch=max(1, epochs // 2), batch_size=256)
    cls_kw = dict(cfg=cfg_cls, features=cls_features,
                  calibrate=cls_calibrate,
                  meta_extra={"label_quantile": cls_quantile}, device=dev)

    jobs = [
        ("M1", lambda d: train_m1(
            Xc_tr, Xc_va, dims=(513, 32, (128, 128)), cfg=cfg,
            model_dir=d, name="M1", device=dev)),
        ("M2_ibm", lambda d: train_m2(
            (Xc_tr, Yc_ibm_tr), (Xc_va, Yc_ibm_va),
            dims=(513, 513, 32, (128, 128)), cfg=cfg, model_dir=d,
            name="M2", device=dev)),
        ("M2_vad", lambda d: train_m2(
            (Xc_tr, Yc_vad_tr), (Xc_va, Yc_vad_va),
            dims=(513, 1, 32, (128, 128)), cfg=cfg, model_dir=d,
            name="M2", device=dev)),
        ("classifier_ibm", lambda d: train_classifier(
            (Xcn_tr, Yibm_tr), (Xcn_va, Yibm_va),
            dims=(513, (128, 128), 513), model_dir=d,
            name="Classifier", mean=mean_c, std=std_c,
            pos_weight=pos_w, **cls_kw)),
        ("classifier_vad", lambda d: train_classifier(
            (Xcn_tr, Yvad_tr), (Xcn_va, Yvad_va),
            dims=(513, (128, 128), 1), model_dir=d,
            name="Classifier", mean=mean_c, std=std_c,
            pos_weight=pos_w_vad, **cls_kw)),
        ("wiener", lambda d: train_wiener(
            (Xn_tr, Ywf_tr), (Xn_va, Ywf_va), dims=(513, (128,) * 5, 513),
            cfg=cfg_cls, model_dir=d, name="Wiener", mean=mean, std=std,
            device=dev)),
    ]
    for name, job in jobs:
        if os.path.exists(os.path.join(models, name)):
            continue                     # resumed run: job already done
        t0 = time.perf_counter()
        mdir = os.path.join(work, "train", name)
        _, hist = job(mdir)
        dst = os.path.join(models, name)
        os.makedirs(dst, exist_ok=True)
        shutil.copy(best_checkpoint(mdir), dst)
        for side in ("trainset_mean.npy", "trainset_std.npy",
                     "classifier_meta.json"):
            p = os.path.join(mdir, side)
            if os.path.exists(p):
                shutil.copy(p, dst)
        print(f"{name}: best valid "
              f"{min(h['valid'] for h in hist):.3f} "
              f"({time.perf_counter() - t0:.0f}s)", flush=True)
    return models


def _est_dir(work, sysname, seed):
    """Seed 0 keeps the plain layout; replicate seeds get a suffix."""
    tag = sysname if seed == 0 else f"{sysname}@s{seed}"
    return os.path.join(work, "est", tag)


def _dnn_kw(models, cdir, dev):
    """Classifier + side-cars + persisted inference protocol
    (classifier_meta.json: features / calibrated threshold)."""
    from ..train import load_classifier_meta

    cls = load_model(os.path.join(models, cdir), kind="classifier",
                     device=dev)
    mean, std = load_norm_stats(os.path.join(models, cdir))
    meta = load_classifier_meta(os.path.join(models, cdir))
    return dict(classifier=cls, mean=mean, std=std,
                features=meta["features"],
                dnn_threshold=meta["threshold"])


def run_system(sysname, work, models, names, niter, batch_size, seed, dev):
    """Enhance the whole corpus with one system; returns its est dir."""
    from ..mcem import MCEMConfig
    from ..pipeline import enhance_files, enhance_files_wiener

    corpus = os.path.join(work, "corpus")
    est = _est_dir(work, sysname, seed)
    cfg = MCEMConfig(niter=niter)
    kw = dict(cfg=cfg, batch_size=batch_size, seed=seed, fast=True,
              skip_existing=True, verbose=True, device=dev)
    t0 = time.perf_counter()
    profile = sysname.split("_", 1)[-1]
    if sysname.startswith("m2dnn_"):
        m2 = load_model(os.path.join(models, "M2_ibm"), kind="dgm",
                        y_dim=513, device=dev)
        enhance_files(names, corpus, est, m2, model_type="m2",
                      classif_type="dnn", profile=profile,
                      **_dnn_kw(models, "classifier_ibm", dev), **kw)
    elif sysname.startswith("m2oracle_"):
        # oracle guidance (reference evaluate_M2_ibm.py classif_type=
        # 'oracle'): isolates engine quality from classifier quality
        m2 = load_model(os.path.join(models, "M2_ibm"), kind="dgm",
                        y_dim=513, device=dev)
        enhance_files(names, corpus, est, m2, model_type="m2",
                      classif_type="oracle", profile=profile, **kw)
    elif sysname.startswith("m2vaddnn_"):
        # the reference's second guidance flavor (evaluate_M2_vad.py:
        # y_dim=1)
        m2 = load_model(os.path.join(models, "M2_vad"), kind="dgm",
                        y_dim=1, device=dev)
        enhance_files(names, corpus, est, m2, model_type="m2",
                      classif_type="dnn", target="vad", profile=profile,
                      **_dnn_kw(models, "classifier_vad", dev), **kw)
    elif sysname.startswith("m2vadoracle_"):
        m2 = load_model(os.path.join(models, "M2_vad"), kind="dgm",
                        y_dim=1, device=dev)
        enhance_files(names, corpus, est, m2, model_type="m2",
                      classif_type="oracle", target="vad",
                      profile=profile, **kw)
    elif sysname == "m1_spp":
        m1 = load_model(os.path.join(models, "M1"), kind="vae", device=dev)
        enhance_files(names, corpus, est, m1, model_type="m1",
                      noise_model="spp", **kw)
    elif sysname.startswith("m1spp_"):
        # unguided M1 under the validated profiles: the same spp2 /
        # noise-gain levers the guided rows get
        m1 = load_model(os.path.join(models, "M1"), kind="vae", device=dev)
        enhance_files(names, corpus, est, m1, model_type="m1",
                      profile=profile, **kw)
    elif sysname == "wiener":
        w = load_model(os.path.join(models, "wiener"), kind="classifier",
                       device=dev)
        mean, std = load_norm_stats(os.path.join(models, "wiener"))
        enhance_files_wiener(names, corpus, est, w, mean=mean, std=std,
                             batch_size=batch_size, device=dev)
    else:
        raise SystemExit(f"unknown system {sysname}")
    print(f"[{sysname}{'' if seed == 0 else f'@s{seed}'}] enhanced "
          f"{len(names)} in {time.perf_counter() - t0:.0f}s", flush=True)
    return est


def metrics_for(sysname, work, manifest, max_workers, seed=0,
                objective=True):
    """Reference-protocol metrics for one system: per-utterance rows via
    the spawn process pool, mean±95%-CI overall and per input SNR
    (reference metrics.py:70-130), plus per-noise-family F1 for guided
    systems and the classic objective measures (segSNR / fwSegSNR / LLR /
    WSS)."""
    from ..metrics.runner import (METRIC_KEYS_BASE, METRIC_KEYS_F1,
                                  METRIC_KEYS_OBJECTIVE,
                                  compute_metrics_mixture_utt,
                                  compute_metrics_utt, metrics_pool)
    from ..metrics.stats import compute_stats

    corpus = os.path.join(work, "corpus")
    entries = manifest["entries"]
    names = [e["name"] for e in entries]
    snr_arr = np.asarray([e["snr"] for e in entries], np.float64)
    with_f1 = sysname.startswith(("m2dnn_", "m2vaddnn_"))
    target = "vad" if sysname.startswith("m2vad") else "ibm"

    keys = list(METRIC_KEYS_BASE) + ["PESQ"]
    if objective:
        keys += METRIC_KEYS_OBJECTIVE
    if sysname == "mixture":
        args = [(corpus, p, objective) for p in names]
        fn = compute_metrics_mixture_utt
    else:
        est = _est_dir(work, sysname, seed)
        if with_f1:
            keys += METRIC_KEYS_F1
        args = [(corpus, est, p, with_f1, target, 0.98, 0.999, False,
                 objective)
                for p in names]
        fn = compute_metrics_utt

    with metrics_pool(max_workers) as ex:
        rows = list(ex.map(fn, args))

    print(f"\n===== {sysname}{'' if seed == 0 else f'@s{seed}'} =====",
          flush=True)
    stats = compute_stats(keys, rows, snr_arr)

    fam_f1 = {}
    if with_f1:
        f1_col = keys.index("F1")
        for fam in sorted({e["family"] for e in entries}):
            vals = [r[f1_col] for r, e in zip(rows, entries)
                    if e["family"] == fam]
            fam_f1[fam] = round(float(np.mean(vals)), 3)
        print(f"[{sysname}] classifier F1 by noise family: {fam_f1}",
              flush=True)
    return {"keys": keys, "stats": stats, "f1_by_family": fam_f1,
            "rows": [[None if (isinstance(v, float) and np.isnan(v))
                      else round(float(v), 4) for v in r] for r in rows]}


def seed_spread(results, systems, seeds):
    """Across-seed spread of the overall means for replicated systems:
    which profile-against-profile orderings the seeds resolve."""
    print("\n===== seed spread (overall means across replicate seeds) "
          "=====", flush=True)
    spread = {}
    for sysname in systems:
        tags = [sysname] + [f"{sysname}@s{k}" for k in range(1, seeds)]
        recs = [results[t] for t in tags if t in results]
        if len(recs) < 2:
            continue
        keys = recs[0]["keys"]
        per = {}
        for met in ("SI-SDR", "ESTOI", "PESQ"):
            i = keys.index(met)
            means = [float(np.nanmean(np.asarray(
                [r[i] for r in rec["rows"]], np.float64)))
                for rec in recs]
            per[met] = {"means": [round(m, 4) for m in means],
                        "sd": round(float(np.std(means, ddof=1)), 4)}
        spread[sysname] = per
        print(f"{sysname}: " + "  ".join(
            f"{m} {v['means'][0]:.3f} sd±{v['sd']:.3f}"
            for m, v in per.items()), flush=True)
    return spread


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    paths, argv = apply_overrides(PathsConfig(), argv)
    smoke = flag(argv, "smoke", 0, int)
    work = flag(argv, "work", os.path.join(
        tempfile.gettempdir(), "gvnmf_campaign" + ("_smoke" if smoke else "")))
    models_arg = flag(argv, "models", "retrain")
    n_voices = flag(argv, "voices", 2 if smoke else 9, int)
    snrs = tuple(float(s) for s in
                 flag(argv, "snrs", "0" if smoke else "-5,0,5").split(","))
    niter = flag(argv, "niter", 2 if smoke else 100, int)
    epochs = flag(argv, "epochs", 2 if smoke else 200, int)
    train_voices = flag(argv, "train_voices", 2 if smoke else 5, int)
    batch_size = flag(argv, "batch_size", 16, int)
    seed = flag(argv, "seed", 0, int)
    # replicate MH-stochastic systems at seeds 0..K-1 for error bars
    seeds = flag(argv, "seeds", 1, int)
    max_workers = flag(argv, "max_workers", 8, int)
    objective = flag(argv, "objective", 1, int)
    # classifier protocol levers; the defaults are the measured-best
    # protocol; --cls_features power --cls_quantile 0.999
    # --cls_pos_weight none --cls_calibrate 0 is the exact reference one
    cls_features = flag(argv, "cls_features", "log-power")
    cls_quantile = flag(argv, "cls_quantile", 0.98, float)
    cls_pos_weight = flag(argv, "cls_pos_weight", "auto")
    if cls_pos_weight in ("none", "", "0"):
        cls_pos_weight = None
    cls_calibrate = flag(argv, "cls_calibrate", 1, int)
    systems = flag(
        argv, "systems",
        "mixture,m2dnn_reference" if smoke else ",".join(ALL_SYSTEMS)
    ).split(",")
    dev = device(argv)
    subset = os.path.join(paths.data_root, paths.dataset_size)

    os.makedirs(work, exist_ok=True)
    tr_paths, _, _ = campaign_splits(subset)
    train_clean = [_load_clean(p) for p in tr_paths]

    manifest = build_test_corpus(work, n_voices, snrs, train_clean, subset)
    names = [e["name"] for e in manifest["entries"]]

    if models_arg == "retrain":
        models = retrain(work, epochs, train_voices, subset, dev,
                         cls_features=cls_features,
                         cls_quantile=cls_quantile,
                         cls_pos_weight=cls_pos_weight,
                         cls_calibrate=bool(cls_calibrate))
    else:
        models = models_arg
    if flag(argv, "prep_only", 0, int):
        print(json.dumps({"campaign": "prep_done", "models": models,
                          "utterances": len(names), **backend_info()}))
        return None

    out = os.path.join(work, "campaign_results.json")
    # merge into a prior run's record so systems can be added
    # incrementally (--systems a,b into the same --work)
    results = {}
    if os.path.exists(out):
        with open(out) as f:
            results = json.load(f)
    prior = [s for s in results.get("config", {}).get("systems", ())
             if s not in systems]
    results["config"] = {
        "n_utterances": len(names), "voices": n_voices,
        "snrs": list(snrs), "niter": niter, "epochs": epochs,
        "train_voices": train_voices, "models": models,
        "systems": prior + list(systems), "seeds": seeds,
        # per-utterance identity in row order: makes the record
        # self-contained (per-family / SNR re-aggregation without the
        # corpus manifest; campaign_tables --by_family)
        "corpus_entries": manifest["entries"],
        "classifier_levers": {
            "features": cls_features, "label_quantile": cls_quantile,
            "pos_weight": cls_pos_weight, "calibrate": bool(cls_calibrate),
        },
        **backend_info(),
    }

    def save():
        with open(out, "w") as f:
            json.dump(results, f, indent=1)

    for sysname in systems:
        n_rep = (seeds if sysname.startswith(STOCHASTIC_PREFIXES) else 1)
        for k in range(n_rep):
            tag = sysname if k == 0 else f"{sysname}@s{k}"
            if tag in results and flag(argv, "skip_done", 1, int):
                continue
            if sysname != "mixture":
                run_system(sysname, work, models, names, niter,
                           batch_size, seed + k, dev)
            results[tag] = metrics_for(sysname, work, manifest,
                                       max_workers, seed=seed + k,
                                       objective=bool(objective))
            save()

    if seeds > 1:
        results["seed_spread"] = seed_spread(results, systems, seeds)
    save()
    print(f"\nresults -> {out}", flush=True)
    print(json.dumps({"campaign": "done", "utterances": len(names),
                      "systems": systems, **backend_info()}))
    return results


if __name__ == "__main__":
    main()
