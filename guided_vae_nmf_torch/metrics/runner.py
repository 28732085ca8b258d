"""Per-utterance metric sweeps.

Counterpart of `guided_vae_nmf_tpu/metrics/runner.py` (reference
scripts/run_metrics_M1.py:60-176, run_metrics_M2.py:102-244,
run_metrics_wiener.py and run_metrics_mixture.py:50-120): for each test
utterance read the (s, n, x, s_est) wavs, compute SI-SDR / SI-SIR / SI-SAR,
ESTOI and PESQ-wb, plus mask F1 against the oracle label for the guided
variants; aggregate with 95 % confidence intervals overall and per input
SNR. The sweep fans out over a spawn-context process pool whose workers
never open the card (:func:`metrics_pool`): the metrics are numpy.

PESQ is the ITU `pesq` wheel when it can be imported (`HAS_PESQ_NATIVE`),
else the first-party P.862.2 implementation (`metrics/pesq.py`); the chosen
function is :data:`pesq_score`. Figures (`make_figures=True`) wait for the
`viz` port (ROADMAP Queue 1, item 6).
"""

import os
from concurrent.futures import ProcessPoolExecutor

import numpy as np

from ..data import read_dataset, read_wav, speech_list
from ..dsp import clean_speech_IBM, clean_speech_VAD, stft
from ..models.losses import f1_loss
from .si_sdr import energy_ratios
from .stats import compute_stats
from .stoi import stoi

try:  # pragma: no cover - the wheel is absent where the port is tested
    from pesq import pesq as pesq_score

    HAS_PESQ_NATIVE = True
except ImportError:
    from .pesq import pesq as pesq_score

    HAS_PESQ_NATIVE = False
HAS_PESQ = True

FS = 16000

METRIC_KEYS_BASE = ["SI-SDR", "SI-SIR", "SI-SAR", "ESTOI"]
METRIC_KEYS_F1 = ["ACC", "PRECISION", "RECALL", "F1"]
# Classic objective speech-quality measures (metrics/objective.py): LLR and
# WSS are distortion measures (lower is better), the two SNRs higher-better.
METRIC_KEYS_OBJECTIVE = ["SSNR", "FWSSNR", "LLR", "WSS"]

_FIGURES_NOT_PORTED = ("per-utterance figures are not ported yet (ROADMAP "
                       "Queue 1, item 6: viz)")


def _objective_row(s, s_hat):
    from .objective import fw_seg_snr, llr, seg_snr, wss

    return [float(seg_snr(s, s_hat)), float(fw_seg_snr(s, s_hat)),
            float(llr(s, s_hat)), float(wss(s, s_hat))]


def _safe_pesq(s, s_hat):
    """PESQ-wb, NaN for degenerate inputs (< 250 ms or silent) so one
    pathological utterance cannot abort the whole metric sweep: the
    reference's C extension raises on the same inputs."""
    try:
        return pesq_score(FS, s, s_hat, "wb")
    except (ValueError, RuntimeError):
        return float("nan")


def compute_metrics_utt(args):
    """One utterance: (SI-SDR, SI-SIR, SI-SAR, ESTOI, PESQ[, SSNR, FWSSNR,
    LLR, WSS][, ACC, PRECISION, RECALL, F1]). `args` is (processed_dir,
    est_dir, path, with_f1, target, quantile_fraction, quantile_weight,
    make_figures[, with_objective]); make_figures must be false."""
    (processed_dir, est_dir, path, with_f1, target, quantile_fraction,
     quantile_weight, make_figures) = args[:8]
    with_objective = args[8] if len(args) > 8 else False
    if make_figures:
        raise NotImplementedError(_FIGURES_NOT_PORTED)
    base_p = os.path.join(processed_dir, os.path.splitext(path)[0])
    base_e = os.path.join(est_dir, os.path.splitext(path)[0])

    s, _ = read_wav(base_p + "_s.wav")
    n, _ = read_wav(base_p + "_n.wav")
    s_hat, _ = read_wav(base_e + "_s_est.wav")
    ln = min(len(s), len(s_hat))
    s, n, s_hat = s[:ln], n[:ln], s_hat[:ln]

    si_sdr, si_sir, si_sar = energy_ratios(s_hat, s, n)
    estoi_v = stoi(s, s_hat, FS, extended=True)
    pesq_v = _safe_pesq(s, s_hat)
    row = [si_sdr, si_sir, si_sar, estoi_v, pesq_v]
    if with_objective:
        row.extend(_objective_row(s, s_hat))

    if with_f1:
        y_hard = np.load(base_e + "_ibm_hard_est.npy")
        s_tf = stft(s)
        fn = clean_speech_VAD if target == "vad" else clean_speech_IBM
        y_oracle = fn(s_tf, quantile_fraction=quantile_fraction,
                      quantile_weight=quantile_weight)
        if target == "vad":
            y_oracle = y_oracle.reshape(1, -1)
        ncols = min(y_hard.shape[1], y_oracle.shape[1])
        acc, prec, rec, f1 = (
            float(v) for v in f1_loss(
                np.asarray(y_hard[:, :ncols]).reshape(-1),
                y_oracle[:, :ncols].reshape(-1),
            )
        )
        row.extend([acc, prec, rec, f1])
    return tuple(row)


def compute_metrics_mixture_utt(args):
    """No-processing floor: metrics of the raw mixture against the clean
    track (reference run_metrics_mixture.py:50-120). `args` is
    (processed_dir, path[, with_objective])."""
    processed_dir, path = args[:2]
    with_objective = args[2] if len(args) > 2 else False
    base = os.path.join(processed_dir, os.path.splitext(path)[0])
    s, _ = read_wav(base + "_s.wav")
    n, _ = read_wav(base + "_n.wav")
    x, _ = read_wav(base + "_x.wav")
    si_sdr, si_sir, si_sar = energy_ratios(x, s, n)
    estoi_v = stoi(s, x, FS, extended=True)
    row = [si_sdr, si_sir, si_sar, estoi_v, _safe_pesq(s, x)]
    if with_objective:
        row.extend(_objective_row(s, x))
    return tuple(row)


def _pool_init():
    """Worker initializer: hide every card from the worker before anything
    in it can open CUDA. A CUDA context costs hundreds of MB of the card's
    memory and seconds to start, and the metrics are numpy; no module a
    worker imports touches CUDA at import time."""
    os.environ["CUDA_VISIBLE_DEVICES"] = ""


def metrics_pool(max_workers=8):
    """Process pool for metric sweeps. Spawn-context: the parent usually
    holds a CUDA context, and a fork()ed child would inherit it (and the
    parent's locks) mid-state."""
    import multiprocessing

    return ProcessPoolExecutor(
        max_workers=max_workers,
        mp_context=multiprocessing.get_context("spawn"),
        initializer=_pool_init,
    )


def run_metrics(input_speech_dir, processed_dir, est_dir=None,
                dataset_type="test", with_f1=False, target="ibm",
                quantile_fraction=0.98, quantile_weight=0.999,
                max_workers=8, confidence=0.95, save_json=False,
                mixture_floor=False, serial=False, make_figures=False):
    """Sweep the test list, aggregate, print tables; returns
    (metric_keys, rows, snr_list, stats). `make_figures=True` raises
    NotImplementedError before any work."""
    if make_figures:
        raise NotImplementedError(_FIGURES_NOT_PORTED)
    files = speech_list(input_speech_dir, dataset_type)
    snr_list = read_dataset(processed_dir, dataset_type, "snr_db")

    keys = list(METRIC_KEYS_BASE) + ["PESQ"]
    if with_f1 and not mixture_floor:
        keys.extend(METRIC_KEYS_F1)

    if mixture_floor:
        args = [(processed_dir, p) for p in files]
        fn = compute_metrics_mixture_utt
    else:
        args = [
            (processed_dir, est_dir, p, with_f1, target, quantile_fraction,
             quantile_weight, False)
            for p in files
        ]
        fn = compute_metrics_utt

    if serial:
        rows = [fn(a) for a in args]
    else:
        with metrics_pool(max_workers) as ex:
            rows = list(ex.map(fn, args))

    stats = compute_stats(keys, rows, np.asarray(snr_list),
                          model_data_dir=est_dir, confidence=confidence,
                          save_json=save_json)
    return keys, rows, snr_list, stats
