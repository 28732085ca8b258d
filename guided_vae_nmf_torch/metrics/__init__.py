"""The evaluation protocol's metrics: SI-SDR / SI-SIR / SI-SAR (numpy and
batched torch), STOI / ESTOI, PESQ (the ITU wheel when importable, else the
first-party P.862.2), the classic objective measures, confidence-interval
statistics and the per-utterance sweeps. Counterpart of
`guided_vae_nmf_tpu/metrics`, with :func:`energy_ratios_torch` in place of
`energy_ratios_jax`. As there, the package attribute `pesq` is the chosen
PESQ function; the module stays importable as `metrics.pesq` by its full
name (`from guided_vae_nmf_torch.metrics.pesq import ...`)."""

from .objective import fw_seg_snr, llr, seg_snr, wss
from .pesq import mos_lqo_nb, mos_lqo_wb
from .polqa import HAS_POLQA, run_polqa
from .runner import (
    HAS_PESQ,
    HAS_PESQ_NATIVE,
    compute_metrics_mixture_utt,
    compute_metrics_utt,
    run_metrics,
)
from .runner import pesq_score as pesq
from .si_sdr import energy_ratios, energy_ratios_torch, si_sdr_components
from .stats import compute_stats, compute_stats_noisnr, mean_confidence_interval
from .stoi import estoi, remove_silent_frames, stoi, third_octave_band_matrix

__all__ = [
    "HAS_PESQ", "HAS_PESQ_NATIVE", "HAS_POLQA", "compute_metrics_mixture_utt",
    "compute_metrics_utt", "compute_stats", "compute_stats_noisnr",
    "energy_ratios", "energy_ratios_torch", "estoi", "fw_seg_snr", "llr",
    "mean_confidence_interval", "mos_lqo_nb", "mos_lqo_wb", "pesq",
    "remove_silent_frames", "run_metrics", "run_polqa", "seg_snr",
    "si_sdr_components", "stoi", "third_octave_band_matrix", "wss",
]
