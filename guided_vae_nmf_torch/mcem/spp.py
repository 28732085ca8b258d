"""SPP-based noise PSD estimation (Gerkmann & Hendriks 2011/2012).

Counterpart of `guided_vae_nmf_tpu/mcem/spp.py`: the frame-recursive
speech-presence-probability noise tracker and the `timo_*` helpers that
run it over a whole spectrogram (soft masks, VAD, noise PSD tracks; the
unsupervised "timo" label source).

The numpy `SPPNoiseEstimator` and the numpy `timo_*_estimation` functions
are copies of the reference package's host-side code. The torch functions
are the device trackers: the recurrence is sequential over frames, so each
is a Python loop over frames with every step vectorised over the leading
(batch, bin) axes, where the JAX package runs a `lax.scan`.
"""

import numpy as np
import torch

SPP_FIX_SMOOTH = 0.8
SPP_PROB_SMOOTH = 0.9
SPP_PRIOR = 0.5
SPP_SNR_OPT_DB = 15
SPP_NUM_FRAMES_INIT = 10


class SPPNoiseEstimator:
    """Streaming SPP noise tracker (reference spp_estimation.py:17-172).

    First `num_frames_init` frames are averaged into the initial noise PSD
    (SPP reported as 0); afterwards each frame applies the inverse-GLR SPP,
    stuck protection (clamp when the smoothed probability exceeds 0.99), the
    SPP-weighted noise periodogram blend and fixed PSD smoothing.
    """

    def __init__(self, frame_length, fixed_smooth=SPP_FIX_SMOOTH,
                 prob_smooth=SPP_PROB_SMOOTH, prior=SPP_PRIOR,
                 snr_opt_db=SPP_SNR_OPT_DB,
                 num_frames_init=SPP_NUM_FRAMES_INIT):
        self._frame_length = frame_length
        self._fixed_smooth = fixed_smooth
        self._prob_smooth = prob_smooth
        self._prior = prior
        self._snr_opt_lin = 10.0 ** (snr_opt_db / 10.0)
        self._num_frames_init = num_frames_init
        self._glr_inv_scale = (1 - prior) / prior * (1.0 + self._snr_opt_lin)
        self._glr_exp_scale = self._snr_opt_lin / (1.0 + self._snr_opt_lin)
        self.reset()

    def reset(self):
        n_bins = self._frame_length // 2 + 1
        self._psd = np.zeros(n_bins)
        self._spp_smoothed = np.zeros(n_bins)
        self._num_frames_processed = 0

    def update(self, periodogram, spp_external=None):
        """One frame update -> (noise_psd, spp) or noise_psd when an external
        SPP is supplied (reference spp_estimation.py:86-146)."""
        if spp_external is not None:
            blended_per = (1.0 - spp_external) * periodogram + \
                spp_external * self._psd
            noise_psd = (1.0 - self._fixed_smooth) * blended_per + \
                self._fixed_smooth * self._psd
            return noise_psd

        if self._num_frames_processed < self._num_frames_init:
            noise_psd = self._psd + periodogram / self._num_frames_init
            self._psd = noise_psd
            self._num_frames_processed += 1
            return periodogram, np.zeros_like(self._psd)

        inv_glr = self._glr_inv_scale * np.exp(
            -periodogram / (self._psd + 1e-8) * self._glr_exp_scale
        )
        spp = 1.0 / (1.0 + inv_glr)

        self._spp_smoothed = (1 - self._prob_smooth) * spp + \
            self._prob_smooth * self._spp_smoothed
        stuck = self._spp_smoothed > 0.99
        spp = np.where(stuck, np.minimum(spp, 0.99), spp)

        blended_per = (1.0 - spp) * periodogram + spp * self._psd
        noise_psd = (1.0 - self._fixed_smooth) * blended_per + \
            self._fixed_smooth * self._psd
        self._psd = noise_psd
        return noise_psd, spp

    def from_stft(self, per_frames):
        """Noise PSD track for a (frames, bins) periodogram matrix, resetting
        afterwards (reference spp_estimation.py:156-172)."""
        psd_frames = np.zeros(per_frames.shape)
        for frame, per in enumerate(per_frames):
            psd_frames[frame] = self.update(per)[0]
        self.reset()
        return psd_frames


def timo_mask_estimation(spectrogram):
    """Soft TF mask = per-frame SPP over a (bins, frames) power spectrogram
    (reference spp_estimation.py:175-194)."""
    freq_bins, _ = spectrogram.shape
    est = SPPNoiseEstimator(frame_length=(freq_bins - 1) * 2)
    mask = np.zeros_like(spectrogram)
    for i, frame in enumerate(spectrogram.T):
        _, spp = est.update(frame)
        mask[:, i] = spp
    return mask


def timo_vad_estimation(spectrogram):
    """Frame VAD = SPP of the per-frame summed power (reference
    spp_estimation.py:196-215)."""
    frame_power = spectrogram.sum(axis=0)
    est = SPPNoiseEstimator(frame_length=0)
    vad = np.zeros_like(frame_power)
    for i, p in enumerate(frame_power):
        _, spp = est.update(np.atleast_1d(p))
        vad[i] = spp[0]
    return vad


def timo_noise_estimation(spectrogram, mask):
    """Noise PSD track with an externally supplied SPP mask (reference
    spp_estimation.py:217-235)."""
    freq_bins, _ = spectrogram.shape
    est = SPPNoiseEstimator(frame_length=(freq_bins - 1) * 2)
    psd_track = np.zeros_like(spectrogram)
    for i, (frame, spp_in) in enumerate(zip(spectrogram.T, mask.T)):
        psd_track[:, i] = est.update(frame, spp_in)
        # NOTE: the reference's external-SPP path never advances _psd
        # (spp_estimation.py:137-146); behavior preserved for parity.
    return psd_track


# ---------------------------------------------------------------------------
# Device trackers
# ---------------------------------------------------------------------------


def _spp_step(fixed_smooth, prob_smooth, prior, snr_opt_db):
    """The tracking-phase update of one frame, the counterpart of the JAX
    package's `_spp_step` scan body past its init phase: (per, old_psd,
    smooth_prob) -> (spp, smooth2, track_psd), each of the frame's shape."""
    snr_opt_lin = 10.0 ** (snr_opt_db / 10.0)
    glr_factor = (1 - prior) / prior * (1.0 + snr_opt_lin)
    glr_exp = snr_opt_lin / (1.0 + snr_opt_lin)

    def step(per, old_psd, smooth_prob):
        inv_glr = glr_factor * torch.exp(-per / (old_psd + 1e-8) * glr_exp)
        spp = 1.0 / (1.0 + inv_glr)
        smooth2 = (1 - prob_smooth) * spp + prob_smooth * smooth_prob
        spp = torch.where(smooth2 > 0.99, torch.clamp_max(spp, 0.99), spp)
        noise_per = (1.0 - spp) * per + spp * old_psd
        track_psd = (1.0 - fixed_smooth) * noise_per + fixed_smooth * old_psd
        return spp, smooth2, track_psd

    return step


def spp_state_init(n_bins, batch=None, device=None, dtype=torch.float32):
    """Fresh carried state (old_psd, smooth_prob, frame count) for
    :func:`spp_track_chunk`: the tracker before its first frame. With
    `batch`, one state per row: (batch, n_bins) x2 and (batch,)."""
    lead = () if batch is None else (batch,)
    return (torch.zeros(lead + (n_bins,), dtype=dtype, device=device),
            torch.zeros(lead + (n_bins,), dtype=dtype, device=device),
            torch.zeros(lead, dtype=torch.int32, device=device))


def spp_track_chunk(power, state, n_valid=None,
                    fixed_smooth=SPP_FIX_SMOOTH,
                    prob_smooth=SPP_PROB_SMOOTH, prior=SPP_PRIOR,
                    snr_opt_db=SPP_SNR_OPT_DB,
                    num_frames_init=SPP_NUM_FRAMES_INIT):
    """State-carrying chunk tracker: (..., bins, frames) power + carried
    state -> (noise_psd, spp, new_state). Feeding a track chunk by chunk
    equals :func:`spp_track` on the whole track. Frames at or past
    `n_valid` (an int, or a tensor of the leading shape) emit outputs but do
    not advance the state (end-of-stream pads)."""
    step = _spp_step(fixed_smooth, prob_smooth, prior, snr_opt_db)
    old, smooth, idx = state
    P = power.movedim(-1, 0)
    n_valid = torch.as_tensor(P.shape[0] if n_valid is None else n_valid,
                              device=power.device)
    psd_out, spp_out = [], []
    for k in range(P.shape[0]):
        per = P[k]
        in_init = (idx < num_frames_init)[..., None]
        keep = k < n_valid
        spp, smooth2, track = step(per, old, smooth)
        new_old = torch.where(in_init, old + per / num_frames_init, track)
        new_smooth = torch.where(in_init, smooth, smooth2)
        psd_out.append(torch.where(in_init, per, track))
        spp_out.append(torch.where(in_init, torch.zeros_like(spp), spp))
        old = torch.where(keep[..., None], new_old, old)
        smooth = torch.where(keep[..., None], new_smooth, smooth)
        idx = torch.where(keep, idx + 1, idx)
    return (torch.stack(psd_out, dim=-1), torch.stack(spp_out, dim=-1),
            (old, smooth, idx))


def spp_track(power, fixed_smooth=SPP_FIX_SMOOTH,
              prob_smooth=SPP_PROB_SMOOTH, prior=SPP_PRIOR,
              snr_opt_db=SPP_SNR_OPT_DB,
              num_frames_init=SPP_NUM_FRAMES_INIT):
    """SPP tracker over (..., bins, frames) power spectrograms, every leading
    row on its own (the JAX package's `spp_track_jax`, vmapped over a batch
    axis). Returns (noise_psd, spp), both of power's shape. Every row
    starts at frame 0, so the init phase is a Python branch on the frame
    index instead of a per-element select."""
    step = _spp_step(fixed_smooth, prob_smooth, prior, snr_opt_db)
    P = power.movedim(-1, 0)
    old = torch.zeros_like(P[0])
    smooth = torch.zeros_like(P[0])
    zeros = torch.zeros_like(P[0])
    psd_out, spp_out = [], []
    for n in range(P.shape[0]):
        per = P[n]
        if n < num_frames_init:
            old = old + per / num_frames_init
            psd_out.append(per)
            spp_out.append(zeros)
        else:
            spp, smooth, old = step(per, old, smooth)
            psd_out.append(old)
            spp_out.append(spp)
    return torch.stack(psd_out, dim=-1), torch.stack(spp_out, dim=-1)


def timo_mask(power):
    """Soft TF mask of (..., bins, frames) power: the per-bin SPP (the JAX
    package's `timo_mask_estimation_jax`)."""
    return spp_track(power)[1]


def timo_vad(power):
    """Frame VAD of (..., bins, frames) power: the SPP of the per-frame
    summed power, (..., frames) (the JAX package's
    `timo_vad_estimation_jax`)."""
    return spp_track(power.sum(dim=-2, keepdim=True))[1][..., 0, :]
