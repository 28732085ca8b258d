"""The speech-presence-probability noise tracker (Gerkmann and Hendriks'
MMSE-SPP estimator with a fixed a-priori SNR), frame by frame over a
(B, F, N) power spectrogram; every row starts at frame 0. The first
`num_frames_init` frames average the power into the initial noise PSD and
emit the frame's own power."""

import torch

FIX_SMOOTH = 0.8
PROB_SMOOTH = 0.9
PRIOR = 0.5
SNR_OPT_DB = 15
NUM_FRAMES_INIT = 10


def spp_noise_psd(power):
    snr = 10.0 ** (SNR_OPT_DB / 10.0)
    glr_factor = (1 - PRIOR) / PRIOR * (1.0 + snr)
    glr_exp = snr / (1.0 + snr)
    P = power.movedim(-1, 0)
    old = torch.zeros_like(P[0])
    smooth = torch.zeros_like(P[0])
    out = []
    for n in range(P.shape[0]):
        per = P[n]
        if n < NUM_FRAMES_INIT:
            old = old + per / NUM_FRAMES_INIT
            out.append(per)
            continue
        spp = 1.0 / (1.0 + glr_factor * torch.exp(-per / (old + 1e-8)
                                                  * glr_exp))
        smooth = (1 - PROB_SMOOTH) * spp + PROB_SMOOTH * smooth
        spp = torch.where(smooth > 0.99, torch.clamp_max(spp, 0.99), spp)
        noise = (1.0 - spp) * per + spp * old
        old = (1.0 - FIX_SMOOTH) * noise + FIX_SMOOTH * old
        out.append(old)
    return torch.stack(out, dim=-1)
