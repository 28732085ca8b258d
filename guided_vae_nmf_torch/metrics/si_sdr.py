"""Scale-invariant SDR/SIR/SAR energy-ratio metrics.

Counterpart of `guided_vae_nmf_tpu/metrics/si_sdr.py` (reference
python/metrics.py:12-60): decompose the estimate as
s_hat = alpha_s*s + alpha_n*n + e_art by projection and report the three
ratios in dB. :func:`si_sdr_components` and :func:`energy_ratios` are the
port's own numpy copies; :func:`energy_ratios_torch` is the counterpart of
`energy_ratios_jax`, batched over leading axes in place of JAX's vmap.
"""

import numpy as np
import torch


def si_sdr_components(s_hat, s, n):
    """Projection decomposition (reference metrics.py:12-37)."""
    alpha_s = np.dot(s_hat, s) / np.linalg.norm(s) ** 2
    s_target = alpha_s * s
    alpha_n = np.dot(s_hat, n) / np.linalg.norm(n) ** 2
    e_noise = alpha_n * n
    e_art = s_hat - s_target - e_noise
    return s_target, e_noise, e_art


def energy_ratios(s_hat, s, n):
    """(si_sdr, si_sir, si_sar) in dB (reference metrics.py:39-60)."""
    s_target, e_noise, e_art = si_sdr_components(s_hat, s, n)
    t = np.linalg.norm(s_target) ** 2
    si_sdr = 10 * np.log10(t / np.linalg.norm(e_noise + e_art) ** 2)
    si_sir = 10 * np.log10(t / np.linalg.norm(e_noise) ** 2)
    si_sar = 10 * np.log10(t / np.linalg.norm(e_art) ** 2)
    return si_sdr, si_sir, si_sar


def energy_ratios_torch(s_hat, s, n):
    """(si_sdr, si_sir, si_sar) in dB over the last axis of (..., T)
    tensors, each of shape (...), on the inputs' device and in their dtype:
    a batch of utterances is one call.

    Every term is a dot product or a sum of squares over T, so zero-padded
    tails (the same samples zero in s_hat, s and n) leave a row's three
    ratios unchanged, up to the order in which the sums round: a padded
    batch gives each utterance's own ratios."""
    alpha_s = (s_hat * s).sum(-1, keepdim=True) / (s * s).sum(
        -1, keepdim=True)
    s_target = alpha_s * s
    alpha_n = (s_hat * n).sum(-1, keepdim=True) / (n * n).sum(
        -1, keepdim=True)
    e_noise = alpha_n * n
    e_art = s_hat - s_target - e_noise
    t = (s_target * s_target).sum(-1)
    si_sdr = 10 * torch.log10(t / ((e_noise + e_art) ** 2).sum(-1))
    si_sir = 10 * torch.log10(t / (e_noise * e_noise).sum(-1))
    si_sar = 10 * torch.log10(t / (e_art * e_art).sum(-1))
    return si_sdr, si_sir, si_sar
