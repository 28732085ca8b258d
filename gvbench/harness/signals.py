"""Traffic from a seed: utterance lengths, SNRs, arrival times and the
speech-like mixtures themselves.

Every seed gets the same set of lengths (gamma quantiles), SNRs and
inter-arrival gaps (exponential quantiles), in an order drawn from the
seed, so two seeds give the same work in another order. The mixtures are
`chip_smoke.speech_like_mixtures`'s (frozen here): harmonic voiced tones
with a gliding f0, formant-like tilt and syllable-rate gating, plus
low-passed noise at the SNR; the harmonic sums run on the device in
float64.
"""

import math

import numpy as np
import torch
from scipy.special import gammaincinv

FS = 16000
NFFT = 1024
HOP = 256


def length_set(n, spec):
    """n lengths in samples: the gamma(shape, mean) quantiles at
    (i + 0.5) / n, clipped to [min, max] seconds."""
    q = (np.arange(n) + 0.5) / n
    k = spec["gamma_shape"]
    sec = gammaincinv(k, q) * spec["mean"] / k
    sec = np.clip(sec, spec["min"], spec["max"])
    return (sec * FS).astype(np.int64)


def snr_set(n, values):
    return np.asarray([values[i % len(values)] for i in range(n)], float)


def arrival_times(n, rate, seconds):
    """n arrival times in [0, seconds): exponential gaps at the quantiles
    (i + 0.5) / n, scaled to sum to `seconds` (so the rate is n / seconds);
    the caller permutes the gaps."""
    q = (np.arange(n) + 0.5) / n
    gaps = -np.log1p(-q) / rate
    return gaps * (seconds / gaps.sum())


def draw(seed, n, length_spec, snrs, rate=None, seconds=None):
    """The traffic of one run: (lengths, snrs, per-utterance seeds, arrival
    times or None), each permuted by the seed."""
    rng = np.random.default_rng(seed)
    lens = rng.permutation(length_set(n, length_spec))
    snr = rng.permutation(snr_set(n, snrs))
    useeds = rng.integers(0, 2**31 - 1, size=n)
    times = None
    if rate is not None:
        gaps = rng.permutation(arrival_times(n, rate, seconds))
        times = np.concatenate([[0.0], np.cumsum(gaps)[:-1]])
    return lens, snr, useeds, times


def speech_like(seed, n, snr_db, device):
    """One int16 (clean, mixture) pair of n samples."""
    rng = np.random.RandomState(seed)
    f0b, fm = rng.uniform(100, 200), rng.uniform(0.2, 0.6)
    rate, ph = rng.uniform(3, 5), rng.uniform(0, 6)
    noise = np.convolve(rng.randn(n), np.ones(4) / 4, mode="same")
    f64 = dict(dtype=torch.float64, device=device)
    t = torch.arange(n, **f64) / FS
    f0 = f0b * (1 + 0.1 * torch.sin(2 * math.pi * fm * t))
    phase = 2 * math.pi * torch.cumsum(f0, 0) / FS
    k = torch.arange(1, 30, **f64)[:, None]
    amp = torch.exp(-((k * f0.mean() - 700) / 900) ** 2) / k**0.5
    s = torch.sum(torch.where(k * f0 < 7000, amp, 0.0)
                  * torch.sin(k * phase), dim=0)
    s = s * (0.5 - 0.5 * torch.cos(2 * math.pi * rate * t))
    s = s * (torch.sin(2 * math.pi * 0.7 * t + ph) > -0.6)
    nz = torch.as_tensor(noise, **f64)
    nz = nz * torch.sqrt(torch.mean(s**2) / torch.mean(nz**2)
                         / 10 ** (snr_db / 10))
    x = s + nz
    scale = 0.5 / torch.max(torch.abs(x))
    return (torch.round(s * scale * 32767).to(torch.int16).cpu().numpy(),
            torch.round(x * scale * 32767).to(torch.int16).cpu().numpy())


def mixtures(lens, snrs, useeds, device):
    return [speech_like(int(s), int(n), float(r), device)[1]
            for n, r, s in zip(lens, snrs, useeds)]


def _end_pad(n):
    """Zeros the end-padding rule appends to an n-sample utterance: one hop
    unless the duration is a whole number of hops, compared in float
    seconds."""
    q = n / FS / (NFFT / FS) / (HOP / NFFT)
    return HOP if math.ceil(q) != int(q) else 0


def frame_count(n):
    return 1 + (n + _end_pad(n)) // HOP


def bucket(n_frames, multiple=128):
    return -(-n_frames // multiple) * multiple


def padded(signals, n_pad=None):
    """Host-padded int16 rows (rows, L) and frame masks (rows, n_pad) of
    `signals`, as the program's sweep assembles them: the end-pad rule,
    then NFFT / 2 of reflect padding each side."""
    frames = [frame_count(len(x)) for x in signals]
    n_pad = n_pad or bucket(max(frames))
    L = (n_pad - 1) * HOP + NFFT
    x_b = np.zeros((len(signals), L), np.int16)
    mask = np.zeros((len(signals), n_pad), np.float32)
    for j, (x, nf) in enumerate(zip(signals, frames)):
        xp = np.pad(np.pad(x, (0, _end_pad(len(x)))), NFFT // 2,
                    mode="reflect")
        x_b[j, : min(len(xp), L)] = xp[:L]
        mask[j, :nf] = 1.0
    return x_b, mask


def plan_batches(n_frames, batch_size=16, bucket_multiple=128, seed=0):
    """`pipeline.plan_batches`'s rule (one device): utterances bucketed by
    padded frame count, each bucket cut into batches of batch_size * 512 /
    max(n_pad, 512) rows, buckets in increasing length; each utterance's
    seed drawn from `seed` by its index. Returns [(indices, n_pad,
    seeds)]."""
    groups = {}
    for i, nf in enumerate(n_frames):
        groups.setdefault(bucket(nf, bucket_multiple), []).append(i)
    seeds = np.random.default_rng(seed).integers(
        0, 2**62, size=max(len(n_frames), 1))
    out = []
    for n_pad, idxs in sorted(groups.items()):
        eff = max(1, batch_size * 512 // max(n_pad, 512))
        for lo in range(0, len(idxs), eff):
            sel = idxs[lo: lo + eff]
            out.append((sel, n_pad, seeds[np.asarray(sel)]))
    return out
