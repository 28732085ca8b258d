"""STFT and masked ISTFT as products with DFT matrices (1024-point
periodic Hann window, hop 256, 513 bins), and PCM16 rounding."""

import math

import torch

from .precision import dtype, mm

NFFT = 1024
HOP = 256
BINS = NFFT // 2 + 1


def _window(prec, device):
    n = torch.arange(NFFT, dtype=torch.float64, device=device)
    return (0.5 - 0.5 * torch.cos(2 * math.pi * n / NFFT)).to(dtype(prec))


def _angles(device):
    n = torch.arange(NFFT, dtype=torch.float64, device=device)
    k = torch.arange(BINS, dtype=torch.float64, device=device)
    # k n mod NFFT keeps the angle's argument exact
    return 2 * math.pi * ((n[:, None] * k[None, :]) % NFFT) / NFFT


def stft(x, prec):
    """x (B, L) host-padded waveforms scaled to [-1, 1) -> (re, im), each
    (B, N, BINS) frames-major, N = 1 + (L - NFFT) // HOP."""
    x = x.to(dtype(prec))
    n_frames = 1 + (x.shape[-1] - NFFT) // HOP
    frames = x.unfold(-1, NFFT, HOP)[:, :n_frames] * _window(prec, x.device)
    a = _angles(x.device)
    cos, sin = torch.cos(a).to(x.dtype), (-torch.sin(a)).to(x.dtype)
    return mm(frames, cos, prec), mm(frames, sin, prec)


def _overlap_add(frames):
    B, N, _ = frames.shape
    y = frames.new_zeros((B, NFFT + HOP * (N - 1)))
    for p in range(NFFT // HOP):
        flat = frames[:, p::NFFT // HOP].reshape(B, -1)
        y[:, p * HOP: p * HOP + flat.shape[1]] += flat
    return y


def istft_masked(re, im, mask, prec):
    """(re, im) (B, N, BINS) and the frame mask (B, N) -> (B, HOP (N - 1))
    waveforms: only valid frames enter the overlap-add and the squared
    window's normalisation; the centre padding is trimmed."""
    a = _angles(re.device).T                       # (BINS, NFFT)
    wk = torch.full((BINS, 1), 2.0, dtype=torch.float64, device=re.device)
    wk[0] = wk[-1] = 1.0
    cos = (wk * torch.cos(a) / NFFT).to(re.dtype)
    sin = (-wk * torch.sin(a) / NFFT).to(re.dtype)
    frames = mm(re, cos, prec) + mm(im, sin, prec)
    win = _window(prec, re.device)
    m = mask.to(re.dtype)[..., None]
    y = _overlap_add(frames * win * m)
    wss = _overlap_add((win * win).expand(frames.shape) * m)
    y = torch.where(wss > torch.finfo(torch.float32).tiny, y / wss, y)
    return y[:, NFFT // 2: y.shape[1] - NFFT // 2]


def pcm16(w):
    return torch.clamp(torch.round(w * 32768.0), -32768, 32767).to(
        torch.int32)
