"""STFT / inverse STFT: host-side numpy helpers and batched torch versions.

Counterpart of `guided_vae_nmf_tpu/dsp/stft.py`. The numpy functions
(`stft_params`, `periodic_hann`, the end-pad rule, the host :func:`stft` /
:func:`istft`, `pad_signal_for_stft`, `frame_count`) are the port's own
copies. The device functions are torch:

  * :func:`stft_torch` / :func:`istft_torch` <- `stft_jax` / `istft_jax`
    (one utterance)
  * :func:`stft_batch_padded` <- `stft_batch_padded_jax`
  * :func:`istft_masked` <- `istft_masked_jax` (batched over leading dims)
  * :func:`istft_masked_ri` <- `istft_masked_ri_jax`

Frozen conventions: fs=16 kHz, nfft=1024 (513 bins), hop=256, periodic
hann, centered reflect padding (done per utterance on the host), one extra
hop of zeros when the length is not a hop multiple.

Framing is a strided view (`unfold`, an exact copy of the samples). The
overlap-add keeps the JAX package's reshape-and-pad form, so every output
sample sums its contributing frames in the same order as the reference.
"""

import math

import numpy as np
import torch
import torch.nn.functional as F


def stft_params(fs=16000, wlen_sec=64e-3, hop_percent=0.25):
    """Resolve (nfft, hop); ValueError when wlen_sec*fs is not an integer."""
    if wlen_sec * fs != int(wlen_sec * fs):
        raise ValueError("wlen_sample of STFT is not an integer.")
    nfft = int(wlen_sec * fs)
    hopsamp = int(hop_percent * nfft)
    return nfft, hopsamp


def periodic_hann(n):
    """Periodic (DFT-even) Hann window of length n, float64."""
    return 0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(n) / n)


def _end_pad_len(n, fs, wlen_sec, hop_percent, hopsamp):
    """Zeros the end-padding rule appends to an `n`-sample utterance: one
    hop unless the duration is an exact multiple of the hop, compared in
    float seconds."""
    utt_len = n / fs
    if math.ceil(utt_len / wlen_sec / hop_percent) != int(
        utt_len / wlen_sec / hop_percent
    ):
        return hopsamp
    return 0


def _maybe_end_pad(x, fs, wlen_sec, hop_percent, hopsamp):
    """End-padding rule applied to a signal (see :func:`_end_pad_len`)."""
    z = _end_pad_len(len(x), fs, wlen_sec, hop_percent, hopsamp)
    if z:
        return np.pad(x, (0, z), mode="constant")
    return x


def stft(
    x,
    fs=16e3,
    wlen_sec=64e-3,
    win="hann",
    hop_percent=0.25,
    center=True,
    pad_mode="reflect",
    pad_at_end=True,
    dtype="complex64",
):
    """Host STFT, (nfft//2+1, n_frames) complex64: the end-pad rule,
    centered reflect padding of nfft//2 samples, a periodic hann window and
    the rfft of each windowed frame, in the input's float precision, then
    cast to `dtype`."""
    if win != "hann":
        raise ValueError("only hann windows are supported")
    fs = int(fs)
    nfft, hopsamp = stft_params(fs, wlen_sec, hop_percent)

    x = np.asarray(x)
    if pad_at_end:
        x = _maybe_end_pad(x, fs, wlen_sec, hop_percent, hopsamp)
    if center:
        x = np.pad(x, nfft // 2, mode=pad_mode)

    n_frames = 1 + (len(x) - nfft) // hopsamp
    window = periodic_hann(nfft)
    frames = np.lib.stride_tricks.as_strided(
        x,
        shape=(n_frames, nfft),
        strides=(x.strides[0] * hopsamp, x.strides[0]),
    )
    Sxx = np.fft.rfft(frames * window, axis=-1).T
    return Sxx.astype(dtype)


def istft(
    Sxx,
    fs=16000,
    wlen_sec=64e-3,
    win="hann",
    hop_percent=0.25,
    center=True,
    dtype="float32",
    max_len=None,
):
    """Host inverse STFT: windowed overlap-add in float64, normalised by the
    summed squared window; `max_len` truncates or zero-pads the output to
    that many samples (callers pass the original sample count)."""
    if win != "hann":
        raise ValueError("only hann windows are supported")
    nfft, hopsamp = stft_params(fs, wlen_sec, hop_percent)
    window = periodic_hann(nfft)

    Sxx = np.asarray(Sxx)
    n_frames = Sxx.shape[1]
    expected_len = nfft + hopsamp * (n_frames - 1)

    frames = np.fft.irfft(Sxx.T, n=nfft, axis=-1) * window
    y = np.zeros(expected_len, dtype=np.float64)
    wss = np.zeros(expected_len, dtype=np.float64)
    wsq = window**2
    for i in range(n_frames):
        start = i * hopsamp
        y[start: start + nfft] += frames[i]
        wss[start: start + nfft] += wsq
    nz = wss > np.finfo(np.float64).tiny
    y[nz] /= wss[nz]

    if center:
        y = y[nfft // 2: expected_len - nfft // 2]

    if max_len is not None:
        out = np.zeros(int(max_len), dtype=np.float64)
        n = min(len(y), int(max_len))
        out[:n] = y[:n]
        y = out
    return y.astype(dtype)


def frame_count(
    n_samples, fs=16000, wlen_sec=64e-3, hop_percent=0.25, pad_at_end=True
):
    """Number of STFT frames of an n_samples-long signal (centered +
    end-pad rule)."""
    nfft, hopsamp = stft_params(fs, wlen_sec, hop_percent)
    utt_len = n_samples / fs
    if pad_at_end and math.ceil(utt_len / wlen_sec / hop_percent) != int(
        utt_len / wlen_sec / hop_percent
    ):
        n_samples = n_samples + hopsamp
    return 1 + n_samples // hopsamp


def pad_signal_for_stft(x, fs=16000, wlen_sec=64e-3, hop_percent=0.25):
    """Host-side pre-padding for :func:`stft_batch_padded`: the end-pad rule
    plus centered reflect padding -> (padded signal, n_valid_frames). Float
    input comes back float32, int16 PCM stays int16 (the device applies the
    1/32768 scaling). The padded length can exceed (n_valid_frames-1)*hop +
    nfft by up to hop-1 samples that belong to no frame."""
    nfft, hopsamp = stft_params(fs, wlen_sec, hop_percent)
    x = np.asarray(x)
    x = _maybe_end_pad(x, fs, wlen_sec, hop_percent, hopsamp)
    n_frames = 1 + len(x) // hopsamp
    xp = np.pad(x, nfft // 2, mode="reflect")
    if xp.dtype != np.int16:
        xp = xp.astype(np.float32)
    return xp, n_frames


def _window(nfft, device):
    return torch.as_tensor(periodic_hann(nfft), dtype=torch.float32,
                           device=device)


def stft_torch(x, nfft=1024, hopsamp=256):
    """Float32 STFT of one 1-D signal tensor -> (nfft//2+1, n_frames)
    complex64 on its device: one hop of zeros at the end when the length
    is not a hop multiple (the length-based end-pad rule), then centered
    reflect padding."""
    x = x.to(torch.float32)
    if x.shape[0] % hopsamp:
        x = F.pad(x, (0, hopsamp))
    xp = F.pad(x[None, None], (nfft // 2, nfft // 2), mode="reflect")[0, 0]
    return stft_batch_padded(xp[None], nfft, hopsamp)[0]


def stft_batch_padded(x_pad, nfft=1024, hopsamp=256):
    """Batched STFT of host-pre-padded signals: (B, L) float32 -> (B,
    nfft//2+1, n_frames) complex64, n_frames = 1 + (L - nfft) // hopsamp."""
    n_frames = 1 + (x_pad.shape[-1] - nfft) // hopsamp
    frames = x_pad.unfold(-1, nfft, hopsamp)[..., :n_frames, :]
    frames = frames * _window(nfft, x_pad.device)
    return torch.fft.rfft(frames, dim=-1).transpose(-1, -2)


def _overlap_add(frames, nfft, hopsamp):
    """Overlap-add of (..., n_frames, nfft) frames at hop `hopsamp`: frames
    taken every nfft//hopsamp rows land at contiguous, non-overlapping
    output positions, so the sum is `ratio` reshapes + shifted pads, added
    in phase order as the reference does."""
    ratio = nfft // hopsamp
    if ratio * hopsamp != nfft:
        raise ValueError(f"hop {hopsamp} must divide nfft {nfft}")
    n_frames = frames.shape[-2]
    lead = frames.shape[:-2]
    expected_len = nfft + hopsamp * (n_frames - 1)
    y = frames.new_zeros(lead + (expected_len,))
    for p in range(ratio):
        flat = frames[..., p::ratio, :].reshape(lead + (-1,))
        start = p * hopsamp
        y = y + F.pad(flat, (start, expected_len - start - flat.shape[-1]))
    return y


def istft_masked(Sxx, frame_mask, nfft=1024, hopsamp=256):
    """Inverse STFT of frame-padded spectrograms (..., F, n_frames) complex
    with (..., n_frames) frame masks: only frames with mask 1 enter the
    overlap-add numerator and the squared-window normalization, so valid
    samples equal an unpadded ISTFT. Returns the padded-length signal."""
    n_frames = Sxx.shape[-1]
    expected_len = nfft + hopsamp * (n_frames - 1)
    window = _window(nfft, Sxx.device)
    frames = torch.fft.irfft(Sxx.transpose(-1, -2), n=nfft, dim=-1)
    m = frame_mask[..., None].to(torch.float32)
    y = _overlap_add(frames * window * m, nfft, hopsamp)
    wss = _overlap_add((window**2).expand(frames.shape) * m, nfft, hopsamp)
    y = torch.where(wss > torch.finfo(torch.float32).tiny, y / wss, y)
    return y[..., nfft // 2: expected_len - nfft // 2]


def istft_torch(Sxx, nfft=1024, hopsamp=256, max_len=None):
    """Float32 inverse STFT of one (nfft//2+1, n_frames) complex tensor:
    windowed overlap-add normalised by the summed squared window, the
    centre padding trimmed; `max_len` truncates or zero-pads the output."""
    n_frames = Sxx.shape[-1]
    expected_len = nfft + hopsamp * (n_frames - 1)
    window = _window(nfft, Sxx.device)
    frames = torch.fft.irfft(Sxx.transpose(-1, -2), n=nfft, dim=-1) * window
    y = _overlap_add(frames, nfft, hopsamp)
    wss = _overlap_add((window**2).expand(frames.shape), nfft, hopsamp)
    y = torch.where(wss > torch.finfo(torch.float32).tiny, y / wss, y)
    y = y[nfft // 2: expected_len - nfft // 2]
    if max_len is not None:
        y = F.pad(y, (0, max(0, int(max_len) - y.shape[0])))[: int(max_len)]
    return y


def istft_masked_ri(S_re, S_im, frame_mask, nfft=1024, hopsamp=256):
    """Real/imag-input variant of :func:`istft_masked`."""
    return istft_masked(torch.complex(S_re, S_im), frame_mask, nfft=nfft,
                        hopsamp=hopsamp)
