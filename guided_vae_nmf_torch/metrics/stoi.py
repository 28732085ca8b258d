"""STOI / ESTOI intelligibility metrics.

The reference consumes `pystoi.stoi(..., extended=True)` for ESTOI
(reference scripts/run_metrics_M1.py:18,76-84). That package (and its
dependencies) are not part of this framework; the metrics are implemented
here from the source papers:

  * C. Taal et al., "An Algorithm for Intelligibility Prediction of
    Time-Frequency Weighted Noisy Speech," IEEE TASLP 2011 (STOI).
  * J. Jensen, C. Taal, "An Algorithm for Predicting the Intelligibility of
    Speech Masked by Modulated Noise Maskers," IEEE/ACM TASLP 2016 (ESTOI).

Conventions follow the standard public implementation so reported numbers
are comparable: 10 kHz internal rate, 25.6 ms frames with 50% overlap and
512-point FFT, 15 one-third-octave bands from 150 Hz, 40 dB dynamic-range
silence removal, 384 ms (30-frame) analysis segments. Two non-obvious
details are matched deliberately: framing uses an exclusive endpoint (the
final frame is dropped even when it fits exactly) and resampling uses an
Octave-style 60 dB Kaiser-windowed-sinc FIR, both of which shift scores
at the 1e-3 level if done the "natural" way. Golden regression values in
tests/metrics/test_goldens.py; cross-implementation deltas via
scripts/validate_stoi.py where pystoi is installed.

The port's own copy of `guided_vae_nmf_tpu/metrics/stoi.py` (numpy);
`tests/test_torch_metrics.py` holds the two equal bit for bit.
"""

import numpy as np
from scipy.signal import resample_poly

FS_INTERNAL = 10000
FRAME_LEN = 256
HOP = 128
NFFT = 512
NUM_BANDS = 15
MIN_FREQ = 150.0
SEG_LEN = 30  # frames per analysis segment (384 ms)
DYN_RANGE = 40.0
BETA_DB = -15.0  # STOI clipping threshold


def _hann_interior(n):
    """Interior Hann taper (n+2 points, endpoints dropped) — the framing
    window used by the canonical STOI implementation."""
    return np.hanning(n + 2)[1:-1]


def third_octave_band_matrix(fs=FS_INTERNAL, nfft=NFFT, num_bands=NUM_BANDS,
                             min_freq=MIN_FREQ):
    """(num_bands, nfft//2+1) 0/1 matrix grouping FFT bins into 1/3-octave
    bands with nearest-bin edge rounding."""
    f = np.linspace(0, fs, nfft + 1)[: nfft // 2 + 1]
    k = np.arange(num_bands, dtype=np.float64)
    cf = 2.0 ** (k / 3.0) * min_freq
    freq_low = min_freq * 2.0 ** ((2 * k - 1) / 6.0)
    freq_high = min_freq * 2.0 ** ((2 * k + 1) / 6.0)
    obm = np.zeros((num_bands, len(f)))
    for i in range(num_bands):
        lo = int(np.argmin((f - freq_low[i]) ** 2))
        hi = int(np.argmin((f - freq_high[i]) ** 2))
        obm[i, lo:hi] = 1.0
    return obm, cf


def _frame(x, frame_len=FRAME_LEN, hop=HOP):
    # frame starts i in range(0, len(x) - frame_len, hop): the canonical
    # implementation's exclusive endpoint drops the final frame even when
    # it fits exactly — kept for numeric compatibility
    n_frames = max((len(x) - frame_len + hop - 1) // hop, 0)
    if n_frames <= 0:
        return np.zeros((0, frame_len))
    idx = np.arange(n_frames)[:, None] * hop + np.arange(frame_len)[None, :]
    return x[idx]


def remove_silent_frames(x, y, dyn_range=DYN_RANGE, frame_len=FRAME_LEN,
                         hop=HOP):
    """Drop frames whose clean-speech energy is more than dyn_range dB below
    the loudest frame; rebuild both signals by overlap-adding the kept
    windowed frames."""
    w = _hann_interior(frame_len)
    xf = _frame(x, frame_len, hop) * w
    yf = _frame(y, frame_len, hop) * w
    energies = 20 * np.log10(np.linalg.norm(xf, axis=1) + 1e-16)
    mask = energies > np.max(energies) - dyn_range
    xf, yf = xf[mask], yf[mask]
    n = len(xf)
    out_len = frame_len + (n - 1) * hop if n else 0
    xs = np.zeros(out_len)
    ys = np.zeros(out_len)
    for i in range(n):
        xs[i * hop : i * hop + frame_len] += xf[i]
        ys[i * hop : i * hop + frame_len] += yf[i]
    return xs, ys


def _band_envelopes(x, obm):
    """sqrt of 1/3-octave band energies per frame: (num_bands, n_frames)."""
    w = _hann_interior(FRAME_LEN)
    frames = _frame(x, FRAME_LEN, HOP) * w
    spec = np.fft.rfft(frames, NFFT, axis=1)
    return np.sqrt((np.abs(spec) ** 2) @ obm.T).T


def _octave_resample_window(p, q):
    """Anti-aliasing FIR designed the way Octave's `resample` does it
    (60 dB Kaiser-windowed sinc) — the filter the canonical STOI
    implementation resamples with, kept for numeric compatibility."""
    rejection_db = 60.0
    cutoff = 1.0 / (2.0 * max(p, q))
    roll_off_width = cutoff / 10.0
    half_len = int(np.ceil((rejection_db - 8.0) /
                           (28.714 * roll_off_width)))
    t = np.arange(-half_len, half_len + 1)
    ideal = 2 * p * cutoff * np.sinc(2 * cutoff * t)
    beta = 0.1102 * (rejection_db - 8.7)
    return np.kaiser(2 * half_len + 1, beta) * ideal


def _resample(x, fs):
    if fs == FS_INTERNAL:
        return x
    g = np.gcd(int(fs), FS_INTERNAL)
    p, q = FS_INTERNAL // g, int(fs) // g
    h = _octave_resample_window(p, q)
    return resample_poly(x, p, q, window=h / np.sum(h))


def stoi(x, y, fs_sig, extended=False):
    """Intelligibility of degraded speech y given clean x.

    extended=False: classic STOI — per-band per-segment correlation of
    clipped, energy-normalized envelopes. extended=True: ESTOI —
    row/column-normalized segment correlation. Returns a scalar in ~[0, 1].
    """
    x = np.asarray(x, np.float64)
    y = np.asarray(y, np.float64)
    if x.shape != y.shape:
        raise ValueError("x and y must have the same length")
    x = _resample(x, fs_sig)
    y = _resample(y, fs_sig)
    x, y = remove_silent_frames(x, y)

    obm, _ = third_octave_band_matrix()
    X = _band_envelopes(x, obm)
    Y = _band_envelopes(y, obm)
    M = X.shape[1] - SEG_LEN + 1
    if M <= 0:
        raise ValueError("signal too short for a 384 ms STOI segment")

    if extended:
        d = 0.0
        for m in range(M):
            Xs = X[:, m : m + SEG_LEN]
            Ys = Y[:, m : m + SEG_LEN]
            Xn = Xs - Xs.mean(axis=1, keepdims=True)
            Xn /= np.linalg.norm(Xn, axis=1, keepdims=True) + 1e-16
            Yn = Ys - Ys.mean(axis=1, keepdims=True)
            Yn /= np.linalg.norm(Yn, axis=1, keepdims=True) + 1e-16
            Xn = Xn - Xn.mean(axis=0, keepdims=True)
            Xn /= np.linalg.norm(Xn, axis=0, keepdims=True) + 1e-16
            Yn = Yn - Yn.mean(axis=0, keepdims=True)
            Yn /= np.linalg.norm(Yn, axis=0, keepdims=True) + 1e-16
            d += np.sum(Xn * Yn) / SEG_LEN
        return d / M

    c = 10 ** (-BETA_DB / 20.0)
    d = 0.0
    for m in range(M):
        Xs = X[:, m : m + SEG_LEN]
        Ys = Y[:, m : m + SEG_LEN]
        alpha = np.linalg.norm(Xs, axis=1, keepdims=True) / (
            np.linalg.norm(Ys, axis=1, keepdims=True) + 1e-16
        )
        Yp = np.minimum(Ys * alpha, Xs * (1 + c))
        Xc = Xs - Xs.mean(axis=1, keepdims=True)
        Yc = Yp - Yp.mean(axis=1, keepdims=True)
        corr = np.sum(Xc * Yc, axis=1) / (
            np.linalg.norm(Xc, axis=1) * np.linalg.norm(Yc, axis=1) + 1e-16
        )
        d += corr.sum()
    return d / (M * NUM_BANDS)


def estoi(x, y, fs_sig):
    """Convenience wrapper: ESTOI (reference calls
    `stoi(..., extended=True)`)."""
    return stoi(x, y, fs_sig, extended=True)
