"""Classical objective speech-quality measures.

Beyond the reference's SI-SDR/ESTOI/PESQ protocol, these are the standard
intrusive measures from Quackenbush/Hansen and Hu & Loizou ("Evaluation of
objective quality measures for speech enhancement", IEEE TASLP 2008):

  * segmental SNR (time domain, clamped to [-10, 35] dB over voiced frames)
  * frequency-weighted segmental SNR (critical-band, |S|^0.2 weights)
  * log-likelihood ratio (LPC-based, order fs/1000 + 2)
  * weighted spectral slope (Klatt 1982)

All numpy, frame conventions: 30 ms Hann windows with 75% overlap at the
native rate.

The port's own copy of `guided_vae_nmf_tpu/metrics/objective.py`
(numpy); `tests/test_torch_metrics.py` holds the two equal bit for bit.
"""

import numpy as np

EPS = 1e-10


def _frames(x, frame_len, hop):
    n = (len(x) - frame_len) // hop + 1
    idx = np.arange(n)[:, None] * hop + np.arange(frame_len)[None, :]
    return x[idx]


def seg_snr(clean, estimate, fs=16000, frame_sec=0.03, overlap=0.75,
            floor=-10.0, ceil=35.0):
    """Segmental SNR in dB, mean over frames, clamped per frame to
    [floor, ceil]."""
    n = min(len(clean), len(estimate))
    clean, estimate = clean[:n], estimate[:n]
    frame_len = int(frame_sec * fs)
    hop = int(frame_len * (1 - overlap))
    s = _frames(clean, frame_len, hop)
    e = _frames(clean - estimate, frame_len, hop)
    num = np.sum(s**2, axis=1)
    den = np.sum(e**2, axis=1)
    snr = 10 * np.log10((num + EPS) / (den + EPS))
    return float(np.mean(np.clip(snr, floor, ceil)))


def _crit_band_filters(n_bins, fs, n_bands=25):
    """Gaussian-shaped critical-band filters on the linear FFT grid
    (center frequencies per Hu & Loizou's fwSegSNR implementation
    convention: Bark-spaced up to ~3.7 kHz, extended for wideband)."""
    # Bark scale centers up to fs/2
    f = np.linspace(0, fs / 2, n_bins)
    bark = 6 * np.arcsinh(f / 600.0)
    centers = np.linspace(bark[1], bark[-1] * 0.95, n_bands)
    width = (centers[1] - centers[0])
    filt = np.exp(-0.5 * ((bark[None, :] - centers[:, None]) /
                          (0.5 * width)) ** 2)
    filt /= filt.sum(axis=1, keepdims=True) + EPS
    return filt


def fw_seg_snr(clean, estimate, fs=16000, frame_sec=0.03, overlap=0.75,
               n_bands=25, gamma=0.2, floor=-10.0, ceil=35.0):
    """Frequency-weighted segmental SNR (Hu & Loizou 2008): per-frame
    critical-band SNRs weighted by the clean band magnitude^gamma."""
    n = min(len(clean), len(estimate))
    clean, estimate = clean[:n], estimate[:n]
    frame_len = int(frame_sec * fs)
    hop = int(frame_len * (1 - overlap))
    win = np.hanning(frame_len)
    S = np.abs(np.fft.rfft(_frames(clean, frame_len, hop) * win, axis=1))
    E = np.abs(np.fft.rfft(_frames(estimate, frame_len, hop) * win, axis=1))
    filt = _crit_band_filters(S.shape[1], fs, n_bands)
    Sb = S**2 @ filt.T
    Eb = E**2 @ filt.T
    W = Sb ** (gamma / 2)
    band_snr = 10 * np.log10((Sb + EPS) / ((np.sqrt(Sb) -
                                            np.sqrt(Eb)) ** 2 + EPS))
    band_snr = np.clip(band_snr, floor, ceil)
    return float(np.mean(np.sum(W * band_snr, axis=1) /
                         (np.sum(W, axis=1) + EPS)))


def _lpc(frame, order):
    """Autocorrelation-method LPC via Levinson-Durbin; returns
    (a (order+1,), autocorrelation R (order+1,))."""
    r = np.correlate(frame, frame, mode="full")[len(frame) - 1:
                                                len(frame) + order]
    a = np.zeros(order + 1)
    a[0] = 1.0
    err = r[0] + EPS
    for i in range(1, order + 1):
        acc = r[i] + np.dot(a[1:i], r[i - 1:0:-1])
        k = -acc / err
        a[1:i + 1] = a[1:i + 1] + k * a[i - 1::-1][:i]
        err *= (1 - k * k)
        if err <= 0:
            err = EPS
    return a, r


def llr(clean, estimate, fs=16000, frame_sec=0.03, overlap=0.75,
        order=None):
    """Log-likelihood ratio, mean over frames (lower is better; Hu &
    Loizou use the mean of the smallest 95% — kept plain mean here with
    an outlier clamp at 2.0 per their practice)."""
    n = min(len(clean), len(estimate))
    clean, estimate = clean[:n], estimate[:n]
    if order is None:
        order = int(fs / 1000) + 2
    frame_len = int(frame_sec * fs)
    hop = int(frame_len * (1 - overlap))
    win = np.hanning(frame_len)
    sf = _frames(clean, frame_len, hop) * win
    ef = _frames(estimate, frame_len, hop) * win
    vals = []
    for i in range(sf.shape[0]):
        if np.sum(sf[i] ** 2) < 1e-8:
            continue
        a_c, r_c = _lpc(sf[i], order)
        a_d, _ = _lpc(ef[i], order)
        R = np.array([[r_c[abs(j - k)] for k in range(order + 1)]
                      for j in range(order + 1)])
        num = a_d @ R @ a_d
        den = a_c @ R @ a_c
        if den > 0 and num > 0:
            vals.append(min(np.log(num / den + EPS), 2.0))
    return float(np.mean(vals)) if vals else 0.0


def wss(clean, estimate, fs=16000, frame_sec=0.03, overlap=0.75,
        n_bands=25, Kmax=20.0, Klocmax=1.0):
    """Weighted spectral slope distance (Klatt 1982), mean over frames
    (lower is better)."""
    n = min(len(clean), len(estimate))
    clean, estimate = clean[:n], estimate[:n]
    frame_len = int(frame_sec * fs)
    hop = int(frame_len * (1 - overlap))
    win = np.hanning(frame_len)
    S = np.abs(np.fft.rfft(_frames(clean, frame_len, hop) * win, axis=1))
    E = np.abs(np.fft.rfft(_frames(estimate, frame_len, hop) * win, axis=1))
    filt = _crit_band_filters(S.shape[1], fs, n_bands)
    Sb = 10 * np.log10(S**2 @ filt.T + EPS)
    Eb = 10 * np.log10(E**2 @ filt.T + EPS)
    ds = np.diff(Sb, axis=1)
    de = np.diff(Eb, axis=1)
    # weights from peak/valley proximity (Klatt's W)
    vals = []
    for i in range(Sb.shape[0]):
        s, e = Sb[i], Eb[i]
        smax = s.max()
        # nearest local peak above each band
        locpeak = np.maximum.accumulate(s[::-1])[::-1]
        Ws = (Kmax / (Kmax + smax - s[:-1])) * \
             (Klocmax / (Klocmax + locpeak[:-1] - s[:-1]))
        vals.append(np.sum(Ws * (ds[i] - de[i]) ** 2) / (np.sum(Ws) + EPS))
    return float(np.mean(vals))
