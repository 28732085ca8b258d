"""First-party PESQ (ITU-T P.862 / P.862.2 wideband), pure numpy.

The port's own copy of `guided_vae_nmf_tpu/metrics/pesq.py`, line for line
below this docstring; `tests/test_torch_metrics.py` holds the two equal bit
for bit. The reference pipeline reports PESQ-wb per utterance through the
`pesq` C-extension wheel (reference scripts/run_metrics_M1.py:19,83); where
the wheel is absent, this module computes the P.862 algorithm from the
standard:

  1. level alignment of both signals to a fixed active-band power,
  2. the P.862.2 wideband input filter (single IIR biquad),
  3. time alignment: envelope cross-correlation (crude) + per-utterance
     weighted delay histograms over windowed cross-correlations (fine),
     with recursive utterance splitting (split_align),
  4. perceptual model: 32 ms half-overlapped Hann frames -> power spectra
     -> Bark-band "pitch power densities" -> partial frequency-response
     compensation of the reference -> smoothed time-varying gain
     compensation of the degraded -> Zwicker loudness,
  5. disturbance densities with center-of-band masking (deadzone),
     asymmetry weighting ((deg+50)/(ref+50))^1.2 gated at 3 and capped
     at 12, band aggregation (weighted L2 symmetric / L1 asymmetric),
     frame weighting by audible power^0.04, bad-interval re-alignment,
  6. L6-over-syllables / L2-over-time aggregation and the P.862.2
     mapping  MOS-LQO = 0.999 + 4/(1 + exp(-1.3669 x + 3.8224)).

The band layout, absolute-threshold curve, loudness scalings, Zwicker
exponent, wideband filter and both output mappings are the standard's
published constants; the FFT-bin -> band assignment is its integer
`nr_of_hz_bands_per_bark_band_16k` table, checked at import. The one known
deviation from the ITU C code is second-order: the per-band power-density
correction factors are computed from band coverage instead of the C code's
precomputed float table of the same quantity (the JAX package's
tests/metrics/test_pesq.py bounds its effect).
"""

import numpy as np

# ---------------------------------------------------------------------------
# constants (ITU-T P.862 Annex A reference implementation values)
# ---------------------------------------------------------------------------

TARGET_AVG_POWER = 1e7
DATAPADDING_MS = 320
SEARCHBUFFER = 75          # in 4 ms envelope blocks, both ends
ZWICKER_POWER = 0.23
ABS_THRESH_POWER_FACTOR = 1e2   # silence criterion factor
N_SYLLABLE_FRAMES = 20     # PSQM frames per "syllable" (split second)
D_WEIGHT = 0.1             # raw = 4.5 - 0.1 D - 0.0309 DA
A_WEIGHT = 0.0309

# P.862.2 wideband input filter (one biquad section per rate)
_WB_IIR_16K = ([2.6657628, -5.3315255, 2.6657628],
               [1.0, -1.8890331, 0.89487434])
_WB_IIR_8K = ([2.740826, -5.4816519, 2.740826],
              [1.0, -1.9444777, 0.94597794])

# Narrowband receive-side IRS characteristic (Hz, gain dB) applied in the
# FFT domain, the standard's telephone-handset weighting for 'nb' mode
_IRS_RECEIVE_DB = np.array([
    (0, -200.0), (50, -40.0), (100, -20.0), (125, -12.0), (160, -6.0),
    (200, 0.0), (250, 4.0), (300, 6.0), (350, 8.0), (400, 10.0),
    (500, 11.0), (600, 12.0), (700, 12.0), (800, 12.0), (1000, 12.0),
    (1300, 12.0), (1600, 12.0), (2000, 12.0), (2500, 12.0), (3000, 12.0),
    (3250, 12.0), (3500, 4.0), (4000, -200.0), (5000, -200.0),
    (6300, -200.0), (8000, -200.0),
])

# Loudness scaling (power / loudness) per rate
_SP = {8000: 2.764344e-5, 16000: 6.910853e-6}
_SL = {8000: 1.866055e-1, 16000: 1.866055e-1}

# The standard's Bark-band centres (P.862 reference code
# `centre_of_band_bark_16k`, 49 bands tiling [0, 21.335656] contiguously;
# the 8 kHz mode uses the first 42 bands, as in the reference code). Band
# widths/edges follow from the tiling identity width[k] = 2*(centre[k] -
# edge[k]) with edge[0] = 0, which this table satisfies by construction
# (first band is half-width: it starts at 0 Bark).
CENTRE_OF_BAND_BARK = np.array([
    0.078672, 0.316341, 0.636559, 0.961246, 1.290450,
    1.624217, 1.962597, 2.305636, 2.653383, 3.005889,
    3.363201, 3.725371, 4.092449, 4.464486, 4.841533,
    5.223642, 5.610866, 6.003256, 6.400869, 6.803755,
    7.211971, 7.625571, 8.044611, 8.469146, 8.899232,
    9.334927, 9.776288, 10.223374, 10.676242, 11.134952,
    11.599563, 12.070135, 12.546731, 13.029408, 13.518232,
    14.013264, 14.514566, 15.022202, 15.536238, 16.056736,
    16.583761, 17.117382, 17.657663, 18.204674, 18.758478,
    19.319147, 19.886751, 20.461355, 21.043034,
])


def _band_layout(nb):
    """(widths, edges, centres) of the first `nb` bands of the standard's
    layout, derived from CENTRE_OF_BAND_BARK by the tiling identity."""
    centres = CENTRE_OF_BAND_BARK[:nb]
    edges = np.empty(nb + 1)
    widths = np.empty(nb)
    edges[0] = 0.0
    for k in range(nb):
        widths[k] = 2.0 * (centres[k] - edges[k])
        edges[k + 1] = edges[k] + widths[k]
    return widths, edges, centres


# Absolute hearing threshold per Bark band, as band power on the internal
# scale (0.1 dB-quantised threshold curve of the standard; the 8 kHz mode
# uses the first 42 entries, matching its 42-band prefix layout).
_ABS_THRESH_DB_16K = np.array([
    77.1, 63.9, 48.5, 36.9, 30.7, 25.9, 20.2, 16.6, 12.5, 9.9,
    6.9, 4.9, 2.8, 1.0, -0.1, -1.4, -2.5, -3.4, -4.1, -4.8,
    -5.3, -5.7, -5.9, -6.0, -6.0, -6.0, -6.0, -5.8, -5.4, -5.1,
    -4.7, -4.3, -4.0, -3.6, -3.3, -3.1, -3.0, -3.0, -2.9, -2.8,
    -2.8, -2.8, -2.9, -3.2, -3.7, -4.3, -4.4, -3.8, -2.7,
])

# The standard's integer FFT-bin -> Bark-band assignment
# (`nr_of_hz_bands_per_bark_band_16k` of the P.862 reference code): entry k
# is the number of consecutive 31.25 Hz rfft bins summed into band k,
# consuming exactly the Nf/2 = 256 bins the reference's short_term_fft
# produces (DC is bin 0, zeroed before warping, so band 0's single bin
# carries no power). Self-consistency checks, asserted at import below:
# the counts sum to 256, and they agree bin-for-bin with the normative
# `z = f/100` scale (100*centre_bark == centre_hz) through the region that
# scale covers (every bin below the 500 Hz break). The 8 kHz mode uses the
# 42-band prefix clipped at its 128-bin spectrum, matching the prefix
# structure the band-centre and threshold tables share across the rates.
NR_OF_HZ_BANDS_PER_BARK_BAND_16K = np.array([
    1, 1, 1, 1, 1, 1, 1, 1, 2, 1,
    1, 1, 1, 1, 2, 1, 1, 2, 2, 2,
    2, 2, 2, 2, 2, 3, 3, 3, 3, 4,
    3, 4, 5, 4, 5, 6, 6, 7, 8, 9,
    9, 12, 12, 15, 16, 18, 21, 25, 20,
], dtype=np.int64)

assert NR_OF_HZ_BANDS_PER_BARK_BAND_16K.sum() == 256
assert NR_OF_HZ_BANDS_PER_BARK_BAND_16K.shape == CENTRE_OF_BAND_BARK.shape


def _check_band_table_consistency():
    """Assert the integer bin-count table agrees with the normative
    `z = f/100` frequency scale wherever that scale applies (every rfft
    bin below the 500 Hz break): the band each bin lands in by cumulative
    count must be the band whose Bark interval (from the published
    centres, tiling identity) contains z = bin_hz*k/100."""
    _, edges, _ = _band_layout(49)
    by_count = np.repeat(np.arange(49), NR_OF_HZ_BANDS_PER_BARK_BAND_16K)
    bin_hz = 16000.0 / 512.0
    for k in range(1, int(500.0 // bin_hz) + 1):
        z = bin_hz * k / 100.0
        by_scale = int(np.searchsorted(edges, z, side="right") - 1)
        assert by_count[k] == by_scale, (k, by_count[k], by_scale)


_check_band_table_consistency()


_WARP_BREAK_HZ = 500.0     # below this the standard's scale is exactly f/100


class _Warp:
    """C1 frequency warp Hz -> band scale, consistent with the published
    band tables: exactly `z = f/100` below 500 Hz (the published tables
    satisfy centre_hz == 100*centre_bark there), continued above by a
    quadratic in log(f/500) with matching value (5) and slope (1/100 Hz)
    at the break, with the quadratic coefficient pinned so z(f_top) equals
    the band layout's top edge."""

    def __init__(self, f_top, z_top):
        self.fb = _WARP_BREAK_HZ
        self.zb = self.fb / 100.0                     # 5 Bark at the break
        self.slope = self.fb / 100.0                  # d z / d ln f at break
        xt = np.log(f_top / self.fb)
        self.c2 = (z_top - self.zb - self.slope * xt) / (xt * xt)

    def __call__(self, f):
        f = np.asarray(f, dtype=np.float64)
        x = np.log(np.maximum(f, 1e-12) / self.fb)
        hi = self.zb + self.slope * x + self.c2 * x * x
        return np.where(f <= self.fb, f / 100.0, hi)

    def inverse(self, z):
        z = np.asarray(z, dtype=np.float64)
        # quadratic c2*x^2 + slope*x + (zb - z) = 0, monotone branch
        disc = np.maximum(
            self.slope ** 2 - 4.0 * self.c2 * (self.zb - z), 0.0)
        x = (-self.slope + np.sqrt(disc)) / (2.0 * self.c2)
        return np.where(z <= self.zb, 100.0 * z, self.fb * np.exp(x))


class _BandTables:
    """Bark-band layout for the perceptual model at one sample rate.

    49 bands at 16 kHz / the 42-band prefix at 8 kHz, using the
    standard's published band centres (CENTRE_OF_BAND_BARK) with widths
    and edges derived by the tiling identity. FFT-bin assignment and
    power-density corrections follow from the `_Warp` frequency scale.
    """

    def __init__(self, fs):
        if fs == 16000:
            nb, nf = 49, 512
        elif fs == 8000:
            nb, nf = 42, 256
        else:
            raise ValueError(f"PESQ supports fs in (8000, 16000), got {fs}")
        self.fs = fs
        self.Nb = nb
        self.Nf = nf                      # analysis frame (32 ms)
        self.n_bins = nf // 2             # usable rfft bins (DC zeroed)
        self.bin_hz = fs / nf
        self.Sp = _SP[fs]
        self.Sl = _SL[fs]

        widths, edges, centres = _band_layout(nb)
        self.width_bark = widths
        self.centre_bark = centres
        self.warp = _Warp(fs / 2.0, edges[-1])

        # FFT bin -> band assignment: the standard's integer bin-count
        # table. At 16 kHz it is used verbatim; at 8 kHz its 42-band prefix
        # is clipped to the 128-bin spectrum (the final band keeps whatever
        # bins remain below Nyquist). Bin 0 (DC) is zeroed by the framing
        # code, so only bins 1..n_bins-1 are assigned here.
        counts = NR_OF_HZ_BANDS_PER_BARK_BAND_16K[:nb].copy()
        counts[-1] -= max(0, int(counts.sum()) - self.n_bins)
        self.band_of_bin = np.repeat(np.arange(nb), counts)[1:]
        self.nr_bins = np.bincount(self.band_of_bin, minlength=nb)

        # Power-density correction: nominal band Hz width over the Hz width
        # actually covered by its integer bins (x100, the scale Sp was
        # calibrated with).
        hz_edges = self.warp.inverse(edges)
        nominal_hz = np.diff(hz_edges)
        covered_hz = self.nr_bins * self.bin_hz
        with np.errstate(divide="ignore", invalid="ignore"):
            corr = np.where(
                self.nr_bins > 0, nominal_hz / np.maximum(covered_hz, 1e-12),
                1.0,
            )
        self.pow_dens_correction = 100.0 * np.clip(corr, 0.25, 4.0)

        # 8 kHz mode: first 42 entries of the 16 kHz threshold curve — the
        # 8 kHz layout is the 42-band prefix, so the thresholds are exact.
        thresh_db = _ABS_THRESH_DB_16K[:nb]
        self.abs_thresh_power = 10.0 ** (np.asarray(thresh_db) / 10.0)

        self.window = 0.5 * (1.0 - np.cos(
            2.0 * np.pi * np.arange(nf) / nf))

        # time alignment constants
        self.downsample = fs // 250       # 4 ms envelope blocks
        self.align_nfft = 1024 if fs == 16000 else 512


_TABLE_CACHE = {}


def _tables(fs):
    if fs not in _TABLE_CACHE:
        _TABLE_CACHE[fs] = _BandTables(fs)
    return _TABLE_CACHE[fs]


# ---------------------------------------------------------------------------
# preprocessing
# ---------------------------------------------------------------------------

def _iir_biquad(x, ba):
    b, a = ba
    # direct form I, vectorised via scipy when available
    try:
        from scipy.signal import lfilter
        return lfilter(b, a, x)
    except ImportError:  # pragma: no cover
        y = np.zeros_like(x)
        x1 = x2 = y1 = y2 = 0.0
        for i, xi in enumerate(x):
            yi = (b[0] * xi + b[1] * x1 + b[2] * x2
                  - a[1] * y1 - a[2] * y2)
            x2, x1 = x1, xi
            y2, y1 = y1, yi
            y[i] = yi
        return y


def _bandpass_power(x, fs, lo=350.0, hi=3250.0):
    """Mean-square of x restricted to [lo, hi] Hz (FFT brick-wall), the
    active-speech band the standard normalises levels on."""
    n = len(x)
    spec = np.fft.rfft(x)
    f = np.fft.rfftfreq(n, 1.0 / fs)
    spec[(f < lo) | (f > hi)] = 0.0
    xf = np.fft.irfft(spec, n)
    return float(np.mean(xf ** 2))


def _fix_power_level(x, fs):
    p = _bandpass_power(x, fs)
    if p <= 0.0:
        return x.astype(np.float64)
    return x.astype(np.float64) * np.sqrt(TARGET_AVG_POWER / p)


def _irs_receive_filter(x, fs):
    """Apply the IRS receive weighting in the FFT domain (gain curve
    interpolated linearly in dB over frequency) — the 'nb' input filter."""
    n = len(x)
    spec = np.fft.rfft(x)
    f = np.fft.rfftfreq(n, 1.0 / fs)
    gain_db = np.interp(f, _IRS_RECEIVE_DB[:, 0], _IRS_RECEIVE_DB[:, 1])
    spec *= 10.0 ** (gain_db / 20.0)
    return np.fft.irfft(spec, n)


# ---------------------------------------------------------------------------
# time alignment
# ---------------------------------------------------------------------------

def _envelope_blocks(x, downsample):
    n = len(x) // downsample
    return np.mean(
        x[: n * downsample].reshape(n, downsample) ** 2, axis=1)


def _vad(power):
    """Active-block flags from envelope powers (threshold at a fraction of
    the mean active level, iterated to a fixpoint like the standard's
    apply_VAD)."""
    p = power.copy()
    thr = np.mean(p) if np.mean(p) > 0 else 1.0
    for _ in range(12):
        act = p > thr
        if not np.any(act) or np.all(act):
            break
        new = 0.5 * np.sqrt(np.mean(p[act]) *
                            max(np.mean(p[~act]), 1e-10 * np.mean(p[act])))
        if abs(new - thr) < 1e-12:
            break
        thr = new
    active = p > thr
    # close gaps < 50 blocks (200 ms) like the utterance-joining rule
    idx = np.flatnonzero(active)
    if idx.size:
        for a, b in zip(idx[:-1], idx[1:]):
            if 0 < b - a <= 50:
                active[a:b] = True
    return active, thr


def _log_envelopes(ref, deg, downsample):
    """Thresholded log envelopes of both signals + the reference's active
    flags (the standard's crude-alignment feature domain)."""
    pr = _envelope_blocks(ref, downsample)
    pd = _envelope_blocks(deg, downsample)
    ar, tr = _vad(pr)
    ad, td = _vad(pd)
    lr = np.where(ar, np.log10(np.maximum(pr, 1e-10)) -
                  np.log10(max(tr, 1e-10)), 0.0)
    ld = np.where(ad, np.log10(np.maximum(pd, 1e-10)) -
                  np.log10(max(td, 1e-10)), 0.0)
    return lr, ld, ar


def _envelope_xcorr_delay(lr, ld, center=None, radius=None):
    """Block-domain delay of ld relative to lr via FFT cross-correlation.
    With (center, radius) the search is restricted to lags within
    `radius` blocks of `center` — the standard bounds per-utterance
    delay search to the SEARCHBUFFER around the file-global estimate,
    which also disambiguates periodic envelopes."""
    n = 1 << int(np.ceil(np.log2(len(lr) + len(ld))))
    X = np.fft.rfft(lr, n)
    Y = np.fft.rfft(ld, n)
    corr = np.fft.irfft(np.conj(X) * Y, n)
    lags = np.concatenate([np.arange(0, n // 2), np.arange(-n // 2, 0)])
    if center is not None:
        corr = np.where(np.abs(lags - center) <= radius, corr, -np.inf)
    return int(lags[int(np.argmax(corr))])


def _crude_align(ref, deg, downsample):
    """Global delay (samples, deg relative to ref) from log-envelope
    cross-correlation."""
    lr, ld, ar = _log_envelopes(ref, deg, downsample)
    return _envelope_xcorr_delay(lr, ld) * downsample, ar


def _crude_subalign(lr, ld, b0, b1, downsample, global_crude_blocks):
    """Per-utterance crude delay (the standard's crude_subalign): the
    utterance's log-envelope blocks, zero-embedded at their true
    position, correlated against the WHOLE degraded envelope — so each
    utterance gets its own initial delay estimate rather than the
    file-global one. The search is bounded to the global estimate ±
    SEARCHBUFFER blocks (the standard's search-buffer design)."""
    seg = np.zeros_like(lr)
    seg[b0:b1] = lr[b0:b1]
    return _envelope_xcorr_delay(
        seg, ld, center=global_crude_blocks, radius=SEARCHBUFFER
    ) * downsample


def _utterances(active, min_len=13):
    """[(start_block, end_block)] of active speech runs (min ~50 ms)."""
    runs = []
    i = 0
    n = len(active)
    while i < n:
        if active[i]:
            j = i
            while j < n and active[j]:
                j += 1
            if j - i >= min_len:
                runs.append((i, j))
            i = j
        else:
            i += 1
    if not runs:
        runs = [(0, n)]
    return runs


def _window_votes(ref, deg, start, stop, crude_delay, align_nfft):
    """One vectorized pass over the 75%-overlap alignment windows of
    ref[start:stop] vs deg shifted by crude_delay: per-window correlation
    peak position and compressed weight (the standard's per-window delay
    votes). Computed ONCE per utterance and shared by the whole-utterance
    fine alignment AND every split_align candidate — the split search
    just re-histograms subsets of these votes."""
    window = 0.5 * (1.0 - np.cos(
        2.0 * np.pi * np.arange(align_nfft) / align_nfft))
    hop = align_nfft // 4
    n_deg = len(deg)
    last = max(stop - align_nfft, start)
    starts = np.arange(start, last + 1, hop)
    starts = starts[starts + align_nfft <= len(ref)]
    sd = starts + crude_delay
    starts = starts[(sd >= 0) & (sd + align_nfft <= n_deg)]
    if starts.size == 0:
        return starts, starts.astype(np.int64), np.zeros(0)
    fr = np.lib.stride_tricks.sliding_window_view(
        ref, align_nfft)[starts] * window
    fd = np.lib.stride_tricks.sliding_window_view(
        deg, align_nfft)[starts + crude_delay] * window
    X = np.fft.rfft(fr, 2 * align_nfft, axis=1)
    Y = np.fft.rfft(fd, 2 * align_nfft, axis=1)
    corr = np.abs(np.fft.irfft(np.conj(X) * Y, 2 * align_nfft, axis=1))
    peaks = corr.max(axis=1)
    ks = corr.argmax(axis=1).astype(np.int64)
    keep = peaks > 0.0
    return starts[keep], ks[keep], peaks[keep] ** 0.125


def _hist_peak(ks, ws, align_nfft):
    """(lag, confidence) of the triangular-smoothed weighted delay
    histogram over the given votes; None when there are no votes."""
    if ks.size == 0:
        return None
    hist = np.zeros(2 * align_nfft)
    width = 3
    for d in range(-width, width + 1):
        np.add.at(hist, (ks + d) % (2 * align_nfft),
                  ws * (1 - abs(d) / (width + 1)))
    total = hist.sum()
    if total <= 0.0:
        return None
    k = int(np.argmax(hist))
    lag = k if k < align_nfft else k - 2 * align_nfft
    return lag, float(hist[k] / total)


def _fine_align(ref, deg, start, stop, crude_delay, align_nfft):
    """Delay refinement for ref[start:stop] against deg shifted by
    crude_delay: weighted histogram of windowed cross-correlation peaks."""
    _, ks, ws = _window_votes(ref, deg, start, stop, crude_delay,
                              align_nfft)
    hp = _hist_peak(ks, ws, align_nfft)
    if hp is None:
        return crude_delay, 0.0
    lag, conf = hp
    return crude_delay + lag, conf


def _grouped_vote_hists(ks, ws, align_nfft, stride):
    """(n_groups, 2*align_nfft) triangular-smoothed histograms of
    consecutive `stride`-sized vote groups — prefix sums of the group
    rows give every "first j groups" histogram at once, which is what
    the exhaustive split-point scan consumes. Built by scatter-add so
    no per-vote matrix is ever materialized (long utterances stay
    O(n_groups * hist) memory)."""
    n = ks.size
    gi = np.arange(n) // stride
    rows = np.zeros((int(gi[-1]) + 1, 2 * align_nfft))
    width = 3
    for d in range(-width, width + 1):
        np.add.at(rows, (gi, (ks + d) % (2 * align_nfft)),
                  ws * (1 - abs(d) / (width + 1)))
    return rows


def _split_align(ref, deg, s0, s1, crude, align_nfft, depth=3):
    """P.862 utterance splitting (the standard's split_align design): an
    utterance whose delay CHANGES mid-way spreads its fine-alignment
    histogram over two peaks; splitting it concentrates each half's
    mass. The per-window votes are computed once; the split search then
    scans EVERY vote-window boundary (the C code's exhaustive scan, not
    a candidate-fraction shortlist): prefix sums of the per-vote
    smoothed-histogram rows give all left-half histograms in one pass
    and the right halves by subtraction from the total. A split is
    accepted when BOTH halves align with higher confidence than the
    whole (each boundary judged by its own confidence comparison), the
    winner being the boundary with the largest min-half confidence.
    Returns [(start, stop, delay)] covering [s0, s1)."""
    starts, ks, ws = _window_votes(ref, deg, s0, s1, crude, align_nfft)

    def seg_delay(sel):
        hp = _hist_peak(ks[sel], ws[sel], align_nfft)
        if hp is None:
            return crude, 0.0
        lag, conf = hp
        return crude + lag, conf

    def rec(a, b, depth):
        inside = (starts >= a) & (starts + align_nfft <= b)
        d, conf = seg_delay(inside)
        n_in = int(inside.sum())
        if depth <= 0 or n_in < 8:
            return [(a, b, d)]
        st_in = starts[inside]
        # bound memory on very long utterances by grouping votes into a
        # strided candidate grid (<=2048 boundaries; stride 1 — every
        # single window boundary — for any utterance under ~2 min)
        stride = max(1, -(-n_in // 2048))
        rows = _grouped_vote_hists(ks[inside], ws[inside], align_nfft,
                                   stride)
        n_g = rows.shape[0]
        if n_g < 2:
            return [(a, b, d)]
        prefix = np.cumsum(rows, axis=0)        # prefix[i] = groups [0..i]
        total = prefix[-1]
        gcand = np.arange(1, n_g)               # split BEFORE group i
        vcand = gcand * stride                  # first vote of right half
        # >=4 votes per half (the minimum the fine histogram needs)
        keepc = (vcand >= 4) & (vcand <= n_in - 4)
        gcand, vcand = gcand[keepc], vcand[keepc]
        if gcand.size == 0:
            return [(a, b, d)]
        left = prefix[gcand - 1]
        right = total - left
        suml, sumr = left.sum(axis=1), right.sum(axis=1)
        with np.errstate(divide="ignore", invalid="ignore"):
            c1 = np.where(suml > 0, left.max(axis=1) / suml, 0.0)
            c2 = np.where(sumr > 0, right.max(axis=1) / sumr, 0.0)
        cmin = np.minimum(c1, c2)
        ok = cmin > conf
        if not ok.any():
            return [(a, b, d)]
        j = vcand[np.argmax(np.where(ok, cmin, -np.inf))]
        m = int(st_in[j])                       # first window of the right half
        return rec(a, m, depth - 1) + rec(m, b, depth - 1)

    return rec(s0, s1, depth)


def _align(ref, deg, fs):
    """Per-sample delay map: per-utterance crude + fine alignment with
    recursive utterance splitting (the standard's utterance_locate /
    crude_subalign / time_subalign / split_align chain), so delay that
    varies across and WITHIN utterances is tracked."""
    t = _tables(fs)
    lr, ld, active = _log_envelopes(ref, deg, t.downsample)
    gc_blocks = _envelope_xcorr_delay(lr, ld)
    global_crude = gc_blocks * t.downsample
    utts = _utterances(active)
    delays = np.full(len(ref), global_crude, dtype=np.int64)
    for (b0, b1) in utts:
        s0, s1 = b0 * t.downsample, b1 * t.downsample
        crude = _crude_subalign(lr, ld, b0, b1, t.downsample, gc_blocks)
        segs = _split_align(ref, deg, s0, min(s1, len(ref)), crude,
                            t.align_nfft)
        for (a, b, d) in segs:
            delays[a:b] = d
    return delays


# ---------------------------------------------------------------------------
# perceptual model
# ---------------------------------------------------------------------------

def _frame_powspec(x, start, t):
    fr = x[start: start + t.Nf]
    if len(fr) < t.Nf:
        fr = np.pad(fr, (0, t.Nf - len(fr)))
    spec = np.fft.rfft(fr * t.window)
    # power spectrum normalised by Nf: puts band powers on the scale the
    # standard's absolute constants (abs thresholds, +1000 freq-comp and
    # +5e3 gain-comp regularisers, 1e7 silence criterion) are defined on
    p = (spec.real ** 2 + spec.imag ** 2)[: t.n_bins] / t.Nf
    p[0] = 0.0
    return p


def _to_bark(powspec, t):
    sums = np.zeros(t.Nb)
    np.add.at(sums, t.band_of_bin, powspec[1:])
    return sums * t.pow_dens_correction * t.Sp


def _total_audible(bark_frame, t, factor=1.0):
    aud = bark_frame[1:] > t.abs_thresh_power[1:] * factor
    return float(np.sum(bark_frame[1:][aud]))


def _loudness(bark, t):
    """Zwicker intensity -> loudness warping, per frame x band."""
    thresh = t.abs_thresh_power[None, :]
    c = t.centre_bark
    h = np.where(c < 4.0, np.minimum(6.0 / (c + 2.0), 2.0), 1.0)
    zw = ZWICKER_POWER * h ** 0.15
    zw = zw[None, :]
    ratio = 0.5 + 0.5 * bark / thresh
    loud = t.Sl * (thresh / 0.5) ** zw * (ratio ** zw - 1.0)
    return np.where(bark > thresh, loud, 0.0)


def _pseudo_lp(d, width, p):
    """Band aggregation of a disturbance frame (weighted p-norm of the
    width-scaled densities, rescaled by total width)."""
    w = width[1:]
    h = np.abs(d[:, 1:]) * w[None, :]
    tot = np.sum(w)
    return (np.sum(h ** p, axis=1) / tot) ** (1.0 / p) * tot


def _lpq_weight(frame_d, weights, p_syll=6.0, p_time=2.0,
                n_syll=N_SYLLABLE_FRAMES):
    """L_{p_syll} within half-overlapped ~syllable groups of frames, then
    L_{p_time} across groups, frame-weighted."""
    n = len(frame_d)
    num_t, den_t = 0.0, 0.0
    for start in range(0, n, n_syll // 2):
        sl = slice(start, min(start + n_syll, n))
        w = weights[sl]
        if np.sum(w) <= 0:
            continue
        syll = (np.sum(w * frame_d[sl] ** p_syll) /
                np.sum(w)) ** (1.0 / p_syll)
        wt = np.sum(w)
        num_t += wt * syll ** p_time
        den_t += wt
    if den_t <= 0:
        return 0.0
    return float((num_t / den_t) ** (1.0 / p_time))


def _perceptual_model(ref, deg, delays, fs):
    t = _tables(fs)
    hop = t.Nf // 2
    n = len(ref)
    n_frames = max((n - t.Nf) // hop + 1, 1)

    bark_ref = np.zeros((n_frames, t.Nb))
    bark_deg = np.zeros((n_frames, t.Nb))
    for i in range(n_frames):
        s = i * hop
        bark_ref[i] = _to_bark(_frame_powspec(ref, s, t), t)
        d = int(delays[min(s, n - 1)])
        bark_deg[i] = _to_bark(_frame_powspec(deg, s + d, t), t)

    tot_ref = np.array([_total_audible(b, t, 1.0) for b in bark_ref])
    tot_deg = np.array([_total_audible(b, t, 1.0) for b in bark_deg])
    silent = np.array([
        _total_audible(b, t, ABS_THRESH_POWER_FACTOR) < TARGET_AVG_POWER
        for b in bark_ref
    ])

    # partial frequency-response compensation: scale the reference bands by
    # the average deg/ref band ratio over loud frames
    loud = ~silent
    if np.any(loud):
        avg_ref = np.mean(bark_ref[loud], axis=0)
        avg_deg = np.mean(bark_deg[loud], axis=0)
    else:
        avg_ref = np.mean(bark_ref, axis=0)
        avg_deg = np.mean(bark_deg, axis=0)
    fcomp = np.clip((avg_deg + 1000.0) / (avg_ref + 1000.0), 0.01, 100.0)
    bark_ref_c = bark_ref * fcomp[None, :]

    # smoothed time-varying gain compensation of the degraded
    gains = np.empty(n_frames)
    h_prev = 1.0
    tot_ref_c = np.array([_total_audible(b, t, 1.0) for b in bark_ref_c])
    for i in range(n_frames):
        g = (tot_ref_c[i] + 5e3) / (tot_deg[i] + 5e3)
        h_prev = g if i == 0 else 0.2 * h_prev + 0.8 * g
        gains[i] = np.clip(h_prev, 3e-4, 5.0)
    bark_deg_c = bark_deg * gains[:, None]

    loud_ref = _loudness(bark_ref_c, t)
    loud_deg = _loudness(bark_deg_c, t)

    # disturbance with center-of-band masking deadzone
    d = loud_deg - loud_ref
    m = 0.25 * np.minimum(loud_deg, loud_ref)
    disturbance = np.where(d > m, d - m, np.where(d < -m, d + m, 0.0))

    # asymmetry: additive distortions weigh more than omissions
    ratio = ((bark_deg_c + 50.0) / (bark_ref_c + 50.0)) ** 1.2
    asym = np.where(ratio < 3.0, 0.0, np.minimum(ratio, 12.0))
    disturbance_a = disturbance * asym

    d_frame = _pseudo_lp(disturbance, t.width_bark, 2.0)
    da_frame = _pseudo_lp(disturbance_a, t.width_bark, 1.0)

    # frame weighting by audible reference power
    hweight = ((tot_ref_c + 1e5) / 1e7) ** 0.04
    d_frame = np.minimum(d_frame / hweight, 45.0)
    da_frame = np.minimum(da_frame / hweight, 45.0)

    # bad-interval re-alignment: runs of frames with large symmetric
    # disturbance get a local delay re-search; keep the better result
    BAD = 30.0
    bad = d_frame > BAD
    i = 0
    while i < n_frames:
        if bad[i]:
            j = i
            while j < n_frames and bad[j]:
                j += 1
            if j - i >= 2:
                best = d_frame[i:j].copy()
                best_a = da_frame[i:j].copy()
                for shift in range(-hop, hop + 1, hop // 8):
                    for k in range(i, j):
                        s = k * hop
                        dly = int(delays[min(s, n - 1)]) + shift
                        bd = _to_bark(_frame_powspec(deg, s + dly, t), t)
                        bd = bd * gains[k]
                        ld = _loudness(bd[None, :], t)
                        dd = ld - loud_ref[k: k + 1]
                        mm = 0.25 * np.minimum(ld, loud_ref[k: k + 1])
                        dd = np.where(dd > mm, dd - mm,
                                      np.where(dd < -mm, dd + mm, 0.0))
                        rr = ((bd[None, :] + 50.0) /
                              (bark_ref_c[k: k + 1] + 50.0)) ** 1.2
                        aa = np.where(rr < 3.0, 0.0, np.minimum(rr, 12.0))
                        df = min(_pseudo_lp(dd, t.width_bark, 2.0)[0]
                                 / hweight[k], 45.0)
                        if df < best[k - i]:
                            best[k - i] = df
                            best_a[k - i] = min(
                                _pseudo_lp(dd * aa, t.width_bark, 1.0)[0]
                                / hweight[k], 45.0)
                d_frame[i:j] = best
                da_frame[i:j] = best_a
            i = j
        else:
            i += 1

    weights = np.ones(n_frames)
    d_ind = _lpq_weight(d_frame, weights)
    da_ind = _lpq_weight(da_frame, weights)
    return d_ind, da_ind


# ---------------------------------------------------------------------------
# public API
# ---------------------------------------------------------------------------

def pesq(fs, ref, deg, mode="wb"):
    """MOS-LQO of `deg` against clean `ref` (both 1-D float arrays at
    `fs` in {8000, 16000}).

    mode='wb': P.862.2 wideband (the reference protocol's only mode,
    reference run_metrics_M1.py:83) — wb input biquad + P.862.2 mapping.
    mode='nb': P.862 narrowband — IRS receive weighting + the P.862.1
    MOS-LQO mapping."""
    if mode not in ("wb", "nb"):
        raise ValueError(f"mode must be 'wb' or 'nb', got {mode!r}")
    ref = np.asarray(ref, dtype=np.float64).ravel()
    deg = np.asarray(deg, dtype=np.float64).ravel()
    if len(ref) < fs // 4 or len(deg) < fs // 4:
        raise ValueError("signals too short for PESQ (< 250 ms)")

    t = _tables(fs)
    pad = DATAPADDING_MS * fs // 1000
    guard = SEARCHBUFFER * t.downsample
    ref = np.concatenate([np.zeros(guard), ref, np.zeros(guard + pad)])
    deg = np.concatenate([np.zeros(guard), deg, np.zeros(guard + pad)])

    ref = _fix_power_level(ref, fs)
    deg = _fix_power_level(deg, fs)

    if mode == "wb":
        ba = _WB_IIR_16K if fs == 16000 else _WB_IIR_8K
        ref = _iir_biquad(ref, ba)
        deg = _iir_biquad(deg, ba)
    else:
        ref = _irs_receive_filter(ref, fs)
        deg = _irs_receive_filter(deg, fs)

    delays = _align(ref, deg, fs)
    d_ind, da_ind = _perceptual_model(ref, deg, delays, fs)

    raw = 4.5 - D_WEIGHT * d_ind - A_WEIGHT * da_ind
    raw = float(np.clip(raw, -0.5, 4.5))
    return mos_lqo_wb(raw) if mode == "wb" else mos_lqo_nb(raw)


def mos_lqo_wb(raw):
    """P.862.2 output mapping (raw P.862 score -> wideband MOS-LQO)."""
    return float(0.999 + 4.0 / (1.0 + np.exp(-1.3669 * raw + 3.8224)))


def mos_lqo_nb(raw):
    """P.862.1 output mapping (narrowband MOS-LQO), for completeness."""
    return float(0.999 + 4.0 / (1.0 + np.exp(-1.4945 * raw + 4.6607)))
