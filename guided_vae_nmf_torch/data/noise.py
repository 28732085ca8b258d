"""Noise databases (QUT test noise, DEMAND train/validation noise) and
SNR mixing.

Capability parity with reference python/dataset/qut_database.py:20-127 and
demand_database.py:21-129: fixed noise-type -> recording mappings,
preprocessing (first channel, resample to 16 kHz, trim the QUT car
recording), random segment extraction matched to the speech length, and the
reference's SNR gain convention k = P_s * 10^(-SNR/10) / P_n with
mixture = s + sqrt(k) * n (reference scripts/create_noisy_train_set.py:237-244).

Resampling uses polyphase filtering (scipy) instead of librosa.

The port's own copy of `guided_vae_nmf_tpu/data/noise.py` (numpy and
scipy); the CLI reads every input through :func:`preprocess_noise`.
"""

import os

import numpy as np
from scipy.signal import resample_poly

from .wav import read_wav, write_wav

FS = 16000

# QUT test-noise recordings (reference qut_database.py:46-51)
QUT_RECORDINGS = {
    "cafe": "CAFE-CAFE-1",
    "car": "CAR-WINDOWNB-1",
    "home": "HOME-KITCHEN-1",
    "street": "STREET-CITY-1",
}

# DEMAND noise types per split (reference demand_database.py:39-54)
DEMAND_RECORDINGS = {
    "train": {
        "domestic": "DWASHING",
        "nature": "NRIVER",
        "office": "OOFFICE",
        "transportation": "TMETRO",
    },
    "validation": {
        "nature": "NFIELD",
        "office": "OHALLWAY",
        "public": "PSTATION",
        "transportation": "TBUS",
    },
}

# QUT car recording: keep 1.5 min .. 43 min (reference qut_database.py:73-82)
QUT_CAR_TRIM_SEC = (90.0, 2580.0)


def qut_noise_list(input_noise_dir):
    """{noise_type: wav path} for the QUT test noises (reference
    qut_database.py:20-61)."""
    return {
        t: os.path.join(input_noise_dir, "QUT-NOISE", "QUT-NOISE",
                        rec + ".wav")
        for t, rec in QUT_RECORDINGS.items()
    }


def demand_noise_list(input_noise_dir, dataset_type="train"):
    """{noise_type: [channel wav paths]} for DEMAND (reference
    demand_database.py:21-70). Each recording is a directory of 16 channel
    wavs; only ch01 is used."""
    recs = DEMAND_RECORDINGS[dataset_type]
    return {
        t: [os.path.join(input_noise_dir, rec, "ch01.wav")]
        for t, rec in recs.items()
    }


def preprocess_noise(noise_audio, fs_noise, noise_type=None, fs=FS):
    """First channel, resample to `fs`, trim the QUT car recording to its
    usable span (reference qut_database.py:63-82)."""
    x = np.asarray(noise_audio)
    if x.ndim > 1:
        x = x[:, 0]
    if fs_noise != fs:
        g = np.gcd(int(fs), int(fs_noise))
        x = resample_poly(x, int(fs) // g, int(fs_noise) // g)
    if noise_type == "car":
        lo, hi = QUT_CAR_TRIM_SEC
        x = x[int(lo * fs): int(hi * fs)]
    return x


def noise_segment(noise_audios, noise_type, speech):
    """Random window of the preprocessed noise matching the speech length
    (reference qut_database.py:115-127). Uses the global numpy RNG to honor
    the reference's seeded-synthesis convention (SURVEY §2.8)."""
    start = noise_start(noise_audios, noise_type, len(speech))
    return noise_audios[noise_type][start: start + len(speech)]


def noise_start(noise_audios, noise_type, n):
    """The start of :func:`noise_segment`'s window for `n` speech samples:
    one draw from the global numpy RNG, the same call in the same order as
    :func:`noise_segment` makes."""
    noise = noise_audios[noise_type]
    if len(noise) < n:
        raise ValueError(f"noise recording shorter than speech: {noise_type}")
    return np.random.randint(len(noise) - n + 1)


def noise_list_preprocessed(output_noise_dir, dataset_type=None,
                            noise_types=None):
    """Load previously preprocessed (concatenated/resampled) per-type noise
    wavs (reference demand_database.py:117-129, qut_database.py:85-113)."""
    split_dir = {"train": "si_tr_s", "validation": "si_dt_05",
                 "test": "si_et_05"}.get(dataset_type, "")
    out = {}
    for t in noise_types:
        path = os.path.join(output_noise_dir, split_dir, t + ".wav")
        x, fs = read_wav(path)
        if fs != FS:
            raise ValueError("preprocessed noise must be 16 kHz")
        out[t] = x
    return out


def write_preprocessed_noise(output_noise_dir, dataset_type, noise_type,
                             audio):
    split_dir = {"train": "si_tr_s", "validation": "si_dt_05",
                 "test": "si_et_05"}[dataset_type]
    path = os.path.join(output_noise_dir, split_dir, noise_type + ".wav")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    write_wav(path, audio, FS)
    return path


def synthetic_noise_bank(clean_streams=None, seed=11, duration_sec=60,
                         fs=FS, rich=False):
    """Six-family synthetic noise bank for training when the DEMAND/QUT
    corpora are unavailable: white, three AR(1)-colored spectra, an
    amplitude-modulated colored noise (nonstationary), and — when clean
    speech is supplied — a 6-talker babble built by overlap-summing random
    stretches of the given utterances. Peak-normalized 60 s recordings,
    deterministic under `seed`. `rich=True` adds four more families
    (car/clatter/tonal/cafe, `_rich_noise_families`) without changing the
    base six, so the shipped bank stays reproducible.

    This bank is what the shipped pretrained checkpoints were trained with
    (scripts/pretrain_subset.py); diversity here is what makes the
    small-data models transfer to real noise (VALIDATION.md).
    """
    from scipy.signal import lfilter

    r = np.random.RandomState(seed)
    n_samp = int(duration_sec * fs)
    bank = {}
    white = r.randn(n_samp)
    bank["white"] = white / np.abs(white).max()
    for name, a in [("low", 0.9), ("mid", 0.6), ("brown", 0.98)]:
        n = lfilter([1], [1, -a], r.randn(n_samp))
        bank[name] = n / np.abs(n).max()
    n = lfilter([1], [1, -0.8], r.randn(n_samp))
    t = np.arange(n_samp) / fs
    env = 0.4 + 0.6 * np.abs(
        np.sin(2 * np.pi * 1.3 * t) * np.sin(2 * np.pi * 0.31 * t + 1)
    )
    bank["mod"] = (n * env) / np.abs(n * env).max()
    if clean_streams:
        bab = np.zeros(n_samp)
        for _ in range(6):
            stream = np.concatenate(
                [clean_streams[r.randint(len(clean_streams))]
                 for _ in range(40)]
            )
            off = (r.randint(len(stream) - n_samp)
                   if len(stream) > n_samp else 0)
            seg = stream[off: off + n_samp]
            bab[: len(seg)] += seg
        bank["babble"] = bab / np.abs(bab).max()
    if rich:
        bank.update(_rich_noise_families(r, n_samp, fs, clean_streams))
    return bank


def _rich_noise_families(r, n_samp, fs, clean_streams=None):
    """Additional families targeting the real-noise failure modes
    (VALIDATION.md, real-QUT table): car-cabin rumble (strong
    resonant low-frequency energy like QUT CAR-WINDOWNB), impulsive
    clatter (kitchen/cafe transients), narrowband drifting tonal noise
    (machinery), and a cafe composite (babble + clatter + colored floor).
    """
    from scipy.signal import lfilter

    t = np.arange(n_samp) / fs
    bank = {}
    # car: AR(2) resonance ~45 Hz over brown rumble + slow gusting
    rho, f0 = 0.997, 45.0
    a = [1.0, -2 * rho * np.cos(2 * np.pi * f0 / fs), rho * rho]
    car = lfilter([1.0], a, r.randn(n_samp))
    car += 0.4 * lfilter([1.0], [1.0, -0.995], r.randn(n_samp))
    car *= 0.7 + 0.3 * np.abs(np.sin(2 * np.pi * 0.13 * t + 0.7))
    bank["car"] = car / np.abs(car).max()
    # clatter: sparse impulses convolved with a decaying ring + floor
    imp = np.zeros(n_samp)
    n_hits = max(1, int(n_samp / fs * 3.0))
    pos = r.randint(0, n_samp, n_hits)
    imp[pos] = r.randn(n_hits) * (1.0 + r.rand(n_hits) * 3.0)
    ring_t = np.arange(int(0.05 * fs))
    ring = np.exp(-ring_t / (0.008 * fs)) * np.cos(
        2 * np.pi * (1200 + 800 * r.rand()) * ring_t / fs)
    clat = np.convolve(imp, ring)[:n_samp]
    clat += 0.05 * lfilter([1.0], [1.0, -0.6], r.randn(n_samp))
    bank["clatter"] = clat / np.abs(clat).max()
    # tonal: narrowband noise whose centre drifts (machinery whine)
    fc = 300.0 + 500.0 * (1 + np.sin(2 * np.pi * 0.05 * t)) / 2
    phase = 2 * np.pi * np.cumsum(fc) / fs
    ton = np.cos(phase) * lfilter(
        [1.0], [1.0, -0.9], r.randn(n_samp)) * 0.5
    ton += 0.1 * r.randn(n_samp)
    bank["tonal"] = ton / np.abs(ton).max()
    if clean_streams:
        # cafe composite: babble bed + clatter + mid-colored floor
        bab = np.zeros(n_samp)
        for _ in range(8):
            stream = np.concatenate(
                [clean_streams[r.randint(len(clean_streams))]
                 for _ in range(40)]
            )
            off = (r.randint(len(stream) - n_samp)
                   if len(stream) > n_samp else 0)
            seg = stream[off: off + n_samp]
            bab[: len(seg)] += seg
        cafe = bab / np.abs(bab).max()
        cafe = cafe + 0.35 * bank["clatter"] + 0.15 * lfilter(
            [1.0], [1.0, -0.7], r.randn(n_samp)) / 3.0
        bank["cafe"] = cafe / np.abs(cafe).max()
    return bank


def snr_gain(speech, noise, snr_db):
    """k such that mixing s + sqrt(k)*n realizes `snr_db` (reference
    create_noisy_train_set.py:237-242)."""
    speech_power = np.sum(speech**2)
    noise_power = np.sum(noise**2)
    return speech_power * 10 ** (-snr_db / 10.0) / noise_power


def mix_at_snr(speech, noise, snr_db):
    """Return (mixture, scaled_noise) at the requested SNR."""
    k = snr_gain(speech, noise, snr_db)
    scaled = np.sqrt(k) * noise
    return speech + scaled, scaled
