"""Dataset synthesis: clean/noisy training frame stores and test mixtures.

Capability parity with the reference's creation scripts:
  * :func:`create_clean_frames` — scripts/create_train_set.py:92-156
  * :func:`create_noisy_frames` — scripts/create_noisy_train_set.py:155-331
  * :func:`create_test_mixtures` — scripts/create_test_set.py:60-178

All conventions are preserved: 0.1 s burst cut, peak normalization, seeded
noise-type/SNR draws (np.random.seed(0)), the k = P_s*10^(-SNR/10)/P_n gain,
the test set's joint max-normalization of (s, n, x), the `<utt>_{s,n,x}.wav`
naming, the pickled `snr_db` list, and the H5 schema with train mean/std.
Work is IO-bound host code; the mixing loop fans out over a thread pool like
the reference (create_test_set.py:165-166).

The port's own copy of `guided_vae_nmf_tpu/data/synthesis.py`, over the
port's host `dsp.stft` / `istft` and `dsp.targets`; it keeps the seeded
global `np.random` draws, so a store built by either package is the same.
"""

import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from .wav import read_wav, write_wav
from .file_lists import speech_list, write_dataset
from .h5io import H5FrameWriter
from .noise import noise_segment, noise_start
from ..dsp import (
    stft,
    clean_speech_IBM,
    clean_speech_VAD,
    ideal_wiener_mask,
)

FS = 16000


def speed_perturb(x, factor):
    """Kaldi-style speed perturbation: resample by 1/factor so the
    utterance plays `factor`x faster — shifts both tempo and pitch,
    the standard small-corpus augmentation. Rational-factor polyphase
    resampling; factor 1.0 returns the input."""
    if factor == 1.0:
        return np.asarray(x, np.float64)
    from fractions import Fraction

    from scipy.signal import resample_poly

    fr = Fraction(factor).limit_denominator(100)
    return resample_poly(np.asarray(x, np.float64),
                         fr.denominator, fr.numerator)


def pv_stretch(x, rate, fs=FS):
    """Phase-vocoder time stretch: the output plays `rate`x faster
    (duration /rate) at unchanged pitch. Classic PV over this package's
    own STFT (64 ms hann, 25% hop): linear-interpolated magnitudes on the
    stretched frame grid with accumulated instantaneous phase.

    First-party replacement for the reference environment's
    librosa.effects machinery."""
    from ..dsp import istft, stft

    if rate == 1.0:
        return np.asarray(x, np.float64)
    X = stft(np.asarray(x, np.float64), dtype="complex128")
    F, N = X.shape
    nfft, hop = 1024, 256
    # expected per-hop phase advance of each bin
    dphi = 2.0 * np.pi * np.arange(F) * hop / nfft
    steps = np.arange(0.0, N - 1, rate)
    lo = steps.astype(np.int64)
    frac = steps - lo
    mag = (1 - frac) * np.abs(X[:, lo]) + frac * np.abs(X[:, lo + 1])
    # heterodyned phase increment of the source pair, wrapped to [-pi, pi)
    dp = np.angle(X[:, lo + 1]) - np.angle(X[:, lo]) - dphi[:, None]
    dp -= 2.0 * np.pi * np.round(dp / (2.0 * np.pi))
    inc = dp + dphi[:, None]
    phase = np.empty((F, len(steps)))
    phase[:, 0] = np.angle(X[:, 0])
    np.cumsum(inc[:, :-1], axis=1, out=phase[:, 1:])
    phase[:, 1:] += phase[:, :1]
    y = istft((mag * np.exp(1j * phase)).astype(np.complex64))
    return np.asarray(y, np.float64)


def pitch_shift(x, factor, fs=FS):
    """Pitch (and formant) shift by `factor` at unchanged duration:
    resample to factor-x speed (speed_perturb) then phase-vocoder stretch
    the duration back. factor > 1 raises pitch. Shifting formants along
    with pitch is intentional — each factor yields a distinct synthetic
    SPEAKER (vocal-tract length scales with the shift), which is the
    point of the evaluation-campaign voice variants."""
    if factor == 1.0:
        return np.asarray(x, np.float64)
    y = speed_perturb(x, factor)          # pitch*factor, duration/factor
    z = pv_stretch(y, 1.0 / factor)       # duration restored
    # PV returns whole frames; trim/pad to the source length
    if len(z) >= len(x):
        return z[: len(x)]
    return np.pad(z, (0, len(x) - len(z)))


# (factor_pitch, factor_speed) pairs; pitch=1, speed=1 = the original
# voice. Pitch factors move pitch AND formants (synthetic vocal-tract
# change); speed factors move pitch+formants+tempo together — the
# combinations span 8 audibly distinct synthetic speakers per source.
VOICE_VARIANTS = (
    (1.0, 1.0),
    (0.84, 1.0), (0.92, 1.0), (1.09, 1.0), (1.19, 1.0),
    (1.0, 0.9), (1.0, 1.12),
    (0.89, 1.08), (1.12, 0.93),
)


def voice_variants(x, variants=VOICE_VARIANTS, peak_normalize=True):
    """Synthetic-speaker copies of one clean utterance (the evaluation
    campaign's multi-speaker lever, and a training-bank augmentation):
    each (pitch, speed) pair of `variants` produces one variant; the
    identity pair returns the input. Peak-normalized like the loaders."""
    out = []
    for fp, fs_ in variants:
        y = pitch_shift(x, fp) if fp != 1.0 else np.asarray(x, np.float64)
        if fs_ != 1.0:
            y = speed_perturb(y, fs_)
        if peak_normalize:
            y = y / np.max(np.abs(y))
        out.append(y.astype(np.float64))
    return out


def augment_clean(streams, factors=(0.9, 1.1), gains=(0.7, 1.4), seed=17):
    """Augmented copies of clean utterances for small-corpus training
    (VERDICT round-2 item 3): speed perturbation at each factor plus
    random-gain copies. Returns originals + augmented (originals first);
    every stream is peak-normalized like the originals, gain copies are
    scaled afterwards so the frame distribution sees level diversity
    (MCEM's per-frame gain g must generalize over levels)."""
    r = np.random.RandomState(seed)
    out = list(streams)
    for x in streams:
        for f in factors:
            y = speed_perturb(x, f)
            out.append(y / (np.abs(y).max() + 1e-12))
    for x in streams:
        g = gains[0] + (gains[1] - gains[0]) * r.rand()
        out.append(np.asarray(x) * g)
    return out


def _load_speech(path, fs=FS, cut_burst=True):
    x, fs_x = read_wav(path)
    if fs_x != fs:
        raise ValueError("Unexpected sampling rate")
    if cut_burst:
        x = x[int(0.1 * fs):]
    return x / np.max(np.abs(x))


def create_clean_frames(input_speech_dir, output_file, dataset_types=("train",
                        "validation"), labels="labels",
                        quantile_fraction=0.999, quantile_weight=0.999,
                        wlen_sec=64e-3, hop_percent=0.25, fs=FS):
    """Clean-speech frame store: per utterance STFT power + IBM or VAD label
    appended to X_/Y_<split> (reference create_train_set.py:92-156)."""
    y_bins = 1 if labels == "vad_labels" else 513
    attrs = {
        "fs": fs, "wlen_sec": wlen_sec, "hop_percent": hop_percent,
        "quantile_fraction": quantile_fraction,
        "quantile_weight": quantile_weight,
    }
    for dataset_type in dataset_types:
        files = speech_list(input_speech_dir, dataset_type)
        with H5FrameWriter(output_file, dataset_type, 513, y_bins,
                           attrs=attrs, track_stats=False) as w:
            for path in files:
                x = _load_speech(os.path.join(input_speech_dir, path), fs)
                x_tf = stft(x, fs=fs, wlen_sec=wlen_sec,
                            hop_percent=hop_percent)
                power = np.abs(x_tf) ** 2
                if labels == "vad_labels":
                    label = clean_speech_VAD(x_tf, quantile_fraction,
                                             quantile_weight)
                else:
                    label = clean_speech_IBM(x_tf, quantile_fraction,
                                             quantile_weight)
                w.append(power, label)
    return output_file


def create_noisy_frames(input_speech_dir, output_file, noise_audios_by_type,
                        dataset_types=("train", "validation"),
                        labels="noisy_labels", quantile_fraction=0.999,
                        quantile_weight=0.999, snrs=(-5, -2.5, 0, 2.5, 5.0),
                        eps=1e-8, wlen_sec=64e-3, hop_percent=0.25, fs=FS,
                        output_wav_dir=None, seed=0, file_lists=None):
    """Noisy frame store: seeded noise-type/SNR draws per utterance, SNR
    mixing, IBM/VAD/ideal-Wiener labels from the clean (and noise) STFTs,
    train mean/std accumulation (reference
    create_noisy_train_set.py:155-331).

    `noise_audios_by_type` maps split -> {noise_type: 16 kHz mono array}.
    `file_lists` (split -> wav paths, joined onto `input_speech_dir`)
    replaces the WSJ0 directory enumeration for arbitrary user corpora
    (`gvnmf dataset`).
    """
    y_bins = 1 if labels == "noisy_vad_labels" else 513
    attrs = {
        "fs": fs, "wlen_sec": wlen_sec, "hop_percent": hop_percent,
        "quantile_fraction": quantile_fraction,
        "quantile_weight": quantile_weight,
    }
    all_snr = {}
    for dataset_type in dataset_types:
        files = (file_lists[dataset_type] if file_lists is not None
                 else speech_list(input_speech_dir, dataset_type))
        noise_audios = noise_audios_by_type[dataset_type]
        noise_types = list(noise_audios.keys())

        np.random.seed(seed)
        noise_index = np.random.randint(len(noise_types), size=len(files))
        snrs_index = np.random.randint(len(snrs), size=len(files))

        track = dataset_type == "train"
        snr_list = []
        with H5FrameWriter(output_file, dataset_type, 513, y_bins,
                           attrs=attrs, track_stats=track) as w:
            for i, path in enumerate(files):
                speech = _load_speech(os.path.join(input_speech_dir, path),
                                      fs)
                noise = noise_segment(noise_audios,
                                      noise_types[noise_index[i]], speech)
                snr_dB = snrs[snrs_index[i]]
                snr_list.append(snr_dB)

                k = np.sum(speech**2) * 10 ** (-snr_dB / 10) / np.sum(
                    noise**2
                )
                noise = noise * np.sqrt(k)
                mixture = speech + noise

                if output_wav_dir is not None:
                    base = os.path.splitext(
                        os.path.join(output_wav_dir, path)
                    )[0]
                    os.makedirs(os.path.dirname(base), exist_ok=True)
                    write_wav(base + "_s.wav", speech, fs)
                    write_wav(base + "_n.wav", noise, fs)
                    write_wav(base + "_x.wav", mixture, fs)

                mixture_tf = stft(mixture, fs=fs, wlen_sec=wlen_sec,
                                  hop_percent=hop_percent)
                speech_tf = stft(speech, fs=fs, wlen_sec=wlen_sec,
                                 hop_percent=hop_percent)
                power = np.abs(mixture_tf) ** 2

                if labels == "noisy_wiener_labels":
                    noise_tf = stft(noise, fs=fs, wlen_sec=wlen_sec,
                                    hop_percent=hop_percent)
                    label = ideal_wiener_mask(speech_tf, noise_tf, eps)
                elif labels == "noisy_vad_labels":
                    label = clean_speech_VAD(speech_tf, quantile_fraction,
                                             quantile_weight)
                else:
                    label = clean_speech_IBM(speech_tf, quantile_fraction,
                                             quantile_weight)
                w.append(power, label)
        all_snr[dataset_type] = snr_list
    return all_snr


def _make_test_utt(args):
    (input_speech_dir, output_wav_dir, path, noise_audios, noise_type,
     snr_dB, fs, start) = args
    speech = _load_speech(os.path.join(input_speech_dir, path), fs)
    noise = noise_audios[noise_type][start: start + len(speech)]
    k = np.sum(speech**2) * 10 ** (-snr_dB / 10) / np.sum(noise**2)
    noise = noise * np.sqrt(k)
    # Joint max-normalization of s, n, x (create_test_set.py:99-103)
    norm = np.max(np.abs(np.concatenate([speech, noise, speech + noise])))
    mixture = (speech + noise) / norm
    speech = speech / norm
    noise = noise / norm
    base = os.path.splitext(os.path.join(output_wav_dir, path))[0]
    os.makedirs(os.path.dirname(base), exist_ok=True)
    write_wav(base + "_s.wav", speech, fs)
    write_wav(base + "_n.wav", noise, fs)
    write_wav(base + "_x.wav", mixture, fs)


def create_test_mixtures(input_speech_dir, output_wav_dir, noise_audios,
                         dataset_type="test", snrs=(-5.0, 0.0, 5.0),
                         noise_types=("cafe", "home", "street", "car"),
                         fs=FS, seed=0, max_workers=8):
    """Test mixtures as jointly normalized wav triplets + pickled snr_db
    list (reference create_test_set.py:60-178). The noise types, SNRs and
    every utterance's noise window are drawn under `seed` in file order
    before the pool starts (each window by :func:`noise_start`, the draw
    :func:`noise_segment` makes), so the output does not depend on
    `max_workers` or on thread scheduling. It equals the JAX package's
    run with its pool made serial: JAX draws each window inside its pool
    workers, where the order follows the scheduling."""
    files = speech_list(input_speech_dir, dataset_type)
    np.random.seed(seed)
    noise_types = list(noise_types)
    noise_index = np.random.randint(len(noise_types), size=len(files))
    snrs = list(snrs)
    snrs_index = np.random.randint(len(snrs), size=len(files))

    all_snr_dB = [snrs[snrs_index[i]] for i in range(len(files))]
    write_dataset(all_snr_dB, output_wav_dir, dataset_type, "snr_db")

    args = []
    for i, path in enumerate(files):
        n = len(_load_speech(os.path.join(input_speech_dir, path), fs))
        noise_type = noise_types[noise_index[i]]
        args.append((input_speech_dir, output_wav_dir, path, noise_audios,
                     noise_type, all_snr_dB[i], fs,
                     noise_start(noise_audios, noise_type, n)))
    with ThreadPoolExecutor(max_workers=max_workers) as ex:
        list(ex.map(_make_test_utt, args))
    return all_snr_dB
