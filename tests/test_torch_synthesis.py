"""The port's dataset synthesis (`guided_vae_nmf_torch/data/synthesis.py`)
against the JAX package's, on the CPU, on a few synthetic speech-like wavs
in the WSJ0 layout (`raw/CSR-1-WSJ-0/WAV/wsj0/<split dir>/<spk>/`) with
short synthetic noise banks: the clean and noisy frame stores (X, Y,
attrs, train mean / std, the SNR lists, the `_s/_n/_x` wavs), the test
mixtures (wav triplets and the SNR pickle), and the augmentations. Both
packages run the same numpy code over their own copies of the STFT and
the targets, so every array is compared bit for bit."""

import os

import h5py
import numpy as np
import pytest

from guided_vae_nmf_torch.data import synthesis as ts
from guided_vae_nmf_torch.data import (read_dataset, synthetic_noise_bank,
                                       write_wav)
from guided_vae_nmf_tpu.data import synthesis as js
from guided_vae_nmf_tpu.data import read_dataset as j_read_dataset

FS = 16000
UTTS = {"si_tr_s": [("011", "011a0101", 1.3), ("011", "011a0102", 0.9),
                    ("012", "012a0103", 1.1)],
        "si_dt_05": [("021", "021a0201", 1.0), ("021", "021a0202", 0.8)],
        "si_et_05": [("031", "031a0301", 1.0), ("032", "032a0302", 1.2)]}


def speech_like(seed, seconds):
    rng = np.random.RandomState(seed)
    n = int(seconds * FS)
    t = np.arange(n) / FS
    f0 = rng.uniform(100, 200) * (1 + 0.1 * np.sin(2 * np.pi * 0.4 * t))
    phase = 2 * np.pi * np.cumsum(f0) / FS
    s = sum(np.sin(k * phase) / k for k in range(1, 20))
    s *= 0.5 - 0.5 * np.cos(2 * np.pi * rng.uniform(3, 5) * t)
    return 0.5 * s / np.max(np.abs(s))


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("corpus"))
    raw = os.path.join(root, "raw")
    seed = 0
    for split, utts in UTTS.items():
        for spk, utt, sec in utts:
            d = os.path.join(raw, "CSR-1-WSJ-0", "WAV", "wsj0", split, spk)
            os.makedirs(d, exist_ok=True)
            write_wav(os.path.join(d, utt + ".wav"), speech_like(seed, sec),
                      FS)
            seed += 1
    bank = synthetic_noise_bank(duration_sec=4)
    return root, raw + "/", bank


def store(path):
    with h5py.File(path, "r") as f:
        return ({k: f[k][...] for k in f},
                {k: np.asarray(v).tolist() for k, v in f.attrs.items()})


def same_store(a, b):
    (da, aa), (db, ab) = store(a), store(b)
    assert aa == ab
    assert sorted(da) == sorted(db)
    for k in da:
        assert np.array_equal(da[k], db[k]), k


@pytest.mark.parametrize("labels", ["labels", "vad_labels"])
def test_create_clean_frames(corpus, tmp_path, labels):
    _, raw, _ = corpus
    paths = [str(tmp_path / f"{tag}.h5") for tag in ("j", "p")]
    js.create_clean_frames(raw, paths[0], labels=labels)
    ts.create_clean_frames(raw, paths[1], labels=labels)
    same_store(*paths)


@pytest.mark.parametrize("labels", ["noisy_labels", "noisy_vad_labels",
                                    "noisy_wiener_labels"])
def test_create_noisy_frames(corpus, tmp_path, labels):
    _, raw, bank = corpus
    names = sorted(bank)
    noises = {"train": {t: bank[t] for t in names[:3]},
              "validation": {t: bank[t] for t in names[3:]}}
    out = {}
    for tag, mod in (("j", js), ("p", ts)):
        wav_dir = str(tmp_path / f"wav_{tag}")
        out[tag] = mod.create_noisy_frames(
            raw, str(tmp_path / f"{tag}.h5"), noises, labels=labels,
            output_wav_dir=wav_dir, seed=3)
    assert out["j"] == out["p"]
    same_store(str(tmp_path / "j.h5"), str(tmp_path / "p.h5"))
    for dirpath, _, files in os.walk(tmp_path / "wav_j"):
        for name in files:
            rel = os.path.relpath(os.path.join(dirpath, name),
                                  tmp_path / "wav_j")
            with open(os.path.join(dirpath, name), "rb") as a, \
                    open(tmp_path / "wav_p" / rel, "rb") as b:
                assert a.read() == b.read(), rel


def noises_of(bank):
    return dict(zip(("cafe", "home", "street", "car"),
                    (bank["white"], bank["low"], bank["mid"],
                     bank["brown"])))


def same_files(a, b):
    """Every file under `a` has the same bytes under `b`; returns the
    count."""
    n = 0
    for dirpath, _, files in os.walk(a):
        for name in files:
            rel = os.path.relpath(os.path.join(dirpath, name), a)
            with open(os.path.join(dirpath, name), "rb") as f, \
                    open(os.path.join(b, rel), "rb") as g:
                assert f.read() == g.read(), rel
            n += 1
    return n


def test_create_test_mixtures(corpus, tmp_path, monkeypatch):
    """JAX's pool made serial (`serial_jax_pool`) against the port at its
    default workers, bit for bit."""
    from test_torch_train_helpers import serial_jax_pool

    _, raw, bank = corpus
    serial_jax_pool(monkeypatch)
    snr = {"j": js.create_test_mixtures(raw, str(tmp_path / "j"),
                                        noises_of(bank)),
           "p": ts.create_test_mixtures(raw, str(tmp_path / "p"),
                                        noises_of(bank))}
    assert snr["j"] == snr["p"] and len(snr["p"]) == 2
    assert read_dataset(str(tmp_path / "p"), "test", "snr_db") == \
        j_read_dataset(str(tmp_path / "j"), "test", "snr_db")
    assert same_files(tmp_path / "j", tmp_path / "p") == 2 * 3 + 1


def test_create_test_mixtures_same_bytes_at_any_workers(corpus, tmp_path):
    """The noise windows follow `seed`, not the pool: 1 and 8 workers
    write the same files, and another seed other noise."""
    _, raw, bank = corpus
    for tag, workers, seed in (("w1", 1, 0), ("w8", 8, 0), ("s1", 8, 1)):
        ts.create_test_mixtures(raw, str(tmp_path / tag), noises_of(bank),
                                seed=seed, max_workers=workers)
    assert same_files(tmp_path / "w1", tmp_path / "w8") == 2 * 3 + 1
    with pytest.raises(AssertionError):
        same_files(tmp_path / "w1", tmp_path / "s1")


def test_augmentations_match_jax():
    x = speech_like(9, 0.7)
    for f in (1.0, 0.9, 1.12):
        assert np.array_equal(ts.speed_perturb(x, f), js.speed_perturb(x, f))
    for rate in (1.0, 0.8, 1.25):
        assert np.array_equal(ts.pv_stretch(x, rate), js.pv_stretch(x, rate))
    for f in (1.0, 0.84, 1.19):
        assert np.array_equal(ts.pitch_shift(x, f), js.pitch_shift(x, f))
    assert ts.VOICE_VARIANTS == js.VOICE_VARIANTS
    got, ref = ts.voice_variants(x), js.voice_variants(x)
    assert len(got) == len(ref) == len(ts.VOICE_VARIANTS)
    assert all(np.array_equal(a, b) for a, b in zip(got, ref))
    streams = [x, speech_like(10, 0.5)]
    got, ref = ts.augment_clean(streams), js.augment_clean(streams)
    assert len(got) == len(ref) == 2 + 4 + 2
    assert all(np.array_equal(a, b) for a, b in zip(got, ref))
