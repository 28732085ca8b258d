"""The port's metrics package, file lists, noise helpers, mask F1 and
config helpers against the JAX package's, on the CPU.

The numpy modules (SI-SDR, STOI / ESTOI, PESQ, the objective measures, the
statistics, the file lists, the noise helpers) are the port's own copies:
they must give JAX's values bit for bit (`==` / `np.array_equal`).
`energy_ratios_torch` is held against `energy_ratios_jax` within 1e-3 dB in
float32 and against numpy within 1e-9 dB in float64; `f1_loss` against
JAX's within rtol 1e-6. Signals are speech-like (harmonic, syllable-gated,
1-3 s) from a seed."""

import dataclasses
import io
import os
import sys
from contextlib import redirect_stdout

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import guided_vae_nmf_torch.metrics as tm
from guided_vae_nmf_torch import config as t_config
from guided_vae_nmf_torch.data import file_lists as t_lists
from guided_vae_nmf_torch.data import noise as t_noise
from guided_vae_nmf_torch.metrics import objective as t_obj
from guided_vae_nmf_torch.metrics import si_sdr as t_si
from guided_vae_nmf_torch.metrics import stats as t_stats
from guided_vae_nmf_torch.models.losses import f1_loss
from guided_vae_nmf_tpu import config as j_config
from guided_vae_nmf_tpu.data import file_lists as j_lists
from guided_vae_nmf_tpu.data import noise as j_noise
from guided_vae_nmf_tpu.metrics import objective as j_obj
from guided_vae_nmf_tpu.metrics import si_sdr as j_si
from guided_vae_nmf_tpu.metrics import stats as j_stats
from guided_vae_nmf_tpu.models.losses import f1_loss as j_f1_loss
import guided_vae_nmf_tpu.metrics as jm

torch.set_num_threads(2)

FS = 16000
# each package's attributes `pesq` and `stoi` are functions that shadow
# their submodules
t_pesq = sys.modules["guided_vae_nmf_torch.metrics.pesq"]
j_pesq = sys.modules["guided_vae_nmf_tpu.metrics.pesq"]
t_stoi = sys.modules["guided_vae_nmf_torch.metrics.stoi"]
j_stoi = sys.modules["guided_vae_nmf_tpu.metrics.stoi"]


def speech_like(seed, seconds, snr_db=5.0):
    """(clean, noise, mixture) float64 in [-1, 1)."""
    rng = np.random.RandomState(seed)
    n = int(seconds * FS)
    t = np.arange(n) / FS
    f0 = rng.uniform(100, 200) * (1 + 0.1 * np.sin(2 * np.pi * 0.4 * t))
    phase = 2 * np.pi * np.cumsum(f0) / FS
    s = sum(np.sin(k * phase) / k for k in range(1, 20))
    s *= 0.5 - 0.5 * np.cos(2 * np.pi * rng.uniform(3, 5) * t)
    noise = np.convolve(rng.randn(n), np.ones(4) / 4, mode="same")
    noise *= np.sqrt(np.mean(s**2) / np.mean(noise**2) / 10 ** (snr_db / 10))
    scale = 0.5 / np.max(np.abs(s + noise))
    return s * scale, noise * scale, (s + noise) * scale


@pytest.fixture(scope="module")
def pair():
    s, n, x = speech_like(3, 2.2)
    # an "enhanced" estimate: the mixture with the noise partly removed
    return s, n, x, s + 0.3 * n


def test_si_sdr_numpy_copy_is_bit_equal(pair):
    s, n, x, sh = pair
    for est in (x, sh):
        for a, b in zip(t_si.si_sdr_components(est, s, n),
                        j_si.si_sdr_components(est, s, n)):
            assert np.array_equal(a, b)
        assert t_si.energy_ratios(est, s, n) == j_si.energy_ratios(est, s, n)


def _batch(lengths, dtype, artifacts=0.2):
    """Zero-padded (s_hat, s, n) rows: an estimate with residual noise and,
    with `artifacts`, a nonlinear distortion of the speech (SI-SAR about
    27 dB at 0.2; enhanced outputs score 5-20 dB)."""
    rows = [speech_like(10 + i, sec) for i, sec in enumerate(lengths)]
    T = max(len(r[0]) for r in rows)
    out = np.zeros((3, len(rows), T), dtype)
    for i, (s, n, x) in enumerate(rows):
        sh = s + 0.25 * n + artifacts * np.tanh(3 * s)
        out[:, i, :len(s)] = (sh, s, n)
    return rows, out


def test_energy_ratios_torch_float32_matches_jax():
    rows, (sh, s, n) = _batch((1.0, 1.7, 2.4), np.float32)
    got = t_si.energy_ratios_torch(*(torch.tensor(a) for a in (sh, s, n)))
    for i, (si, ni, xi) in enumerate(rows):
        L = len(si)
        ref = j_si.energy_ratios_jax(*(jnp.asarray(a[i, :L])
                                       for a in (sh, s, n)))
        for g, r in zip(got, ref):
            assert g.dtype == torch.float32
            assert abs(float(g[i]) - float(r)) < 1e-3


def test_energy_ratios_torch_float32_on_an_artifact_free_estimate():
    """s_hat = s + 0.25 n exactly: e_art is a difference of nearly equal
    terms (SI-SAR 42.9 dB), the ill-conditioned end. The port's float32
    stays within 1e-3 dB of the float64 ratios; JAX's float32 does not
    (1.3e-3 dB off in SI-SAR on this row), so this row is held against
    float64 instead of against JAX."""
    s, n, _ = speech_like(11, 1.7)
    sh = s + 0.25 * n
    got = t_si.energy_ratios_torch(*(torch.tensor(a, dtype=torch.float32)
                                     for a in (sh, s, n)))
    ref = t_si.energy_ratios(sh, s, n)
    assert ref[2] > 40
    for g, r in zip(got, ref):
        assert abs(float(g) - r) < 1e-3


def test_energy_ratios_torch_float64_matches_numpy_and_padding():
    rows, (sh, s, n) = _batch((1.0, 1.7, 2.4), np.float64)
    got = t_si.energy_ratios_torch(*(torch.tensor(a) for a in (sh, s, n)))
    for i, (si, ni, xi) in enumerate(rows):
        L = len(si)
        ref = t_si.energy_ratios(sh[i, :L], s[i, :L], n[i, :L])
        alone = t_si.energy_ratios_torch(
            *(torch.tensor(a[i, :L]) for a in (sh, s, n)))
        for g, r, a in zip(got, ref, alone):
            assert g.dtype == torch.float64 and g.shape == (len(rows),)
            assert abs(float(g[i]) - r) < 1e-9
            # zero padding leaves the row's ratios unchanged
            assert abs(float(g[i]) - float(a)) < 1e-9
    # extra zeros past every row's end change nothing either
    wide = [torch.nn.functional.pad(torch.tensor(a), (0, 777))
            for a in (sh, s, n)]
    for g, w in zip(got, t_si.energy_ratios_torch(*wide)):
        assert torch.allclose(g, w, rtol=0, atol=1e-9)


def test_stoi_copy_is_bit_equal_and_keeps_the_pins(pair):
    s, n, x, sh = pair
    for ext in (False, True):
        assert t_stoi.stoi(s, sh, FS, ext) == j_stoi.stoi(s, sh, FS, ext)
    assert t_stoi.estoi(s, x, FS) == j_stoi.estoi(s, x, FS)
    assert np.array_equal(t_stoi.third_octave_band_matrix(10000, 512, 15, 150)[0],
                          j_stoi.third_octave_band_matrix(10000, 512, 15, 150)[0])
    for a, b in zip(t_stoi.remove_silent_frames(s, sh, 40, 256, 128),
                    j_stoi.remove_silent_frames(s, sh, 40, 256, 128)):
        assert np.array_equal(a, b)
    # tests/metrics/test_goldens.py::test_stoi_synthetic_pins, on the port
    rng = np.random.RandomState(7)
    m = 3 * FS
    t = np.arange(m) / FS
    c = np.sin(2 * np.pi * np.cumsum(
        150 + 50 * np.sin(2 * np.pi * 0.7 * t)) / FS)
    c *= np.clip(np.sin(2 * np.pi * 2.1 * t), 0, None)
    y = c + rng.randn(m) * np.sqrt(np.mean(c ** 2)) * 10 ** (-5 / 20)
    assert t_stoi.stoi(c, y, FS) == pytest.approx(0.2280849027, abs=1e-8)
    assert t_stoi.stoi(c, y, FS, extended=True) == pytest.approx(
        0.1575051002, abs=1e-8)


@pytest.mark.parametrize("mode", ["wb", "nb"])
def test_pesq_copy_is_bit_equal(pair, mode):
    s, n, x, sh = pair
    fs = 16000 if mode == "wb" else 8000
    s_, sh_ = (s, sh) if mode == "wb" else (s[::2], sh[::2])
    got = t_pesq.pesq(fs, s_, sh_, mode)
    assert got == j_pesq.pesq(fs, s_, sh_, mode)
    assert t_pesq.mos_lqo_wb(got) == j_pesq.mos_lqo_wb(got)
    assert t_pesq.mos_lqo_nb(got) == j_pesq.mos_lqo_nb(got)


def test_pesq_choice_and_public_names():
    assert (tm.HAS_PESQ, tm.HAS_PESQ_NATIVE) == (jm.HAS_PESQ,
                                                 jm.HAS_PESQ_NATIVE)
    assert tm.HAS_POLQA == jm.HAS_POLQA
    names = {n for n in dir(tm) if not n.startswith("_")}
    jnames = {n for n in dir(jm) if not n.startswith("_")}
    assert names ^ jnames == {"energy_ratios_jax", "energy_ratios_torch"}
    # without the wheel the package attribute is the first-party function
    if not tm.HAS_PESQ_NATIVE:
        assert tm.pesq is t_pesq.pesq
    from guided_vae_nmf_torch.metrics import runner

    assert runner.pesq_score is tm.pesq


def test_objective_copy_is_bit_equal(pair):
    s, n, x, sh = pair
    for fn in ("seg_snr", "fw_seg_snr", "llr", "wss"):
        for est in (x, sh):
            assert getattr(t_obj, fn)(s, est) == getattr(j_obj, fn)(s, est)


def test_stats_copy_is_equal(tmp_path):
    rng = np.random.RandomState(1)
    rows = [tuple(rng.randn(3)) for _ in range(9)]
    snr = np.array([-5.0, 0.0, 5.0] * 3)
    assert (t_stats.mean_confidence_interval([1.0, 2.5, 4.0])
            == j_stats.mean_confidence_interval([1.0, 2.5, 4.0]))
    outs = {}
    for name, mod in (("t", t_stats), ("j", j_stats)):
        d = tmp_path / name
        buf = io.StringIO()
        with redirect_stdout(buf):
            res = mod.compute_stats(["A", "B", "C"], rows, snr,
                                    model_data_dir=str(d), save_json=True)
            res2 = mod.compute_stats_noisnr(["A", "B", "C"], rows,
                                            model_data_dir=str(d),
                                            save_json=True)
        files = {f: (d / f).read_text() for f in sorted(os.listdir(d))}
        outs[name] = (res, res2, buf.getvalue(), files)
    assert outs["t"] == outs["j"]
    assert sorted(outs["t"][3]) == ["polqa_stats.json", "stats.json",
                                    "stats_-5.json", "stats_0.json",
                                    "stats_5.json"]


def test_file_lists_copy(tmp_path):
    assert t_lists.SPLIT_DIRS == j_lists.SPLIT_DIRS
    for split, sub in t_lists.SPLIT_DIRS.items():
        for spk, utt in (("440", "440c0201"), ("441", "441c0202")):
            p = (tmp_path / "raw" / "CSR-1-WSJ-0" / "WAV" / "wsj0" / sub
                 / spk / f"{utt}.wav")
            p.parent.mkdir(parents=True, exist_ok=True)
            p.write_bytes(b"")
    raw = str(tmp_path / "raw") + "/"
    for split in t_lists.SPLIT_DIRS:
        got = t_lists.speech_list(raw, split)
        assert got == j_lists.speech_list(raw, split) and len(got) == 2
    with pytest.raises(ValueError):
        t_lists.speech_list(raw, "nope")
    data = [np.float64(-5.0), np.float64(2.5)]
    t_lists.write_dataset(data, str(tmp_path / "t"), "test", "snr_db")
    j_lists.write_dataset(data, str(tmp_path / "j"), "test", "snr_db")
    rel = os.path.join("CSR-1-WSJ-0", "si_et_05_snr_db.p")
    assert ((tmp_path / "t" / rel).read_bytes()
            == (tmp_path / "j" / rel).read_bytes())
    assert j_lists.read_dataset(str(tmp_path / "t"), "test",
                                "snr_db") == data
    assert t_lists.read_dataset(str(tmp_path / "j"), "test",
                                "snr_db") == data


def test_noise_copy_is_bit_equal():
    rng = np.random.RandomState(4)
    stereo48 = rng.uniform(-0.5, 0.5, (48000, 2))
    for x, fs in ((stereo48, 48000), (stereo48[:, 0], 16000),
                  (stereo48[:22050, 1], 22050)):
        assert np.array_equal(t_noise.preprocess_noise(x, fs),
                              j_noise.preprocess_noise(x, fs))
    s, n, _ = speech_like(5, 1.0)
    for snr in (-5.0, 0.0, 7.5):
        assert t_noise.snr_gain(s, n, snr) == j_noise.snr_gain(s, n, snr)
        assert np.array_equal(t_noise.mix_at_snr(s, n, snr),
                              j_noise.mix_at_snr(s, n, snr))
    tb = t_noise.synthetic_noise_bank(duration_sec=0.5, rich=True)
    jb = j_noise.synthetic_noise_bank(duration_sec=0.5, rich=True)
    assert tb.keys() == jb.keys()
    assert all(np.array_equal(tb[k], jb[k]) for k in tb)


def test_f1_loss_matches_jax():
    rng = np.random.RandomState(2)
    y = (rng.rand(513 * 200) > 0.6).astype(np.float32)
    y_hat = np.where(rng.rand(y.size) > 0.2, y, 1 - y).astype(np.uint8)
    got = f1_loss(y_hat, y)
    ref = j_f1_loss(jnp.asarray(y_hat), jnp.asarray(y))
    for g, r in zip(got, ref):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(float(g), float(r), rtol=1e-6, atol=0)
    # tensors in, the same scores out
    assert all(torch.equal(a, b) for a, b in zip(
        f1_loss(torch.tensor(y_hat), torch.tensor(y)), got))


ARGV_TABLE = [
    [],
    ["--dataset_size", "complete", "--data_root", "/data", "--x", "1"],
    ["--niter", "7", "--var_RW", "0.5", "--noise_gain", "true", "--model",
     "m"],
    ["--noise_gain", "0", "--niter"],
    ["--h_dim", "64,32", "--z_dim", "4", "--label", "dnn"],
]


@pytest.mark.parametrize("argv", ARGV_TABLE, ids=str)
def test_apply_overrides_matches_jax(argv):
    for t_cls, j_cls in ((t_config.PathsConfig, j_config.PathsConfig),
                         (t_config.MCEMConfig, j_config.MCEMConfig),
                         (t_config.ModelDims, j_config.ModelDims),
                         (t_config.LabelConfig, j_config.LabelConfig),
                         (t_config.StftConfig, j_config.StftConfig)):
        got, rest = t_config.apply_overrides(t_cls(), list(argv))
        ref, jrest = j_config.apply_overrides(j_cls(), list(argv))
        assert dataclasses.asdict(got) == dataclasses.asdict(ref)
        assert rest == jrest
    paths = t_config.PathsConfig(data_root="d", dataset_size="s")
    jpaths = j_config.PathsConfig(data_root="d", dataset_size="s")
    for prop in ("input_speech_dir", "processed_wav_dir", "pickle_dir",
                 "export_dir", "models_dir"):
        assert getattr(paths, prop) == getattr(jpaths, prop)
    assert paths.h5_path("noisy_labels") == jpaths.h5_path("noisy_labels")


def test_apply_overrides_help_matches_jax(capsys):
    outs = []
    for mod in (t_config, j_config):
        with pytest.raises(SystemExit) as e:
            mod.apply_overrides(mod.MCEMConfig(), ["--niter", "3", "-h"])
        outs.append((e.value.code, capsys.readouterr().out))
    assert outs[0] == outs[1] and outs[0][0] == 0
    assert "--niter (default: 100)" in outs[0][1]
    assert t_config.TrainConfig().end_epoch == \
        j_config.TrainConfig().end_epoch
    assert set(t_config.__all__) == set(j_config.__all__)
