"""The port's metric sweep (`metrics.runner`) against the JAX package's on
the same synthetic data root, on the CPU: the same keys, rows (`==`),
statistics and printed tables, serial and through the port's spawn pool of
2 workers, with mask F1 (IBM and VAD targets), the mixture floor and the
JSON side-cars. The pool's workers see no card, and figures raise
NotImplementedError before any work.

The data root has the reference layout: three speech-like utterances of
1-2 s under `raw/` and `processed/` (`<utt>_{s,n,x}.wav`), the test split's
SNR pickle, and an "enhanced" directory with `<utt>_s_est.wav` and
`<utt>_ibm_hard_est.npy` (the clean IBM with a tenth of its labels
flipped)."""

import os

import numpy as np
import pytest
import torch

from guided_vae_nmf_torch.data import read_wav, write_dataset, write_wav
from guided_vae_nmf_torch.dsp import clean_speech_IBM, clean_speech_VAD, stft
from guided_vae_nmf_torch.metrics import runner
from guided_vae_nmf_tpu.metrics import runner as j_runner

torch.set_num_threads(2)

FS = 16000
# two utterances at 5 dB, one at 0 dB: a per-SNR table of one utterance has
# no confidence interval (NaN), as in JAX
UTTS = (("440", "440c0201", 1.3, 5.0), ("440", "440c0202", 1.9, 0.0),
        ("441", "441c0203", 1.6, 5.0))


def speech_like(seed, seconds, snr_db):
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
    return s * scale, noise * scale


def data_root(root, utts=UTTS):
    """Write the reference layout under `root`; returns (raw dir,
    processed dir, est dir)."""
    raw, proc, est = (os.path.join(root, d) + "/"
                      for d in ("raw", "processed", "enhanced"))
    rel = os.path.join("CSR-1-WSJ-0", "WAV", "wsj0", "si_et_05")
    snrs = []
    for i, (spk, utt, sec, snr) in enumerate(utts):
        s, n = speech_like(20 + i, sec, snr)
        x = s + n
        for base in (raw, proc, est):
            os.makedirs(os.path.join(base, rel, spk), exist_ok=True)
        write_wav(os.path.join(raw, rel, spk, utt + ".wav"), s, FS)
        for tag, sig in (("s", s), ("n", n), ("x", x)):
            write_wav(os.path.join(proc, rel, spk, f"{utt}_{tag}.wav"), sig,
                      FS)
        rng = np.random.RandomState(i)
        sh = s + 0.3 * n + 0.05 * np.tanh(3 * s)
        write_wav(os.path.join(est, rel, spk, f"{utt}_s_est.wav"), sh, FS)
        y = clean_speech_IBM(stft(s)).astype(np.uint8)
        flip = rng.rand(*y.shape) < 0.1
        np.save(os.path.join(est, rel, spk, f"{utt}_ibm_hard_est.npy"),
                np.where(flip, 1 - y, y))
        snrs.append(snr)
    write_dataset(snrs, proc, "test", "snr_db")
    return raw, proc, est


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return data_root(str(tmp_path_factory.mktemp("metrics_root")))


def both(capsys, **kw):
    """(port result, its printed tables), (JAX result, its tables)."""
    out = []
    for mod in (runner, j_runner):
        res = mod.run_metrics(**kw)
        out.append((res, capsys.readouterr().out))
    return out


@pytest.mark.parametrize("case", [
    dict(with_f1=True),
    dict(with_f1=False),
    dict(mixture_floor=True),
], ids=["f1", "no-f1", "mixture-floor"])
def test_run_metrics_serial_matches_jax(tree, capsys, case):
    raw, proc, est = tree
    (got, got_out), (ref, ref_out) = both(
        capsys, input_speech_dir=raw, processed_dir=proc,
        est_dir=None if case.get("mixture_floor") else est, serial=True,
        **case)
    keys, rows, snr, stats = got
    assert keys == ref[0] and rows == ref[1] and snr == ref[2]
    np.testing.assert_equal(stats, ref[3])     # NaN where JAX has NaN
    assert got_out == ref_out
    assert len(rows) == 3 and all(np.all(np.isfinite(r)) for r in rows)
    assert keys[:5] == ["SI-SDR", "SI-SIR", "SI-SAR", "ESTOI", "PESQ"]
    assert (keys[5:] == runner.METRIC_KEYS_F1) == bool(case.get("with_f1"))


def test_run_metrics_vad_target_matches_jax(tmp_path, capsys):
    raw, proc, est = data_root(str(tmp_path), UTTS[:2])
    for spk, utt, _, _ in UTTS[:2]:
        rel = os.path.join("CSR-1-WSJ-0", "WAV", "wsj0", "si_et_05", spk,
                           utt)
        s, _ = read_wav(os.path.join(proc, rel) + "_s.wav")
        np.save(os.path.join(est, rel) + "_ibm_hard_est.npy",
                clean_speech_VAD(stft(s))[None].astype(np.uint8))
    (got, out), (ref, ref_out) = both(
        capsys, input_speech_dir=raw, processed_dir=proc, est_dir=est,
        with_f1=True, target="vad", serial=True, save_json=True)
    assert got[1] == ref[1] and out == ref_out
    np.testing.assert_equal(got[3], ref[3])
    assert os.path.exists(os.path.join(est, "stats.json"))


def test_run_metrics_pool_matches_jax_serial(tree, capsys):
    raw, proc, est = tree
    got = runner.run_metrics(raw, proc, est, with_f1=True, max_workers=2)
    capsys.readouterr()
    ref = j_runner.run_metrics(raw, proc, est, with_f1=True, serial=True)
    assert got[0] == ref[0] and got[1] == ref[1]
    np.testing.assert_equal(got[3], ref[3])


def test_objective_rows_match_jax(tree):
    raw, proc, est = tree
    path = os.path.join("CSR-1-WSJ-0", "WAV", "wsj0", "si_et_05", "440",
                        "440c0201.wav")
    args = (proc, est, path, True, "ibm", 0.98, 0.999, False, True)
    got = runner.compute_metrics_utt(args)
    assert got == j_runner.compute_metrics_utt(args) and len(got) == 13
    assert (runner.compute_metrics_mixture_utt((proc, path, True))
            == j_runner.compute_metrics_mixture_utt((proc, path, True)))


def test_pool_workers_see_no_card():
    with runner.metrics_pool(1) as ex:
        assert ex.submit(os.getenv, "CUDA_VISIBLE_DEVICES").result() == ""
        assert ex.submit(torch.cuda.device_count).result() == 0
        assert ex.submit(torch.cuda.is_initialized).result() is False
    assert ex._mp_context.get_start_method() == "spawn"


def test_figures_raise_before_any_work(tmp_path):
    missing = str(tmp_path / "nowhere")
    with pytest.raises(NotImplementedError, match="Queue 1, item 6"):
        runner.run_metrics(missing, missing, missing, make_figures=True)
    with pytest.raises(NotImplementedError, match="item 6"):
        runner.compute_metrics_utt((missing, missing, "a.wav", False, "ibm",
                                    0.98, 0.999, True))
