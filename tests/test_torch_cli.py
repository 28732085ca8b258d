"""The port's `gvnmf-torch` command line (guided_vae_nmf_torch/cli.py) on
the CPU: its parser against the JAX package's `gvnmf` parser (the same
subcommands, flags, choices and defaults, found by walking the argparse
actions, plus `--device` on enhance / stream / serve); `metrics` printing
JAX's text; `enhance` and `stream` at full width with the shipped weights
(`--niter 2`, `--device cpu`) giving the PCM of the port's own library
calls with the same seed; `train` / `dataset` refusing with the training
slice's item; and the default device raising without a card."""

import argparse
import os

import numpy as np
import pytest
import torch

from guided_vae_nmf_torch import cli
from guided_vae_nmf_torch.data import read_wav, read_wav_int16, write_wav
from guided_vae_nmf_torch.data.noise import preprocess_noise
from guided_vae_nmf_torch.dsp import stft
from guided_vae_nmf_torch.mcem import MCEMConfig
from guided_vae_nmf_torch.pipeline import enhance_to_audio, make_labels
from guided_vae_nmf_torch.profiles import apply_profile_cfg, offline_settings
from guided_vae_nmf_torch.streaming import HOP, StreamingM2Enhancer
from guided_vae_nmf_torch.train import load_model, load_norm_stats
from guided_vae_nmf_tpu import cli as j_cli

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ART = os.path.join(ROOT, "artifacts", "pretrained")
M2 = os.path.join(ART, "M2_ibm")
CLS = os.path.join(ART, "classifier_ibm")
FS = 16000


def speech_like(seed, seconds, fs=FS, snr_db=5.0):
    """(clean, mixture) float64 at `fs`."""
    rng = np.random.RandomState(seed)
    n = int(seconds * fs)
    t = np.arange(n) / fs
    f0 = rng.uniform(100, 200) * (1 + 0.1 * np.sin(2 * np.pi * 0.4 * t))
    phase = 2 * np.pi * np.cumsum(f0) / fs
    s = sum(np.sin(k * phase) / k for k in range(1, 20))
    s *= 0.5 - 0.5 * np.cos(2 * np.pi * rng.uniform(3, 5) * t)
    noise = np.convolve(rng.randn(n), np.ones(4) / 4, mode="same")
    noise *= np.sqrt(np.mean(s**2) / np.mean(noise**2) / 10 ** (snr_db / 10))
    scale = 0.5 / np.max(np.abs(s + noise))
    return s * scale, (s + noise) * scale


# ---------------------------------------------------------------------------
# the parser
# ---------------------------------------------------------------------------

def _walk(parser):
    """{subcommand: {dest: (option strings, default, choices, required,
    nargs, type, action kind)}}."""
    sub = next(a for a in parser._actions
               if isinstance(a, argparse._SubParsersAction))
    out = {}
    for name, p in sub.choices.items():
        out[name] = {
            a.dest: (tuple(a.option_strings), a.default,
                     None if a.choices is None else tuple(a.choices),
                     a.required, a.nargs, a.type, type(a).__name__)
            for a in p._actions if not isinstance(a, argparse._HelpAction)}
    return out


def test_parser_has_jax_flags_plus_device():
    got, ref = _walk(cli.build_parser()), _walk(j_cli.build_parser())
    assert list(got) == list(ref)
    for name in ref:
        extra = set(got[name]) - set(ref[name])
        assert extra == ({"device"} if name in ("enhance", "stream",
                                               "serve") else set())
        assert {k: v for k, v in got[name].items() if k != "device"} \
            == ref[name], name
    assert got["enhance"]["device"][:2] == (("--device",), None)


def test_version_and_help(capsys):
    assert cli.main(["version"]) == 0
    assert capsys.readouterr().out.strip()
    with pytest.raises(SystemExit) as e:
        cli.main(["--help"])
    assert e.value.code == 0
    assert "enhance" in capsys.readouterr().out


@pytest.mark.parametrize("cmd", [
    ["train", "m2", "--h5", "x.h5", "--out", "ckpt"],
    ["dataset", "--clean", "c/", "--noise", "n/", "--out", "x.h5"],
])
def test_training_commands_refuse(cmd, capsys):
    assert cli.main(cmd) != 0
    err = capsys.readouterr().err.strip().splitlines()
    assert len(err) == 1 and "ROADMAP Queue 1, item 4" in err[0]


def test_default_device_raises_without_a_card(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    wav = str(tmp_path / "x.wav")
    write_wav(wav, speech_like(0, 0.5)[1], FS)
    for argv in (["enhance", wav, str(tmp_path / "o.wav"), "--model", M2,
                  "--classifier", CLS],
                 ["stream", wav, str(tmp_path / "o.wav"), "--model", M2],
                 ["serve", "--models", ART]):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            cli.main(argv)


def test_serve_data_parallel_raises():
    with pytest.raises(NotImplementedError, match="item 5"):
        cli.main(["serve", "--models", ART, "--data_parallel",
                  "--device", "cpu"])


def test_doctor_reports_and_returns_zero(capsys):
    assert cli.main(["doctor", "--probe_s", "60"]) == 0
    out = capsys.readouterr().out
    for row in ("torch", "cuda", "nvcc", "build dir",
                "kernel library mh_chain", "kernel library nmf_sums"):
        assert row in out
    assert "fallback" not in out


# ---------------------------------------------------------------------------
# metrics
# ---------------------------------------------------------------------------

def test_metrics_prints_jax_text(tmp_path, capsys):
    s, x = speech_like(1, 1.6)
    paths = {}
    for name, sig in (("s", s), ("sh", s + 0.4 * (x - s)), ("x", x)):
        paths[name] = str(tmp_path / f"{name}.wav")
        write_wav(paths[name], sig, FS)
    for argv in (["--clean", paths["s"], "--enhanced", paths["sh"]],
                 ["--clean", paths["s"], "--enhanced", paths["sh"],
                  "--mixture", paths["x"]]):
        assert cli.main(["metrics", *argv]) == 0
        got = capsys.readouterr().out
        assert j_cli.main(["metrics", *argv]) == 0
        assert got == capsys.readouterr().out
        assert "PESQ-wb" in got


# ---------------------------------------------------------------------------
# enhance and stream against the library
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def mods():
    m2 = load_model(M2, kind="dgm", device="cpu")
    cls = load_model(CLS, kind="classifier", device="cpu")
    return m2, cls, *load_norm_stats(CLS)


def library_pcm(mods, paths, tmp, label="dnn", s_ref=None, profile=None,
                seed=0, niter=2):
    """int16 (s, n) per input through the port's library: read, first
    channel at 16 kHz, STFT, labels, enhance_to_audio with one generator
    seeded `seed`, PCM16 as write_wav quantises."""
    m2, cls, mean, std = mods
    xs = [preprocess_noise(*read_wav(p)).astype(np.float32) for p in paths]
    X = [stft(x) for x in xs]
    cfg, noise_model, soft = MCEMConfig(niter=niter), "nmf", False
    if profile:
        noise_model, soft = offline_settings(profile)
        cfg = apply_profile_cfg(cfg, profile)
    ys = []
    for Xi in X:
        y_soft, y_hard = make_labels(label, np.abs(Xi) ** 2, s_path=s_ref,
                                     classifier=cls, mean=mean, std=std)
        ys.append(y_soft if soft else y_hard)
    s_list, n_list = enhance_to_audio(
        m2, X, [len(x) for x in xs], ys=ys,
        generator=torch.Generator().manual_seed(seed), cfg=cfg,
        noise_model=noise_model, device="cpu")
    out = []
    for i, (s, n) in enumerate(zip(s_list, n_list)):
        pair = []
        for tag, sig in (("s", s), ("n", n)):
            p = os.path.join(tmp, f"ref{i}_{tag}.wav")
            write_wav(p, sig, FS)
            pair.append(read_wav_int16(p)[0])
        out.append(pair)
    return out


def _write(path, sig, fs=FS):
    write_wav(str(path), sig, fs)
    return str(path)


def test_enhance_single_file_with_noise_out(tmp_path, mods):
    x = _write(tmp_path / "mix.wav", speech_like(2, 1.4)[1])
    out, nout = str(tmp_path / "out.wav"), str(tmp_path / "noise.wav")
    assert cli.main(["enhance", x, out, "--model", M2, "--classifier", CLS,
                     "--niter", "2", "--seed", "3", "--noise_out", nout,
                     "--device", "cpu"]) == 0
    (s_ref, n_ref), = library_pcm(mods, [x], str(tmp_path), seed=3)
    assert np.array_equal(read_wav_int16(out)[0], s_ref)
    assert np.array_equal(read_wav_int16(nout)[0], n_ref)


def test_enhance_glob_and_directory_of_mixed_rates(tmp_path, mods):
    src = tmp_path / "in"
    src.mkdir()
    paths = [_write(src / "a.wav", speech_like(4, 1.1)[1]),
             # 48 kHz stereo: converted to its first channel at 16 kHz
             _write(src / "b.wav", np.stack(
                 [speech_like(5, 1.8, fs=48000)[1],
                  speech_like(6, 1.8, fs=48000)[1]], 1), 48000)]
    ref = library_pcm(mods, paths, str(tmp_path))
    for form in (str(src), str(src / "*.wav")):
        dst = tmp_path / ("dir" if form == str(src) else "glob")
        assert cli.main(["enhance", form, str(dst) + "/", "--model", M2,
                         "--classifier", CLS, "--niter", "2",
                         "--device", "cpu"]) == 0
        for p, (s_ref, _) in zip(paths, ref):
            name = os.path.splitext(os.path.basename(p))[0]
            got = read_wav_int16(str(dst / f"{name}_enhanced.wav"))[0]
            assert np.array_equal(got, s_ref), (form, name)


def test_enhance_oracle_labels_from_a_converted_reference(tmp_path, mods):
    s, x = speech_like(7, 1.5)
    xp = _write(tmp_path / "mix.wav", x)
    # the clean reference at 48 kHz stereo, converted before the labels
    s48 = np.repeat(s, 3)
    sp = _write(tmp_path / "clean.wav", np.stack([s48, 0 * s48], 1), 48000)
    out = str(tmp_path / "out.wav")
    assert cli.main(["enhance", xp, out, "--model", M2, "--label", "oracle",
                     "--s_ref", sp, "--niter", "2", "--device", "cpu"]) == 0
    conv = _write(tmp_path / "clean16.wav",
                  preprocess_noise(*read_wav(sp)).astype(np.float32))
    (s_ref, _), = library_pcm(mods, [xp], str(tmp_path), label="oracle",
                              s_ref=conv)
    assert np.array_equal(read_wav_int16(out)[0], s_ref)


def test_enhance_real_noise_profile(tmp_path, mods):
    x = _write(tmp_path / "mix.wav", speech_like(8, 1.2)[1])
    out = str(tmp_path / "out.wav")
    assert cli.main(["enhance", x, out, "--model", M2, "--classifier", CLS,
                     "--niter", "2", "--profile", "real-noise",
                     "--device", "cpu"]) == 0
    (s_ref, _), = library_pcm(mods, [x], str(tmp_path),
                              profile="real-noise")
    assert np.array_equal(read_wav_int16(out)[0], s_ref)


def test_stream_equals_its_enhancer(tmp_path, mods):
    m2, cls, mean, std = mods
    x = speech_like(9, 1.0)[1].astype(np.float32)
    xp = _write(tmp_path / "mix.wav", x)
    out = str(tmp_path / "out.wav")
    assert cli.main(["stream", xp, out, "--model", M2, "--label", "dnn",
                     "--classifier", CLS, "--profile", "real-noise",
                     "--device", "cpu"]) == 0
    from guided_vae_nmf_torch.profiles import streaming_settings

    st = streaming_settings("real-noise")
    enh = StreamingM2Enhancer(
        m2, classifier=cls, mean=mean, std=std, label_mode="dnn",
        chunk_frames=st.get("chunk_frames", 8),
        soft_guidance=st["soft_guidance"],
        residual_tracking=st["residual_tracking"],
        noise_gain=st["noise_gain"],
        noise_gain_bands=st.get("noise_gain_bands", 1),
        adaptive_iters=st.get("adaptive_iters", 0), device="cpu")
    x16 = read_wav(xp)[0].astype(np.float32)
    chunk = enh.chunk_frames * HOP
    y = np.concatenate([enh.push(x16[lo:lo + chunk])
                        for lo in range(0, len(x16), chunk)] + [enh.flush()])
    ref = _write(tmp_path / "ref.wav", y)
    assert np.array_equal(read_wav_int16(out)[0], read_wav_int16(ref)[0])
