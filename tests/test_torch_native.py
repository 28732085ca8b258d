"""The port's native host loader (`data/native_loader.py` over
`csrc/gvnmf_native.cpp`), on the CPU; skipped only where g++ is missing.
It builds with g++ into a build directory under `tmp_path` and leaves
`native/` untouched; its decode equals the port's `read_wav` (RIFF and
NIST SPHERE) and its row assembly the Python `_fill_row` path, bit for
bit; its STFTs are within the JAX package's `tests/data/test_native.py`
tolerances of the port's `stft` and equal to the JAX package's native
functions; `load_mixture` and `enhance_files` give the same output with
the native path on and off (the sweep counting its native assemblies and
printing its stage report); without g++ the loader reports why and the
Python path runs."""

import os
import shutil

import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose, assert_array_equal

from guided_vae_nmf_torch import pipeline
from guided_vae_nmf_torch.data import native_loader as nl
from guided_vae_nmf_torch.data import read_wav, read_wav_int16, write_wav
from guided_vae_nmf_torch.dsp import stft
from guided_vae_nmf_torch.mcem import MCEMConfig
from guided_vae_nmf_torch.train import load_model

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FS = 16000


def tree_state(path):
    return sorted((os.path.relpath(os.path.join(d, f), path),
                   os.stat(os.path.join(d, f)).st_mtime_ns)
                  for d, _, files in os.walk(path) for f in files)


@pytest.fixture
def fresh(monkeypatch, tmp_path):
    """The loader with no library loaded and its build directory under
    tmp_path."""
    monkeypatch.setenv("GVNMF_TORCH_BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(nl, "_lib", None)
    monkeypatch.setattr(nl, "_error", None)
    return tmp_path / "build"


@pytest.fixture
def built(fresh):
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed")
    native = os.path.join(ROOT, "native")
    before = tree_state(native)
    secs = nl.build()
    assert secs > 0 and nl.is_available() and nl.unavailable_reason() == ""
    assert nl.lib_path().parent == fresh and nl.lib_path().exists()
    assert tree_state(native) == before
    assert nl.build() == 0.0        # loaded once a process
    return nl


def test_builds_into_its_build_dir_and_not_into_native(built, fresh):
    assert [p.name for p in fresh.iterdir()] == [built.lib_path().name]
    assert built.lib_path().name.startswith("libgvnmf_native-")


def test_no_compiler_means_the_python_path(fresh, monkeypatch, tmp_path):
    monkeypatch.setattr(nl.shutil, "which", lambda name: None)
    assert not nl.is_available()
    assert nl.unavailable_reason() == "g++ not found"
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        nl.read_wav_native("x.wav")
    x = np.clip(0.3 * np.random.RandomState(0).randn(5000), -1, 1)
    write_wav(str(tmp_path / "u_x.wav"), x, FS)
    nl.reset_call_counts()
    x_t, T, X = pipeline.load_mixture(str(tmp_path / "u"))
    assert T == 5000 and np.array_equal(X, stft(x_t))
    assert nl.call_counts() == {}


def sphere(path, pcm):
    fields = {"sample_count": len(pcm), "sample_rate": FS,
              "sample_n_bytes": 2, "channel_count": 1}
    head = "NIST_1A\n   1024\n" + "".join(
        f"{k} -i {v}\n" for k, v in fields.items()) + "end_head\n"
    with open(path, "wb") as f:
        f.write(head.encode().ljust(1024, b" ")
                + pcm.astype("<i2").tobytes())
    return str(path)


def test_decode_equals_read_wav(built, tmp_path):
    rng = np.random.RandomState(0)
    riff = str(tmp_path / "t.wav")
    write_wav(riff, np.clip(0.5 * rng.randn(12345), -1, 1), FS)
    sph = sphere(tmp_path / "t.sph",
                 rng.randint(-30000, 30000, 7777).astype(np.int16))
    for path in (riff, sph):
        got, fs = built.read_wav_native(path)
        ref, fs_ref = read_wav(path)
        assert fs == fs_ref == FS and got.dtype == np.float64
        assert_array_equal(got, ref)


@pytest.mark.parametrize("n", [1, 100, 300, 1000, 16000, 16001, 40960 + 77])
def test_assembly_equals_fill_row(built, tmp_path, monkeypatch, n):
    x = np.clip(0.4 * np.random.RandomState(n).randn(n), -1, 1)
    path = str(tmp_path / "u.wav")
    write_wav(path, x, FS)
    nf = pipeline.frame_count(n)
    L = (pipeline.bucket_frames(nf) - 1) * pipeline.HOP + pipeline.NFFT
    rows = np.zeros((2, L), np.int16)
    nl.reset_call_counts()
    got = pipeline._fill_row(path, rows[0])
    assert nl.call_counts() == {"assemble_utt": 1}
    monkeypatch.setattr(nl, "is_available", lambda: False)
    ref = pipeline._fill_row(path, rows[1])
    assert got == ref == (nf, n)
    assert_array_equal(rows[0], rows[1])


def test_assembly_refuses_bad_input(built, tmp_path):
    empty = str(tmp_path / "e.wav")
    write_wav(empty, np.zeros(0), FS)
    with pytest.raises(IOError):
        built.assemble_utt_native(empty, np.zeros(2048, np.int16))
    other = str(tmp_path / "o.wav")
    write_wav(other, np.zeros(800), 8000)
    with pytest.raises(ValueError, match="sample rate"):
        built.assemble_utt_native(other, np.zeros(2048, np.int16))
    with pytest.raises(ValueError, match="int16"):
        built.assemble_utt_native(other, np.zeros(2048, np.float32))


def test_stfts_match_stft_and_the_jax_natives(built):
    from guided_vae_nmf_tpu.data import native_loader as j_nl

    jax_native = j_nl.is_available()
    rng = np.random.RandomState(1)
    for n in (100, 300, 16000, 16001, 40960 + 77):
        x = 0.3 * rng.randn(n)
        ref = stft(x)
        power = built.stft_power_native(x)
        ref_p = (np.abs(ref) ** 2).astype(np.float32)
        assert power.shape == ref_p.shape and power.dtype == np.float32
        assert_allclose(power, ref_p, rtol=1e-5, atol=1e-7 * ref_p.max())
        cplx = built.stft_complex_native(x)
        assert cplx.shape == ref.shape and cplx.dtype == np.complex64
        assert_allclose(cplx, ref, atol=1e-5 * np.abs(ref).max())
        # the JAX copy reflects once only, so it differs below 513 samples
        if jax_native and n > 1024:
            assert_array_equal(power, j_nl.stft_power_native(x))
            assert_array_equal(cplx, j_nl.stft_complex_native(x))


def test_load_power_matches_the_python_path_and_jax(built, tmp_path):
    from guided_vae_nmf_tpu.data import native_loader as j_nl

    x = np.clip(0.3 * np.random.RandomState(2).randn(20000), -1, 1)
    path = str(tmp_path / "p.wav")
    write_wav(path, x, FS)
    y, _ = read_wav(path)
    y = y[int(0.1 * FS):]
    ref = (np.abs(stft(y / np.max(np.abs(y)))) ** 2).astype(np.float32)
    got = built.load_power_native(path)
    assert got.shape == ref.shape
    assert_allclose(got, ref, rtol=1e-5, atol=1e-7 * ref.max())
    if j_nl.is_available():
        assert_array_equal(got, j_nl.load_power_native(path))


def test_the_kernel_build_takes_only_the_cuda_sources():
    """`_build.build_all` compiles `csrc/*.cu` with nvcc; the C++ loader's
    source sits beside them and is g++'s alone."""
    from guided_vae_nmf_torch import _build

    assert nl.SOURCE.parent == _build.CSRC and nl.SOURCE.exists()
    assert sorted(p.name for p in _build.CSRC.glob("*.cu")) == [
        "em_cost.cu", "lstm_sweep.cu", "mh_chain.cu", "mh_chain_ext.cu",
        "mh_chain_general.cu", "nmf_sums.cu"]


def test_load_mixture_native_on_and_off(built, tmp_path, monkeypatch):
    x = np.clip(0.3 * np.random.RandomState(3).randn(17777), -1, 1)
    write_wav(str(tmp_path / "u_x.wav"), x, FS)
    on = pipeline.load_mixture(str(tmp_path / "u"))
    monkeypatch.setattr(nl, "is_available", lambda: False)
    off = pipeline.load_mixture(str(tmp_path / "u"))
    assert_array_equal(on[0], off[0]) and on[1] == off[1]
    assert on[2].dtype == off[2].dtype == np.complex64
    assert_allclose(on[2], off[2], atol=1e-5 * np.abs(off[2]).max())


def test_enhance_files_native_on_and_off(built, tmp_path, monkeypatch,
                                         capsys):
    """The sweep's output files are the same bytes either way; the native
    run assembles every row natively and prints the stage report."""
    rng = np.random.RandomState(4)
    src = tmp_path / "in"
    src.mkdir()
    files = []
    for j, n in enumerate((9000, 12345)):
        t = np.arange(n) / FS
        s = 0.3 * np.sin(2 * np.pi * 220 * t) * (1 + np.sin(3 * t))
        write_wav(str(src / f"u{j}_x.wav"), s + 0.05 * rng.randn(n), FS)
        files.append(f"u{j}.wav")
    model = load_model(os.path.join(ROOT, "artifacts", "pretrained",
                                    "M2_ibm"), kind="dgm", device="cpu")
    cls = load_model(os.path.join(ROOT, "artifacts", "pretrained",
                                  "classifier_ibm"), kind="classifier",
                     device="cpu")
    cfg = MCEMConfig(niter=1, nsamples_E_step=2, burnin_E_step=1,
                     nsamples_WF=2, burnin_WF=1)
    outs = {}
    for tag in ("on", "off"):
        if tag == "off":
            monkeypatch.setattr(nl, "is_available", lambda: False)
        nl.reset_call_counts()
        pipeline.enhance_files(files, str(src), str(tmp_path / tag), model,
                               classifier=cls, cfg=cfg, verbose=True,
                               device="cpu")
        outs[tag] = nl.call_counts().get("assemble_utt", 0)
        report = capsys.readouterr().out
        for name in ("assemble_wait", "dispatch", "d2h_fetch",
                     "finish_wait", "writer_drain"):
            assert f"\n{name} " in report
        assert "STAGE                      TOTAL(s)    CALLS" in report
    assert outs == {"on": 2, "off": 0}
    names = sorted(os.listdir(tmp_path / "on"))
    assert names == sorted(os.listdir(tmp_path / "off")) and len(names) == 8
    for name in names:
        assert (tmp_path / "on" / name).read_bytes() == \
            (tmp_path / "off" / name).read_bytes(), name
    s, _ = read_wav_int16(str(tmp_path / "on" / "u1_s_est.wav"))
    assert len(s) == 12345
