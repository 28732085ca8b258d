"""The whole waveform pipeline: the port's `enhance_waveform` against the
JAX package's `_enhance_waveform_jit(use_fused=True)` on the CPU, at
var_RW=0 and full frequency width (F=513) with a small random model.

With the NMF noise model the port starts from JAX's own NMF init,
reproduced from `keys[0]` as `mcem_batch_fused` draws it, through `init=`;
the fixed-noise models (spp, spp2) draw no init, so at var_RW=0 they are
deterministic. Tolerance: PCM16 samples within 2 LSB (float32 STFT/ISTFT
of two FFT libraries, then rounding), packed hard labels equal, soft
labels within 1e-3 (float16)."""

import dataclasses
import os
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from guided_vae_nmf_tpu import profiles as jax_profiles
from guided_vae_nmf_tpu.mcem import MCEMConfig as JaxConfig
from guided_vae_nmf_tpu.models import classifier_init, dgm_init, vae_init
from guided_vae_nmf_tpu.pipeline import _enhance_waveform_jit
from guided_vae_nmf_torch import profiles
from guided_vae_nmf_torch._build import KernelError
from guided_vae_nmf_torch.data import read_wav_int16, write_wav
from guided_vae_nmf_torch.dsp import frame_count, pad_signal_for_stft
from guided_vae_nmf_torch.mcem import MCEMConfig
from guided_vae_nmf_torch.models import module_from_params
from guided_vae_nmf_torch.pipeline import (
    _packbits_bands,
    bucket_frames,
    enhance_files,
    enhance_to_audio,
    enhance_waveform,
    plan_batches,
)
from guided_vae_nmf_torch.train import load_norm_stats

torch.set_num_threads(2)

F, L, H, K = 513, 8, 16, 3
SMALL = dict(niter=2, nsamples_E_step=2, burnin_E_step=1, nsamples_WF=2,
             burnin_WF=1, nmf_rank=K, var_RW=0.0)
CLS_DIR = os.path.join(os.path.dirname(__file__), "..", "artifacts",
                       "pretrained", "classifier_ibm")


def _mixtures(seed, seconds):
    """int16 tone-plus-noise signals of the given lengths."""
    rng = np.random.RandomState(seed)
    out = []
    for sec in seconds:
        t = np.arange(int(sec * 16000)) / 16000
        s = np.sin(2 * np.pi * 180 * t) * (0.5 - 0.5 * np.cos(8 * np.pi * t))
        x = 0.3 * s + 0.05 * rng.randn(len(t))
        out.append(np.round(x * 32767).astype(np.int16))
    return out


def _batch(xs):
    padded = [pad_signal_for_stft(x) for x in xs]
    n_pad = bucket_frames(max(nf for _, nf in padded))
    Lw = (n_pad - 1) * 256 + 1024
    x_b = np.zeros((len(xs), Lw), np.int16)
    mask = np.zeros((len(xs), n_pad), np.float32)
    for j, (xp, nf) in enumerate(padded):
        x_b[j, : min(len(xp), Lw)] = xp[:Lw]
        mask[j, :nf] = 1.0
    return x_b, mask


def _jax_nmf_init(keys, B, N, eps=1e-8):
    """The NMF init `mcem_batch_fused` draws from the batch's first key."""
    k_init, _ = jax.random.split(keys[0])
    k_w, k_h = jax.random.split(k_init)
    W0 = jnp.maximum(jax.random.uniform(k_w, (B, F, K)), eps)
    H0 = jnp.maximum(jax.random.uniform(k_h, (B, K, N)), eps)
    return {"W": np.asarray(W0), "H": np.asarray(H0)}


@pytest.mark.parametrize("label_mode", ["dnn", "ones", "zeros", "host",
                                        "none"])
def test_enhance_waveform_matches_jax(label_mode):
    rng = np.random.RandomState(0)
    x_b, mask = _batch(_mixtures(1, (1.6, 1.1)))
    B, N = mask.shape
    if label_mode == "none":
        tree = vae_init(jax.random.PRNGKey(0), [F, L, [H, H]])
    else:
        tree = dgm_init(jax.random.PRNGKey(0), [F, F, L, [H, H]])
    cls = classifier_init(jax.random.PRNGKey(1), [F, [H, H], F])
    mean, std = load_norm_stats(CLS_DIR)
    y_in = (rng.uniform(size=(B, F, N)) > 0.5).astype(np.float32)
    keys = jax.random.split(jax.random.PRNGKey(2), B)
    dnn = label_mode == "dnn"
    ref = _enhance_waveform_jit(
        tree, jnp.asarray(x_b), None,
        jnp.asarray(y_in) if label_mode == "host" else None,
        cls if dnn else None,
        jnp.asarray(mean, jnp.float32) if dnn else None,
        jnp.asarray(std, jnp.float32) if dnn else None,
        jnp.asarray(mask), keys, JaxConfig(**SMALL), use_fused=True,
        label_mode=label_mode)
    got = enhance_waveform(
        module_from_params(tree), x_b, mask, MCEMConfig(**SMALL),
        classifier=module_from_params(cls) if dnn else None,
        mean=mean if dnn else None, std=std if dnn else None,
        y_in=y_in if label_mode == "host" else None, label_mode=label_mode,
        init={k: torch.tensor(v) for k, v in
              _jax_nmf_init(keys, B, N).items()},
        device="cpu")
    ref = [None if r is None else np.asarray(r) for r in ref]
    got = [None if g is None else g.numpy() for g in got]
    for i in (0, 1):     # s, n as PCM16
        assert got[i].dtype == np.int16 and got[i].shape == ref[i].shape
        diff = np.abs(got[i].astype(np.int32) - ref[i].astype(np.int32))
        assert diff.max() <= 2, diff.max()
    assert (got[2] is None) == (ref[2] is None)
    if got[2] is not None:
        np.testing.assert_allclose(got[2].astype(np.float32),
                                   ref[2].astype(np.float32), atol=1e-3)
    assert (got[3] is None) == (ref[3] is None)
    if got[3] is not None:
        assert np.array_equal(got[3], ref[3])
    assert got[4].all() and ref[4].all()


def test_packbits_matches_numpy():
    y = (np.random.RandomState(3).uniform(size=(2, 13, 5)) > 0.5).astype(
        np.float32)
    packed = _packbits_bands(torch.tensor(y)).numpy()
    assert packed.shape == (2, 2, 5)
    assert np.array_equal(np.unpackbits(packed, axis=1)[:, :13], y)


def test_plan_batches_buckets_and_seeds():
    paths = [f"u{i}.wav" for i in range(5)]
    frames = [100, 300, 120, 700, 90]
    plan = plan_batches(paths, frames, batch_size=2)
    assert [p for p, _, _ in plan] == [["u0.wav", "u2.wav"], ["u4.wav"],
                                       ["u1.wav"], ["u3.wav"]]
    assert [n for _, n, _ in plan] == [128, 128, 384, 768]
    seeds = {p[0]: s[0] for p, _, s in plan}
    again = plan_batches(paths[::-1], frames[::-1], batch_size=2, seed=0)
    assert len(again) == len(plan) and seeds["u0.wav"] == plan[0][2][0]


def test_enhance_files_writes_consistent_outputs(tmp_path):
    tree = dgm_init(jax.random.PRNGKey(4), [F, F, L, [H, H]])
    cls = classifier_init(jax.random.PRNGKey(5), [F, [H, H], F])
    mean, std = load_norm_stats(CLS_DIR)
    src, dst = tmp_path / "in", tmp_path / "out"
    src.mkdir()
    xs = _mixtures(6, (1.2, 0.7, 1.3))
    files = []
    for j, x in enumerate(xs):
        write_wav(str(src / f"u{j}_x.wav"), x, 16000)
        files.append(f"u{j}.wav")
    res = enhance_files(files, str(src), str(dst), module_from_params(tree),
                        classifier=module_from_params(cls), mean=mean,
                        std=std, cfg=MCEMConfig(**{**SMALL, "var_RW": 0.01}),
                        device="cpu")
    assert res.n_processed == 3 and res.n_skipped == 0
    for j, x in enumerate(xs):
        s, _ = read_wav_int16(str(dst / f"u{j}_s_est.wav"))
        n, _ = read_wav_int16(str(dst / f"u{j}_n_est.wav"))
        assert len(s) == len(x) and np.any(s != x)
        assert np.array_equal(np.clip(x.astype(np.int32) - s, -32768, 32767),
                              n)
        yh = np.load(dst / f"u{j}_ibm_hard_est.npy")
        ys = np.load(dst / f"u{j}_ibm_soft_est.npy")
        assert yh.shape == ys.shape == (F, frame_count(len(x)))
        assert yh.dtype == np.uint8 and ys.dtype == np.float16
    again = enhance_files(files, str(src), str(dst),
                          module_from_params(tree), classifier=None,
                          skip_existing=True, device="cpu")
    assert again.n_processed == 0 and again.n_skipped == 3


def test_enhance_files_retries_per_utterance(tmp_path, monkeypatch):
    """A failed batch is retried one utterance at a time; an utterance that
    fails again is written as mixture passthrough with zero labels."""
    import guided_vae_nmf_torch.pipeline as pl

    tree = dgm_init(jax.random.PRNGKey(4), [F, F, L, [H, H]])
    src, dst = tmp_path / "in", tmp_path / "out"
    src.mkdir()
    xs = _mixtures(7, (1.0, 1.05))
    for j, x in enumerate(xs):
        write_wav(str(src / f"u{j}_x.wav"), x, 16000)
    real = pl.enhance_waveform
    calls = []

    def flaky(model, x_pad, mask, *a, **kw):
        calls.append(x_pad.shape[0])
        # rows start with the mixture after the 512-sample reflect lead-in
        if x_pad.shape[0] > 1 or np.array_equal(x_pad[0, 512:1512],
                                                xs[1][:1000]):
            raise RuntimeError("injected failure")
        return real(model, x_pad, mask, *a, **kw)

    monkeypatch.setattr(pl, "enhance_waveform", flaky)
    res = enhance_files(["u0.wav", "u1.wav"], str(src), str(dst),
                        module_from_params(tree), classif_type="ones",
                        cfg=MCEMConfig(**SMALL), device="cpu")
    assert res.n_processed == 2 and calls == [2, 1, 1]
    s0, _ = read_wav_int16(str(dst / "u0_s_est.wav"))
    s1, _ = read_wav_int16(str(dst / "u1_s_est.wav"))
    n1, _ = read_wav_int16(str(dst / "u1_n_est.wav"))
    assert np.any(s0 != xs[0])
    assert np.array_equal(s1, xs[1]) and not np.any(n1)
    assert not np.any(np.load(dst / "u1_ibm_hard_est.npy"))


def _one_spectrogram(seed):
    from guided_vae_nmf_torch.dsp.stft import stft_batch_padded

    x_b, mask = _batch(_mixtures(seed, (0.9,)))
    X = stft_batch_padded(torch.tensor(x_b.astype(np.float32) / 32768))
    X_tf = X[0, :, :int(mask.sum())].numpy()
    return X_tf, (np.abs(X_tf) > 0.01).astype(np.float32)


def test_enhance_to_audio_runs():
    tree = dgm_init(jax.random.PRNGKey(7), [F, F, L, [H, H]])
    X_tf, y = _one_spectrogram(8)
    s, n = enhance_to_audio(module_from_params(tree), [X_tf], [14400], [y],
                            cfg=MCEMConfig(**SMALL), device="cpu")
    assert s[0].shape == n[0].shape == (14400,)
    assert np.isfinite(s[0]).all() and np.isfinite(n[0]).all()


def test_enhance_to_audio_passes_the_noise_model():
    model = module_from_params(dgm_init(jax.random.PRNGKey(7),
                                        [F, F, L, [H, H]]))
    X_tf, y = _one_spectrogram(8)
    s, n = enhance_to_audio(model, [X_tf], [14400], [y],
                            cfg=MCEMConfig(**SMALL, noise_gain=True),
                            noise_model="spp2", device="cpu")
    assert np.isfinite(s[0]).all() and np.isfinite(n[0]).all()
    s_nmf, _ = enhance_to_audio(model, [X_tf], [14400], [y],
                                cfg=MCEMConfig(**SMALL), device="cpu")
    assert not np.allclose(s[0], s_nmf[0])


@pytest.mark.parametrize("kw", [dict(label_mode="oracle"),
                                dict(noise_model="hybrid")])
def test_unported_options_raise(kw):
    tree = dgm_init(jax.random.PRNGKey(9), [F, F, L, [H, H]])
    x_b, mask = _batch(_mixtures(9, (0.5,)))
    with pytest.raises(NotImplementedError):
        enhance_waveform(module_from_params(tree), x_b, mask,
                         MCEMConfig(**SMALL), device="cpu", **kw)


def _compare(got, ref):
    """PCM16 within 2 LSB, labels as the module docstring states."""
    ref = [None if r is None else np.asarray(r) for r in ref]
    got = [None if g is None else g.numpy() for g in got]
    for i in (0, 1):     # s, n as PCM16
        assert got[i].dtype == np.int16 and got[i].shape == ref[i].shape
        diff = np.abs(got[i].astype(np.int32) - ref[i].astype(np.int32))
        assert diff.max() <= 2, diff.max()
    for i in (2, 3):
        assert (got[i] is None) == (ref[i] is None)
    if got[2] is not None:
        np.testing.assert_allclose(got[2].astype(np.float32),
                                   ref[2].astype(np.float32), atol=1e-3)
    if got[3] is not None:
        assert np.array_equal(got[3], ref[3])
    assert got[4].all() and ref[4].all()
    return got


@pytest.mark.parametrize("noise_model,label_mode,gain,bands,soft", [
    ("spp", "dnn", True, 2, True),       # the impulse-noise settings
    ("spp2", "dnn", True, 1, True),      # the real-noise settings
    ("spp", "timo", False, 1, False),
    ("nmf", "timo", False, 1, True),
])
def test_fixed_noise_and_timo_match_jax(noise_model, label_mode, gain,
                                        bands, soft):
    x_b, mask = _batch(_mixtures(11, (1.6, 1.1)))
    B, N = mask.shape
    tree = dgm_init(jax.random.PRNGKey(0), [F, F, L, [H, H]])
    cls = classifier_init(jax.random.PRNGKey(1), [F, [H, H], F])
    mean, std = load_norm_stats(CLS_DIR)
    keys = jax.random.split(jax.random.PRNGKey(2), B)
    dnn = label_mode == "dnn"
    over = dict(noise_gain=gain, noise_gain_bands=bands)
    ref = _enhance_waveform_jit(
        tree, jnp.asarray(x_b), None, None, cls if dnn else None,
        jnp.asarray(mean, jnp.float32) if dnn else None,
        jnp.asarray(std, jnp.float32) if dnn else None,
        jnp.asarray(mask), keys, JaxConfig(**SMALL, **over), use_fused=True,
        noise_model=noise_model, label_mode=label_mode, soft_guidance=soft)
    init = None
    if noise_model == "nmf":
        init = {k: torch.tensor(v)
                for k, v in _jax_nmf_init(keys, B, N).items()}
    got = enhance_waveform(
        module_from_params(tree), x_b, mask, MCEMConfig(**SMALL, **over),
        classifier=module_from_params(cls) if dnn else None,
        mean=mean if dnn else None, std=std if dnn else None,
        label_mode=label_mode, noise_model=noise_model, soft_guidance=soft,
        init=init, device="cpu")
    got = _compare(got, ref)
    if label_mode == "timo":
        assert got[2].dtype == np.float16 and got[2].shape == (B, F, N)


def _write_mixtures(src, seed, seconds):
    src.mkdir()
    xs = _mixtures(seed, seconds)
    files = []
    for j, x in enumerate(xs):
        write_wav(str(src / f"u{j}_x.wav"), x, 16000)
        files.append(f"u{j}.wav")
    return xs, files


def test_enhance_files_profile_equals_explicit_settings(tmp_path):
    tree = module_from_params(dgm_init(jax.random.PRNGKey(4),
                                       [F, F, L, [H, H]]))
    cls = module_from_params(classifier_init(jax.random.PRNGKey(5),
                                             [F, [H, H], F]))
    mean, std = load_norm_stats(CLS_DIR)
    _, files = _write_mixtures(tmp_path / "in", 12, (1.2, 0.7))
    common = dict(classifier=cls, mean=mean, std=std, device="cpu")
    cfg = MCEMConfig(**{**SMALL, "var_RW": 0.01})
    enhance_files(files, str(tmp_path / "in"), str(tmp_path / "a"), tree,
                  cfg=cfg, profile="impulse-noise", **common)
    enhance_files(files, str(tmp_path / "in"), str(tmp_path / "b"), tree,
                  cfg=MCEMConfig(**{**SMALL, "var_RW": 0.01,
                                    "noise_gain": True,
                                    "noise_gain_bands": 2}),
                  noise_model="spp", soft_guidance=True, **common)
    names = sorted(p.name for p in (tmp_path / "a").iterdir())
    assert len(names) == 8            # s, n, soft and hard labels per file
    for name in names:
        assert (tmp_path / "a" / name).read_bytes() == \
            (tmp_path / "b" / name).read_bytes(), name
    # the profile's noise model really ran: it differs from 'nmf'
    enhance_files(files, str(tmp_path / "in"), str(tmp_path / "c"), tree,
                  cfg=cfg, **common)
    assert (tmp_path / "a" / "u0_s_est.wav").read_bytes() != \
        (tmp_path / "c" / "u0_s_est.wav").read_bytes()


def test_profiles_equal_the_jax_package():
    assert profiles.PROFILE_NAMES == jax_profiles.PROFILE_NAMES
    for name, prof in jax_profiles.PROFILES.items():
        assert dataclasses.asdict(profiles.PROFILES[name]) == \
            dataclasses.asdict(prof)
    assert profiles.offline_settings("real-noise") == ("spp2", True)
    cfg = profiles.apply_profile_cfg(MCEMConfig(), "impulse-noise")
    assert cfg.noise_gain and cfg.noise_gain_bands == 2
    with pytest.raises(ValueError, match="streaming-only"):
        profiles.offline_settings("streaming-192ms")
    with pytest.raises(ValueError, match="unknown profile"):
        profiles.get_profile("loud")


def test_enhance_files_raises_kernel_errors(tmp_path, monkeypatch):
    """A kernel that does not build or launch fails the sweep: no retry,
    no passthrough files."""
    import guided_vae_nmf_torch.pipeline as pl

    tree = module_from_params(dgm_init(jax.random.PRNGKey(4),
                                       [F, F, L, [H, H]]))
    _, files = _write_mixtures(tmp_path / "in", 13, (1.0, 1.05))
    calls = []

    def broken(*a, **kw):
        calls.append(1)
        raise KernelError("mh_chain kernel: CUDA error 700")

    monkeypatch.setattr(pl, "enhance_waveform", broken)
    with pytest.raises(KernelError):
        enhance_files(files, str(tmp_path / "in"), str(tmp_path / "out"),
                      tree, classif_type="ones", cfg=MCEMConfig(**SMALL),
                      device="cpu")
    assert calls == [1]
    assert not list(pathlib.Path(tmp_path).rglob("*_s_est.wav"))


@pytest.mark.parametrize("kw", [dict(noise_model="spp3"),
                                dict(noise_model="nmf", noise_gain=True)])
def test_bad_noise_model_settings_raise(kw):
    tree = dgm_init(jax.random.PRNGKey(9), [F, F, L, [H, H]])
    x_b, mask = _batch(_mixtures(9, (0.5,)))
    cfg = MCEMConfig(**SMALL, noise_gain=kw.pop("noise_gain", False))
    with pytest.raises(ValueError):
        enhance_waveform(module_from_params(tree), x_b, mask, cfg,
                         device="cpu", **kw)
