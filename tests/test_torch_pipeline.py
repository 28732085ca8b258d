"""The whole waveform pipeline: the port's `enhance_waveform` against the
JAX package's `_enhance_waveform_jit(use_fused=True)` on the CPU, at
var_RW=0 and full frequency width (F=513) with a small random model.

With the NMF noise model the port starts from JAX's own NMF init,
reproduced from `keys[0]` as `mcem_batch_fused` draws it, through `init=`;
the fixed-noise models (spp, spp2) draw no init, so at var_RW=0 they are
deterministic. Tolerance: PCM16 samples within 2 LSB (float32 STFT/ISTFT
of two FFT libraries, then rounding), packed hard labels equal, soft
labels within 1e-3 (float16).

Also held against the JAX package: oracle labels from clean tracks, the
eager engine (`engine="xla"`, against `use_fused=False`, with the spp
noise model at var_RW=0), `enhance_batch` on both engines, the host
helpers `make_labels` (every branch) and `load_mixture`, and the
Wiener-DNN baseline (`_wiener_waveform`, `enhance_files_wiener`) with the
shipped `wiener` checkpoint (PCM16 within 2 LSB, masks within 1e-3)."""

import dataclasses
import os
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from guided_vae_nmf_tpu import pipeline as jax_pipeline
from guided_vae_nmf_tpu import profiles as jax_profiles
from guided_vae_nmf_tpu.mcem import MCEMConfig as JaxConfig
from guided_vae_nmf_tpu.models import classifier_init, dgm_init, vae_init
from guided_vae_nmf_tpu.pipeline import _enhance_waveform_jit
from guided_vae_nmf_tpu.train import load_params as jax_load_params
from guided_vae_nmf_torch import profiles
from guided_vae_nmf_torch._build import KernelError
from guided_vae_nmf_torch.data import read_wav_int16, write_wav
from guided_vae_nmf_torch.dsp import frame_count, pad_signal_for_stft
from guided_vae_nmf_torch.mcem import MCEMConfig
from guided_vae_nmf_torch.models import module_from_params
from guided_vae_nmf_torch.pipeline import (
    _packbits_bands,
    _use_fused,
    _wiener_waveform,
    bucket_frames,
    enhance_batch,
    enhance_files,
    enhance_files_wiener,
    enhance_to_audio,
    enhance_waveform,
    load_mixture,
    make_labels,
    plan_batches,
)
from guided_vae_nmf_torch.train import load_model, load_norm_stats

torch.set_num_threads(2)

F, L, H, K = 513, 8, 16, 3
SMALL = dict(niter=2, nsamples_E_step=2, burnin_E_step=1, nsamples_WF=2,
             burnin_WF=1, nmf_rank=K, var_RW=0.0)
CLS_DIR = os.path.join(os.path.dirname(__file__), "..", "artifacts",
                       "pretrained", "classifier_ibm")
WIENER_DIR = os.path.join(os.path.dirname(__file__), "..", "artifacts",
                          "pretrained", "wiener")


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


def _clean_and_mixtures(seed, seconds):
    """int16 (clean, mixture) pairs: the tone of :func:`_mixtures` alone,
    and with its noise."""
    rng = np.random.RandomState(seed)
    out = []
    for sec in seconds:
        t = np.arange(int(sec * 16000)) / 16000
        s = 0.3 * np.sin(2 * np.pi * 180 * t) * (
            0.5 - 0.5 * np.cos(8 * np.pi * t))
        x = s + 0.05 * rng.randn(len(t))
        out.append((np.round(s * 32767).astype(np.int16),
                    np.round(x * 32767).astype(np.int16)))
    return out


@pytest.mark.parametrize("kw", [dict(label_mode="oracle"),
                                dict(noise_model="hybrid"),
                                dict(engine="xla")])
def test_formerly_refused_options_run(kw):
    """Oracle labels, the hybrid noise model and the eager engine run (they
    raised NotImplementedError before the eager engine was ported)."""
    tree = dgm_init(jax.random.PRNGKey(9), [F, F, L, [H, H]])
    pairs = _clean_and_mixtures(9, (0.5,))
    x_b, mask = _batch([x for _, x in pairs])
    s_b, _ = _batch([s for s, _ in pairs])
    out = enhance_waveform(module_from_params(tree), x_b, mask,
                           MCEMConfig(**SMALL), device="cpu", s_pad=s_b,
                           **{"label_mode": "ones", **kw})
    assert out[0].shape == (1, x_b.shape[1] - 1024)
    assert out[4].all()
    if "label_mode" in kw:
        assert out[3].shape == (1, 65, mask.shape[1])
        assert np.unpackbits(out[3].numpy(), axis=1).any()


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


@pytest.mark.parametrize("target", ["ibm", "vad"])
def test_oracle_labels_match_jax(target):
    """label_mode='oracle' from clean tracks, from JAX's NMF init: the
    Lorenz-quantile labels equal JAX's and the PCM16 within 2 LSB."""
    pairs = _clean_and_mixtures(1, (1.6, 1.1))
    x_b, mask = _batch([x for _, x in pairs])
    s_b, _ = _batch([s for s, _ in pairs])
    B, N = mask.shape
    y_dim = 1 if target == "vad" else F
    tree = dgm_init(jax.random.PRNGKey(0), [F, y_dim, L, [H, H]])
    keys = jax.random.split(jax.random.PRNGKey(2), B)
    ref = _enhance_waveform_jit(
        tree, jnp.asarray(x_b), jnp.asarray(s_b), None, None, None, None,
        jnp.asarray(mask), keys, JaxConfig(**SMALL), use_fused=True,
        label_mode="oracle", target=target)
    got = enhance_waveform(
        module_from_params(tree), x_b, mask, MCEMConfig(**SMALL), s_pad=s_b,
        label_mode="oracle", target=target,
        init={k: torch.tensor(v) for k, v in
              _jax_nmf_init(keys, B, N).items()}, device="cpu")
    got = _compare(got, ref)
    assert got[2] is None and got[3].shape == (B, 1 if target == "vad"
                                               else 65, N)


def test_eager_engine_matches_jax_xla_engine():
    """engine='xla' against `use_fused=False` with the spp noise model at
    var_RW=0, where neither engine draws anything that matters."""
    x_b, mask = _batch(_mixtures(14, (1.6, 1.1)))
    tree = dgm_init(jax.random.PRNGKey(0), [F, F, L, [H, H]])
    y_in = (np.random.RandomState(15).uniform(size=(2, F, mask.shape[1]))
            > 0.5).astype(np.float32)
    keys = jax.random.split(jax.random.PRNGKey(2), 2)
    ref = _enhance_waveform_jit(
        tree, jnp.asarray(x_b), None, jnp.asarray(y_in), None, None, None,
        jnp.asarray(mask), keys, JaxConfig(**SMALL), use_fused=False,
        noise_model="spp", label_mode="host")
    got = enhance_waveform(
        module_from_params(tree), x_b, mask, MCEMConfig(**SMALL), y_in=y_in,
        label_mode="host", noise_model="spp", engine="xla", device="cpu")
    _compare(got, ref)


def _spectrograms(seed, seconds):
    from guided_vae_nmf_torch.dsp import stft

    return [stft(x.astype(np.float64) / 32768) for x in
            _mixtures(seed, seconds)]


@pytest.mark.parametrize("engine", ["fused", "xla"])
def test_enhance_batch_matches_jax(engine):
    """enhance_batch on either engine against the JAX package's, with the
    spp noise model at var_RW=0: S_hat / N_hat within 2e-5 + 2e-4 |X|."""
    X_tfs = _spectrograms(16, (1.0, 0.6))
    ys = [(np.abs(X) > 0.02).astype(np.float32) for X in X_tfs]
    tree = dgm_init(jax.random.PRNGKey(0), [F, F, L, [H, H]])
    ref = jax_pipeline.enhance_batch(
        tree, X_tfs, ys, cfg=JaxConfig(**SMALL), noise_model="spp",
        engine=engine, return_masks=True)
    got = enhance_batch(module_from_params(tree), X_tfs, ys,
                        cfg=MCEMConfig(**SMALL), noise_model="spp",
                        engine=engine, return_masks=True, device="cpu")
    for a_list, r_list in zip(got[:2], ref[:2]):
        for a, r, X in zip(a_list, r_list, X_tfs):
            assert a.shape == X.shape
            np.testing.assert_allclose(np.abs(a - r), 0,
                                       atol=2e-5 + 2e-4 * np.abs(X).max())
    np.testing.assert_allclose(got[2]["g"].numpy(), np.asarray(ref[2]["g"]),
                               rtol=2e-4, atol=2e-5)


def test_enhance_batch_hybrid_is_the_eager_engine():
    """The hybrid noise model runs the eager engine whatever `engine`
    says: its result equals mcem_m2_batch's at Vb = W H + the SPP PSD."""
    from guided_vae_nmf_torch.mcem.engine import mcem_m2_batch
    from guided_vae_nmf_torch.mcem.spp import spp_track
    from guided_vae_nmf_torch.pipeline import _pad_batch

    X_tfs = _spectrograms(17, (0.8, 0.5))
    ys = [(np.abs(X) > 0.02).astype(np.float32) for X in X_tfs]
    model = module_from_params(dgm_init(jax.random.PRNGKey(1),
                                        [F, F, L, [H, H]]))
    cfg = MCEMConfig(**{**SMALL, "var_RW": 0.01})
    outs = [enhance_batch(model, X_tfs, ys, seeds=[5, 6], cfg=cfg,
                          noise_model="hybrid", engine=e, return_masks=True,
                          device="cpu")[2] for e in ("fused", "xla")]
    _, X_p, mask, y_b = _pad_batch(X_tfs, ys, 128)
    X_p = torch.tensor(X_p)
    Vb = torch.clamp_min(spp_track(X_p)[0], 1e-6)
    ref = mcem_m2_batch(model, X_p, torch.tensor(mask), torch.tensor(y_b),
                        [5, 6], cfg, update_nmf=True, Vb_fixed=Vb)
    for out in outs:
        for k in ("WFs", "W", "H", "g"):
            assert torch.equal(out[k], ref[k]), k


def test_use_fused_routes_the_engines():
    model = module_from_params(dgm_init(jax.random.PRNGKey(1),
                                        [F, F, L, [H, 24, H]]))
    assert _use_fused("fused", model, 100) is True
    assert _use_fused("xla", model, 128) is False
    # on the CPU the plain versions take any decoder: 'auto' stays fused
    assert _use_fused("auto", model, 100) is True
    with pytest.raises(ValueError, match="engine"):
        _use_fused("eager", model, 128)


def _write_pairs(src, pairs):
    src.mkdir()
    files = []
    for j, (s, x) in enumerate(pairs):
        write_wav(str(src / f"u{j}_x.wav"), x, 16000)
        write_wav(str(src / f"u{j}_s.wav"), s, 16000)
        files.append(f"u{j}.wav")
    return files


def test_make_labels_and_load_mixture_match_jax(tmp_path):
    pairs = _clean_and_mixtures(18, (0.9,))
    files = _write_pairs(tmp_path / "in", pairs)
    base = str(tmp_path / "in" / os.path.splitext(files[0])[0])
    x_t, T, X_tf = load_mixture(base)
    jx_t, jT, jX_tf = jax_pipeline.load_mixture(base)
    assert T == jT == len(pairs[0][1])
    np.testing.assert_allclose(x_t, jx_t, atol=1e-7)
    np.testing.assert_allclose(X_tf, jX_tf, rtol=1e-4, atol=1e-5)
    X_power = (np.abs(jX_tf) ** 2).astype(np.float32)
    cls = classifier_init(jax.random.PRNGKey(5), [F, [H, H], F])
    mean, std = load_norm_stats(CLS_DIR)
    for classif_type in ("dnn", "oracle", "timo", "ones", "zeros"):
        for target in ("ibm", "vad"):
            if classif_type == "dnn" and target == "vad":
                continue            # the IBM classifier has 513 outputs
            kw = dict(s_path=base + "_s.wav", mean=mean, std=std,
                      target=target)
            got = make_labels(classif_type, X_power,
                              classifier=module_from_params(cls), **kw)
            ref = jax_pipeline.make_labels(classif_type, X_power,
                                           classifier_params=cls, **kw)
            for g, r in zip(got, ref):
                assert g.shape == r.shape, (classif_type, target)
                np.testing.assert_allclose(g, np.asarray(r), atol=1e-5,
                                           err_msg=classif_type)
    with pytest.raises(ValueError, match="classif_type"):
        make_labels("oracel", X_power)


def test_enhance_files_oracle_reads_the_clean_tracks(tmp_path,
                                                     monkeypatch):
    """classif_type='oracle': each batch and the per-utterance retry carry
    the clean tracks; the written hard labels are the oracle IBM of
    `<utt>_s.wav` (make_labels on the host)."""
    import guided_vae_nmf_torch.pipeline as pl

    tree = module_from_params(dgm_init(jax.random.PRNGKey(4),
                                       [F, F, L, [H, H]]))
    pairs = _clean_and_mixtures(19, (1.0, 1.05))
    files = _write_pairs(tmp_path / "in", pairs)
    real = pl.enhance_waveform
    seen = []

    def flaky(model, x_pad, mask, *a, **kw):
        seen.append(kw["s_pad"].shape[0])
        if x_pad.shape[0] > 1:
            raise RuntimeError("injected failure")
        return real(model, x_pad, mask, *a, **kw)

    monkeypatch.setattr(pl, "enhance_waveform", flaky)
    res = enhance_files(files, str(tmp_path / "in"), str(tmp_path / "out"),
                        tree, classif_type="oracle", cfg=MCEMConfig(**SMALL),
                        device="cpu")
    assert res.n_processed == 2 and seen == [2, 1, 1]
    for j, (s, x) in enumerate(pairs):
        base = tmp_path / "in" / f"u{j}"
        _, yh_ref = make_labels(
            "oracle", None, s_path=str(base) + "_s.wav")
        yh = np.load(tmp_path / "out" / f"u{j}_ibm_hard_est.npy")
        assert yh.shape == yh_ref.shape
        assert (yh != yh_ref).sum() <= 1
        out, _ = read_wav_int16(str(tmp_path / "out" / f"u{j}_s_est.wav"))
        assert len(out) == len(x) and np.any(out != x)


def _wiener_batch():
    pairs = _clean_and_mixtures(20, (1.3, 0.8))
    return _batch([x for _, x in pairs])


def test_wiener_waveform_matches_jax():
    """The shipped Wiener-DNN checkpoint through the port and through
    `_wiener_waveform_jit`: PCM16 within 2 LSB, masks within 1e-3."""
    x_b, mask = _wiener_batch()
    model = load_model(WIENER_DIR, kind="classifier", device="cpu")
    mean, std = load_norm_stats(WIENER_DIR)
    tree = jax_load_params(
        [os.path.join(WIENER_DIR, f) for f in os.listdir(WIENER_DIR)
         if f.endswith(".ckpt.npz")][0], static={"batch_norm": False})
    ref = jax_pipeline._wiener_waveform_jit(
        tree, jnp.asarray(x_b), jnp.asarray(mean, jnp.float32),
        jnp.asarray(std, jnp.float32), jnp.asarray(mask))
    s, m = _wiener_waveform(model, x_b, mean, std, mask)
    assert s.dtype == torch.int16 and m.dtype == torch.float16
    diff = np.abs(s.numpy().astype(np.int32) - np.asarray(ref[0]))
    assert s.shape == ref[0].shape and diff.max() <= 2, diff.max()
    np.testing.assert_allclose(m.numpy().astype(np.float32),
                               np.asarray(ref[1]).astype(np.float32),
                               atol=1e-3)
    assert 0.05 < float(m.float().mean()) < 0.95


def test_enhance_files_wiener_matches_jax(tmp_path):
    pairs = _clean_and_mixtures(21, (1.3, 0.8, 2.1))
    files = _write_pairs(tmp_path / "in", pairs)
    model = load_model(WIENER_DIR, kind="classifier", device="cpu")
    mean, std = load_norm_stats(WIENER_DIR)
    tree = jax_load_params(
        [os.path.join(WIENER_DIR, f) for f in os.listdir(WIENER_DIR)
         if f.endswith(".ckpt.npz")][0], static={"batch_norm": False})
    enhance_files_wiener(files, str(tmp_path / "in"), str(tmp_path / "a"),
                         model, mean=mean, std=std, batch_size=2,
                         device="cpu")
    jax_pipeline.enhance_files_wiener(files, str(tmp_path / "in"),
                                      str(tmp_path / "b"), tree, mean=mean,
                                      std=std, batch_size=2)
    for j, (_, x) in enumerate(pairs):
        s_a, _ = read_wav_int16(str(tmp_path / "a" / f"u{j}_s_est.wav"))
        s_b, _ = read_wav_int16(str(tmp_path / "b" / f"u{j}_s_est.wav"))
        assert len(s_a) == len(s_b) == len(x)
        assert np.abs(s_a.astype(np.int32) - s_b).max() <= 2
        m_a = np.load(tmp_path / "a" / f"u{j}_wiener_mask.npy")
        m_b = np.load(tmp_path / "b" / f"u{j}_wiener_mask.npy")
        assert m_a.dtype == np.float32 and m_a.shape == m_b.shape
        np.testing.assert_allclose(m_a, m_b, atol=1e-3)
