"""STFT / ISTFT: the port's torch transforms against the JAX package's
device transforms, and its numpy helpers against the originals.

Tolerances: the forward STFT agrees to atol 2e-4 on spectra whose bins
reach ~100 (float32 FFTs of two libraries); waveforms after the masked
ISTFT agree to atol 1e-6. The numpy helpers are copies and must agree
exactly."""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

# the JAX package's dsp namespace exports a function named `stft`
jstft = importlib.import_module("guided_vae_nmf_tpu.dsp.stft")
tstft = importlib.import_module("guided_vae_nmf_torch.dsp.stft")

torch.set_num_threads(2)


def _signals(seed, B=2, n_frames=40):
    rng = np.random.RandomState(seed)
    L = (n_frames - 1) * 256 + 1024
    return rng.uniform(-0.5, 0.5, (B, L)).astype(np.float32)


def test_stft_batch_padded_matches_jax():
    x = _signals(0)
    got = tstft.stft_batch_padded(torch.tensor(x))
    ref = np.asarray(jstft.stft_batch_padded_jax(jnp.asarray(x)))
    assert got.shape == ref.shape and got.dtype == torch.complex64
    assert_allclose(got.numpy(), ref, atol=2e-4, rtol=1e-5)


@pytest.mark.parametrize("n_valid", [40, 29])
def test_istft_masked_matches_jax(n_valid):
    rng = np.random.RandomState(n_valid)
    n = 40
    S_re = rng.randn(2, 513, n).astype(np.float32)
    S_im = rng.randn(2, 513, n).astype(np.float32)
    mask = (np.arange(n)[None] < np.array([[n], [n_valid]])).astype(
        np.float32)
    got = tstft.istft_masked_ri(torch.tensor(S_re), torch.tensor(S_im),
                                torch.tensor(mask))
    for b in range(2):
        ref = np.asarray(jstft.istft_masked_ri_jax(
            jnp.asarray(S_re[b]), jnp.asarray(S_im[b]), jnp.asarray(mask[b])))
        assert_allclose(got[b].numpy(), ref, atol=1e-6, rtol=1e-5)


def test_stft_istft_round_trip_of_an_utterance():
    x = np.random.RandomState(5).uniform(-0.5, 0.5, 9000).astype(np.float32)
    xp, nf = tstft.pad_signal_for_stft(x)
    n_pad = 48
    L = (n_pad - 1) * 256 + 1024
    row = np.zeros((1, L), np.float32)
    row[0, : min(len(xp), L)] = xp[:L]
    mask = torch.zeros(1, n_pad)
    mask[0, :nf] = 1
    X = tstft.stft_batch_padded(torch.tensor(row))
    y = tstft.istft_masked(X, mask)[0, : len(x)].numpy()
    assert_allclose(y, x, atol=2e-6)


@pytest.mark.parametrize("n", [16000, 16128, 16256, 12345, 1024])
def test_numpy_helpers_match_the_originals(n):
    assert tstft.stft_params() == jstft.stft_params()
    assert np.array_equal(tstft.periodic_hann(1024), jstft.periodic_hann(1024))
    assert tstft.frame_count(n) == jstft.frame_count(n)
    assert tstft._end_pad_len(n, 16000, 64e-3, 0.25, 256) == \
        jstft._end_pad_len(n, 16000, 64e-3, 0.25, 256)
    rng = np.random.RandomState(n)
    for x in (rng.uniform(-1, 1, n),
              rng.randint(-2000, 2000, n).astype(np.int16)):
        a, na = tstft.pad_signal_for_stft(x)
        b, nb = jstft.pad_signal_for_stft(x)
        assert na == nb and a.dtype == b.dtype and np.array_equal(a, b)


def test_stft_params_rejects_fractional_windows():
    with pytest.raises(ValueError):
        tstft.stft_params(fs=16000, wlen_sec=64.01e-3)
