"""The supervision targets (`guided_vae_nmf_torch/dsp/targets.py`) against
the JAX package's `dsp/targets.py` on the CPU.

- The numpy targets are the port's own copies: equal to JAX's outputs.
- The tensor IBM / VAD against `clean_speech_IBM_jax` / `clean_speech_VAD_jax`
  on both Lorenz-threshold paths: the sort at (513, 128) and (1, 300), and
  the bisection at (513, 2048), one row of 2^20 elements or more. The
  thresholds come from sums taken in another order and precision (the
  port's sort path sums in float64), so an element whose side of the
  quantile depends on their rounding may differ: at most one crossing
  element a row, the tolerance `targets.py` states for its own two paths.
  Cases: speech-like power (clean speech is what the oracle labels read),
  power with long tie runs at the threshold, and an all-zero row (no
  element below the quantile).
- The path choice looks at one row's size, as JAX's does under `vmap`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from guided_vae_nmf_tpu.dsp import targets as jt
from guided_vae_nmf_torch.dsp import stft as tt_stft
from guided_vae_nmf_torch.dsp import targets as tt

torch.set_num_threads(2)


def _speech_power(rng, N):
    """(513, N) float32 power of a speech-like signal: a harmonic tone with
    a gliding f0, spectral tilt and syllable-rate gating over a little
    noise, through the host STFT."""
    t = np.arange((N - 1) * 256) / 16000
    f0 = rng.uniform(100, 200) * (1 + 0.1 * np.sin(2 * np.pi * 0.4 * t))
    phase = 2 * np.pi * np.cumsum(f0) / 16000
    s = sum(np.sin(k * phase) / k for k in range(1, 25))
    s *= 0.5 - 0.5 * np.cos(2 * np.pi * rng.uniform(3, 5) * t)
    s += 0.01 * rng.randn(len(t))
    return (np.abs(tt_stft(s)) ** 2).astype(np.float32)[:, :N]


def _power(kind, rows, F, N, seed):
    """(rows, F, N) float32 power: 'speech' (speech-like spectrograms),
    'ties' (few distinct values, long tie runs at the threshold), 'zeros'
    (the last row all zero, the others speech-like)."""
    rng = np.random.RandomState(seed)
    if kind == "ties":
        return rng.randint(0, 6, (rows, F, N)).astype(np.float32) ** 2
    p = np.stack([_speech_power(rng, N)[:F] for _ in range(rows)])
    if kind == "zeros":
        p[-1] = 0.0
    return p


def _crossings(got, ref):
    """Elements that differ, per leading row."""
    got, ref = np.asarray(got), np.asarray(ref)
    return (got != ref).reshape(got.shape[0], -1).sum(axis=1)


def test_numpy_targets_equal_the_jax_package():
    rng = np.random.RandomState(0)
    S = (rng.randn(513, 40) + 1j * rng.randn(513, 40)).astype(np.complex64)
    S[:, 10:25] *= 8.0
    Nz = (rng.randn(513, 40) + 1j * rng.randn(513, 40)).astype(np.complex64)
    power = np.abs(S) ** 2
    assert tt.lorenz_threshold(power, 0.9) == jt.lorenz_threshold(power, 0.9)
    for name in ("clean_speech_IBM", "clean_speech_VAD",
                 "noise_robust_clean_speech_IBM",
                 "noise_robust_clean_speech_VAD"):
        got, ref = getattr(tt, name)(S), getattr(jt, name)(S)
        assert got.dtype == ref.dtype and np.array_equal(got, ref), name
    assert np.array_equal(tt.ideal_wiener_mask(S, Nz),
                          jt.ideal_wiener_mask(S, Nz))
    for got, ref in zip(tt.noise_aware_IBM(S.T, Nz.T),
                        jt.noise_aware_IBM(S.T, Nz.T)):
        assert np.array_equal(got, ref)
    assert np.array_equal(tt.noise_aware_IRM(S, Nz), jt.noise_aware_IRM(S, Nz))
    for got, ref in zip(tt.noise_aware_IRM(S, Nz, tuple_output=True),
                        jt.noise_aware_IRM(S, Nz, tuple_output=True)):
        assert np.array_equal(got, ref)


@pytest.mark.parametrize("kind", ["speech", "ties", "zeros"])
@pytest.mark.parametrize("N,path", [(128, "sort"), (2048, "bisect")])
def test_ibm_matches_jax(kind, N, path):
    F = 513
    power = _power(kind, 2, F, N, seed=N)
    assert (F * N >= tt._LORENZ_BISECT_MIN_SIZE) == (path == "bisect")
    got = tt.clean_speech_IBM_torch(torch.tensor(power), 0.98, 0.999)
    ref = jax.vmap(lambda p: jt.clean_speech_IBM_jax(p, 0.98, 0.999))(
        jnp.asarray(power))
    assert got.dtype == torch.float32 and got.shape == power.shape
    assert set(np.unique(got.numpy())) <= {0.0, 1.0}
    assert np.all(_crossings(got.numpy(), ref) <= 1), _crossings(got, ref)
    if kind == "zeros":
        assert not got[-1].any() and not np.asarray(ref[-1]).any()
    else:
        assert 0 < float(got.mean()) < 1


@pytest.mark.parametrize("kind", ["speech", "ties", "zeros"])
def test_vad_matches_jax(kind):
    power = _power(kind, 3, 65, 300, seed=7)
    got = tt.clean_speech_VAD_torch(torch.tensor(power))
    ref = jax.vmap(jt.clean_speech_VAD_jax)(jnp.asarray(power))
    assert got.shape == (3, 1, 300) == ref.shape
    assert np.all(_crossings(got.numpy(), ref) <= 1)


@pytest.mark.parametrize("kind", ["speech", "ties", "zeros"])
def test_bisection_threshold_matches_the_sort(kind):
    """The two threshold paths of the port on one (3, 513 * 2048) batch,
    and the bisection against JAX's: thresholds that keep the same
    elements, or one element more or fewer."""
    flat = _power(kind, 3, 513, 2048, seed=11).reshape(3, -1)
    ft = torch.tensor(flat)
    bis = tt._lorenz_threshold_bisect(ft, 0.98).numpy()
    srt = tt._lorenz_threshold_sort(ft, 0.98).numpy()
    ref = np.asarray(jax.vmap(
        lambda f: jt._lorenz_threshold_bisect(f, 0.98))(jnp.asarray(flat)))
    for r in range(3):
        kept = int((flat[r] > bis[r]).sum())
        for other in (srt[r], ref[r]):
            assert abs(kept - int((flat[r] > other).sum())) <= 1
    assert (tt._lorenz_threshold(ft, 0.98).numpy() == bis).all()


def test_path_choice_follows_the_row_size_and_dtype():
    small = torch.rand(4, 1000)
    assert torch.equal(tt._lorenz_threshold(small, 0.9),
                       tt._lorenz_threshold_sort(small, 0.9))
    big = torch.rand(1, 1 << 20, dtype=torch.float64)
    assert torch.equal(tt._lorenz_threshold(big, 0.9),
                       tt._lorenz_threshold_sort(big, 0.9))
