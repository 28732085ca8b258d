"""The fused MCEM engine: the port against the JAX package's
`mcem_batch_fused` on the CPU, at var_RW=0 (deterministic chains), with the
NMF noise model from the same warm start `init=`, and with a fixed noise
variance (update_nmf=False, which draws no NMF init) with and without the
noise gain. The JAX kernels run in the Pallas interpreter. Tolerance:
rtol 2e-4 / atol 2e-5 after three EM iterations of multiplicative updates
in float32."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

from guided_vae_nmf_tpu.mcem import MCEMConfig as JaxConfig
from guided_vae_nmf_tpu.mcem import mcem_batch_fused as jax_fused
from guided_vae_nmf_tpu.mcem.engine import (
    _noise_gain_band_map as jax_band_map)
from guided_vae_nmf_tpu.mcem.pallas_engine import (
    _nmf_m_step_batched as jax_m_step)
from guided_vae_nmf_tpu.models import dgm_init, vae_init
from guided_vae_nmf_torch.mcem import MCEMConfig, mcem_batch_fused
from guided_vae_nmf_torch.mcem.engine import (
    _noise_gain_band_map, noise_gain_state)
from guided_vae_nmf_torch.mcem.fused_engine import _nmf_m_step_batched
from guided_vae_nmf_torch.models import module_from_params

torch.set_num_threads(2)

B, F, N, L, H, K, Y = 2, 65, 128, 8, 16, 3, 10
SMALL = dict(niter=3, nsamples_E_step=2, burnin_E_step=1, nsamples_WF=2,
             burnin_WF=1, nmf_rank=K, var_RW=0.0)
TOL = dict(rtol=2e-4, atol=2e-5)


def _inputs(seed, y_dim=Y):
    rng = np.random.RandomState(seed)
    X = rng.uniform(0.05, 1.05, (B, F, N)).astype(np.float32)
    mask = (np.arange(N)[None] < np.array([[N], [N - 40]])).astype(
        np.float32)
    X = np.where(mask[:, None, :] > 0, X, 1.0).astype(np.float32)
    y = None
    if y_dim:
        y = (rng.uniform(size=(B, y_dim, N)) > 0.5).astype(np.float32)
    init = {"W": rng.uniform(0.05, 1, (B, F, K)).astype(np.float32),
            "H": rng.uniform(0.05, 1, (B, K, N)).astype(np.float32),
            "g": rng.uniform(0.5, 1.5, (B, N)).astype(np.float32),
            "Z": rng.randn(B, L, N).astype(np.float32)}
    return X, mask, y, init


def _t(a):
    return None if a is None else torch.tensor(a)


@pytest.mark.parametrize("model", ["m2", "m1"])
def test_fused_engine_matches_jax_var0(model):
    if model == "m2":
        tree = dgm_init(jax.random.PRNGKey(0), [F, Y, L, [H, H]])
        X, mask, y, init = _inputs(1)
    else:
        tree = vae_init(jax.random.PRNGKey(0), [F, L, [H, H]])
        X, mask, y, init = _inputs(1, y_dim=0)
    keys = jax.random.split(jax.random.PRNGKey(2), B)
    ref = jax_fused(tree, jnp.asarray(X), jnp.asarray(mask),
                    None if y is None else jnp.asarray(y), keys,
                    JaxConfig(**SMALL),
                    init={k: jnp.asarray(v) for k, v in init.items()})
    got = mcem_batch_fused(module_from_params(tree), _t(X), _t(mask), _t(y),
                           torch.Generator().manual_seed(0),
                           MCEMConfig(**SMALL),
                           init={k: _t(v) for k, v in init.items()})
    for k in ("WFs", "WFn", "W", "H", "g", "Z", "cost"):
        assert tuple(got[k].shape) == tuple(ref[k].shape), k
        assert_allclose(got[k].numpy(), np.asarray(ref[k]), err_msg=k,
                        **TOL)


def test_fused_engine_random_init_runs():
    tree = dgm_init(jax.random.PRNGKey(3), [F, Y, L, [H, H]])
    X, mask, y, _ = _inputs(4)
    cfg = MCEMConfig(**{**SMALL, "var_RW": 0.01})
    out = mcem_batch_fused(module_from_params(tree), _t(X), _t(mask), _t(y),
                           torch.Generator().manual_seed(5), cfg)
    assert out["WFs"].shape == (B, F, N) and out["cost"].shape == (B, 3)
    for k in ("WFs", "WFn", "W", "H", "g", "Z", "cost"):
        assert torch.isfinite(out[k]).all(), k
    assert_allclose((out["WFs"] + out["WFn"]).numpy(), 1.0, atol=1e-5)
    # the W columns are L1-normalised
    assert_allclose(out["W"].sum(1).numpy(), 1.0, rtol=1e-5)


def test_fused_engine_refuses_what_is_not_ported():
    """The engine refuses what the JAX engine refuses: the noise gain with
    the NMF noise model, and a fixed noise model without its variance."""
    tree = dgm_init(jax.random.PRNGKey(3), [F, Y, L, [H, H]])
    X, mask, y, _ = _inputs(4)
    args = (module_from_params(tree), _t(X), _t(mask), _t(y),
            torch.Generator().manual_seed(5))
    with pytest.raises(ValueError, match="noise_gain"):
        mcem_batch_fused(*args, MCEMConfig(**SMALL, noise_gain=True))
    with pytest.raises(ValueError, match="Vb_fixed"):
        mcem_batch_fused(*args, MCEMConfig(**SMALL), update_nmf=False)


def _fixed_noise_inputs(burst_bins):
    """The fixed-noise setups of tests/mcem/test_pallas.py (impulsive frames
    30-32 in `burst_bins`), made with numpy."""
    rng = np.random.RandomState(11)
    X = (rng.uniform(size=(B, F, N)) + 0.05).astype(np.float32)
    X[:, burst_bins, 30:33] *= 50.0
    y = (rng.uniform(size=(B, Y, N)) > 0.5).astype(np.float32)
    mask = np.ones((B, N), np.float32)
    mask[1, N - 40:] = 0.0
    Vb = (rng.uniform(size=(B, F, N)) * 0.2 + 0.05).astype(np.float32)
    return X, mask, y, Vb


@pytest.mark.parametrize("gain,bands", [(False, 1), (True, 1), (True, 4)])
def test_fixed_noise_engine_matches_jax_var0(gain, bands):
    tree = dgm_init(jax.random.PRNGKey(0), [F, Y, L, [H, H]])
    X, mask, y, Vb = _fixed_noise_inputs(slice(None) if bands == 1
                                         else slice(0, 8))
    over = dict(noise_gain=gain, noise_gain_bands=bands)
    keys = jax.random.split(jax.random.PRNGKey(9), B)
    ref = jax_fused(tree, jnp.asarray(X), jnp.asarray(mask), jnp.asarray(y),
                    keys, JaxConfig(**SMALL, **over), update_nmf=False,
                    Vb_fixed=jnp.asarray(Vb))
    got = mcem_batch_fused(module_from_params(tree), _t(X), _t(mask), _t(y),
                           torch.Generator().manual_seed(0),
                           MCEMConfig(**SMALL, **over), update_nmf=False,
                           Vb_fixed=_t(Vb))
    assert set(got) == set(ref)
    for k in ref:
        assert tuple(got[k].shape) == tuple(ref[k].shape), k
        assert_allclose(got[k].numpy(), np.asarray(ref[k]), err_msg=k,
                        **TOL)
    if gain:
        # the impulsive frames carry a raised gain
        b = got["b"].numpy().reshape(B, -1, N)[:, 0]
        assert b[:, 30:33].mean() > 3.0 * np.delete(b, range(30, 33),
                                                    axis=1).mean()


@pytest.mark.parametrize("update_nmf", [True, False])
def test_nmf_m_step_batched_matches_jax(update_nmf):
    rng = np.random.RandomState(12)
    R = 3
    X2 = rng.uniform(0.05, 1.05, (B, N, F)).astype(np.float32)
    mask = np.ones((B, N), np.float32)
    mask[0, N - 30:] = 0.0
    W = rng.uniform(0.05, 1, (B, F, K)).astype(np.float32)
    Hf = rng.uniform(0.05, 1, (B, K, N)).astype(np.float32)
    g = rng.uniform(0.5, 1.5, (B, N)).astype(np.float32)
    Vs = rng.uniform(0.01, 2.0, (B, R, N, F)).astype(np.float32)
    Vb = rng.uniform(0.05, 0.3, (B, N, F)).astype(np.float32)
    Vbf = None if update_nmf else Vb
    ref = jax_m_step(jnp.asarray(X2), jnp.asarray(mask), jnp.asarray(W),
                     jnp.asarray(Hf), jnp.asarray(g), jnp.asarray(Vs),
                     update_nmf=update_nmf,
                     Vb_fixed=None if Vbf is None else jnp.asarray(Vbf))
    got = _nmf_m_step_batched(_t(X2), _t(mask), _t(W), _t(Hf), _t(g),
                              _t(Vs), update_nmf=update_nmf,
                              Vb_fixed=_t(Vbf))
    names = "WHg" if update_nmf else "g"
    for name, a, b in zip(names, got[-len(names):], ref[-len(names):]):
        assert_allclose(a.numpy(), np.asarray(b), err_msg=name, **TOL)


@pytest.mark.parametrize("F_,bands", [(513, 1), (513, 2), (513, 4), (65, 3),
                                      (5, 5)])
def test_noise_gain_band_map_matches_jax(F_, bands):
    got = _noise_gain_band_map(F_, bands).numpy()
    assert np.array_equal(got, np.asarray(jax_band_map(F_, bands)))
    assert np.all(got.sum(axis=0) == 1) and np.all(got.sum(axis=1) >= 1)


@pytest.mark.parametrize("bands", [0, F + 1])
def test_noise_gain_band_map_refuses_empty_bands(bands):
    with pytest.raises(ValueError, match="noise_gain_bands"):
        _noise_gain_band_map(F, bands)


def test_noise_gain_state_scales_vb_by_band():
    Vb = torch.rand((B, N, F)) + 0.1
    b0, eff_vb, band_map = noise_gain_state(F, N, 2, Vb, batch=B)
    assert b0.shape == (B, 2, N) and band_map.shape == (2, F)
    b = b0.clone()
    b[:, 1] = 3.0
    scale = (band_map[1] * 2.0 + 1.0)                 # 1 in band 0, 3 in 1
    assert torch.allclose(eff_vb(b), Vb * scale)
    assert eff_vb(b).is_contiguous()
    b0, eff_vb, band_map = noise_gain_state(F, N, 1, Vb, batch=B)
    assert b0.shape == (B, N) and band_map is None
    assert torch.equal(eff_vb(2.0 * b0), 2.0 * Vb)


def test_mcem_config_defaults_equal_jax():
    import dataclasses

    assert dataclasses.asdict(MCEMConfig()) == dataclasses.asdict(JaxConfig())
