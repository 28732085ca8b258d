"""The fused MCEM engine: the port against the JAX package's
`mcem_batch_fused` on the CPU, at var_RW=0 (deterministic chains) from the
same warm start `init=`. The JAX kernels run in the Pallas interpreter.
Tolerance: rtol 2e-4 / atol 2e-5 after three EM iterations of
multiplicative updates in float32."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

from guided_vae_nmf_tpu.mcem import MCEMConfig as JaxConfig
from guided_vae_nmf_tpu.mcem import mcem_batch_fused as jax_fused
from guided_vae_nmf_tpu.models import dgm_init, vae_init
from guided_vae_nmf_torch.mcem import MCEMConfig, mcem_batch_fused
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
    tree = dgm_init(jax.random.PRNGKey(3), [F, Y, L, [H, H]])
    X, mask, y, _ = _inputs(4)
    args = (module_from_params(tree), _t(X), _t(mask), _t(y),
            torch.Generator().manual_seed(5))
    with pytest.raises(NotImplementedError):
        mcem_batch_fused(*args, MCEMConfig(**SMALL), update_nmf=False)
    with pytest.raises(NotImplementedError):
        mcem_batch_fused(*args, MCEMConfig(**SMALL, noise_gain=True))
