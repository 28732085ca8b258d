"""The eager MCEM engine (`guided_vae_nmf_torch/mcem/engine.py`) against the
JAX package's XLA engine on the CPU, at B=2, F=65, N=128 with small random
models.

The two engines draw from different generators, so every comparison with
JAX runs under injected randomness: recorded streams (`noise=`) for the
chains and a shared NMF init (`init_nmf=`), or var_RW=0, where the chain
is deterministic. Tolerance: atol 2e-5 / rtol 2e-4 (float32, sums in
another order).

The properties JAX cannot be asked about are held against the port's own
runs, whose parts are held against JAX above, bit for bit (the EM runs
compute in float64, see `engine.py`): a batch row equals the row run
alone, a padded length changes nothing on the valid frames, and the
tol-stop runs (`mcem_run_converged` / `mcem_run_converged_batch`, which
take no injected streams in either package) agree with each other row by
row and, run to their budget, with `mcem_run`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

from guided_vae_nmf_tpu.mcem import MCEMConfig as JaxConfig
from guided_vae_nmf_tpu.mcem import engine as jax_engine
from guided_vae_nmf_tpu.models import dgm_init, vae_init
from guided_vae_nmf_torch.mcem import MCEMConfig
from guided_vae_nmf_torch.mcem.engine import (
    _chain_draws,
    _chain_keys,
    _precompute_label_proj,
    _decode_cond,
    _row_keys,
    mcem_m2_batch,
    mcem_run,
    mcem_run_converged,
    mcem_run_converged_batch,
    mh_sample_posterior,
    mh_wiener_filter,
    pad_power,
)
from guided_vae_nmf_torch.models import module_from_params

torch.set_num_threads(2)

B, F, N, L, H, K, Y = 2, 65, 128, 8, 16, 3, 10
TOL = dict(rtol=2e-4, atol=2e-5)
SMALL = dict(niter=3, nsamples_E_step=3, burnin_E_step=2, nsamples_WF=3,
             burnin_WF=2, nmf_rank=K)


def _t(a):
    return None if a is None else torch.tensor(np.asarray(a))


def _inputs(seed, y_dim=Y):
    """Power spectrograms with a loud burst, the second row padded by 40
    frames; labels; a fixed noise variance."""
    rng = np.random.RandomState(seed)
    X = rng.uniform(0.05, 1.05, (B, F, N)).astype(np.float32)
    X[:, :, 30:33] *= 50.0
    mask = (np.arange(N)[None] < np.array([[N], [N - 40]])).astype(
        np.float32)
    X = np.where(mask[:, None, :] > 0, X, 1.0).astype(np.float32)
    y = None
    if y_dim:
        y = (rng.uniform(size=(B, y_dim, N)) > 0.5).astype(np.float32)
    Vb = (rng.uniform(size=(B, F, N)) * 0.2 + 0.05).astype(np.float32)
    return X, mask, y, Vb


def _tree(m2, seed=0):
    if m2:
        return dgm_init(jax.random.PRNGKey(seed), [F, Y, L, [H, H]])
    return vae_init(jax.random.PRNGKey(seed), [F, L, [H, H]])


def _streams(seed, lead, n_steps):
    """Recorded chain streams in the port's layout: normals
    (*lead, n_steps, L, N) and uniforms (*lead, n_steps, N) in
    (1e-6, 1)."""
    rng = np.random.RandomState(seed)
    return (rng.randn(*lead, n_steps, L, N).astype(np.float32),
            rng.uniform(1e-6, 1.0, (*lead, n_steps, N)).astype(np.float32))


def _chain_setup(seed):
    tree = _tree(True)
    X, mask, y, Vb = _inputs(seed)
    model = module_from_params(tree)
    rng = np.random.RandomState(seed + 1)
    Z = rng.randn(B, L, N).astype(np.float32)
    g = rng.uniform(0.5, 1.5, (B, N)).astype(np.float32)
    y_pre = _precompute_label_proj(model.decoder, _t(y), L)
    Vs = _decode_cond(model.decoder, y_pre, _t(Z))
    return tree, model, X, y, Vb, Z, g, y_pre, Vs


@pytest.mark.parametrize("var_rw", [0.0, 0.01])
@pytest.mark.parametrize("mode", ["e", "wf"])
def test_chain_matches_jax(mode, var_rw):
    """mh_sample_posterior / mh_wiener_filter under injected streams (and at
    var_RW=0, where the proposal equals the state) against JAX's, row by
    row."""
    tree, model, X, y, Vb, Z, g, y_pre, Vs = _chain_setup(3)
    R, burnin = 3, 2
    Zn, U = _streams(4, (B,), R + burnin)
    fn = mh_sample_posterior if mode == "e" else mh_wiener_filter
    jfn = (jax_engine.mh_sample_posterior if mode == "e"
           else jax_engine.mh_wiener_filter)
    got = fn(model.decoder, y_pre, _t(X), _t(Vb), _t(g), _t(Z), Vs, R,
             burnin, var_rw, noise=(_t(Zn), _t(U)))
    dec = tree["decoder"]
    for b in range(B):
        yp = jax_engine._precompute_label_proj(dec, jnp.asarray(y[b]), L)
        Vs_b = jax_engine._decode_cond(dec, yp, jnp.asarray(Z[b]))
        ref = jfn(dec, yp, jnp.asarray(X[b]), jnp.asarray(Vb[b]),
                  jnp.asarray(g[b]), jnp.asarray(Z[b]), Vs_b,
                  jax.random.PRNGKey(0), R, burnin, var_rw,
                  noise=(jnp.asarray(Zn[b]), jnp.asarray(U[b])))
        if mode == "e":
            pairs = zip(got, (ref[0], ref[1], ref[3]))
        else:
            pairs = zip(got, ref[:4])
        for i, (a, r) in enumerate(pairs):
            assert_allclose(a[b].numpy(), np.asarray(r), err_msg=str(i),
                            **TOL)
    if var_rw:       # the streams must move the chain, or the test is idle
        assert not np.allclose(got[0 if mode == "e" else 2][0].numpy(),
                               Z[0])


def _jax_noise(noise, b):
    return tuple(jnp.asarray(a[b]) for a in noise)


def _run_both(m2, noise_model, seed, cfg_kw=None, init=True, inject=True):
    """mcem_run on the port (batched) and on JAX (row by row) from one
    init_nmf and one set of recorded streams."""
    cfg_kw = dict(SMALL, **(cfg_kw or {}))
    tree = _tree(m2, seed)
    X, mask, y, Vb = _inputs(seed, Y if m2 else 0)
    update_nmf = noise_model != "spp"
    Vb_fixed = None if noise_model == "nmf" else Vb
    rng = np.random.RandomState(seed + 7)
    Kr = K if update_nmf else 1
    W0 = rng.uniform(0.05, 1.0, (B, F, Kr)).astype(np.float32)
    H0 = rng.uniform(0.05, 1.0, (B, Kr, N)).astype(np.float32)
    if not update_nmf:
        W0, H0 = np.ones_like(W0), np.zeros_like(H0)
    g0 = rng.uniform(0.5, 1.5, (B, N)).astype(np.float32)
    sE = cfg_kw["nsamples_E_step"] + cfg_kw["burnin_E_step"]
    sW = cfg_kw["nsamples_WF"] + cfg_kw["burnin_WF"]
    noise = None
    if inject:
        ZE, UE = _streams(seed + 8, (B, cfg_kw["niter"]), sE)
        ZW, UW = _streams(seed + 9, (B,), sW)
        noise = (ZE, UE, ZW, UW)
    got = mcem_run(module_from_params(tree), _t(X), _t(mask), _t(y),
                   [11, 12], MCEMConfig(**cfg_kw), update_nmf=update_nmf,
                   Vb_fixed=_t(Vb_fixed),
                   init_nmf=(_t(W0), _t(H0), _t(g0)) if init else None,
                   noise=None if noise is None else tuple(map(_t, noise)))
    params = {k: v for k, v in tree.items() if k != "y_dim"}
    refs = []
    for b in range(B):
        refs.append(jax_engine.mcem_run(
            params, jnp.asarray(X[b]), jnp.asarray(mask[b]),
            None if y is None else jnp.asarray(y[b]),
            jax.random.PRNGKey(b), JaxConfig(**cfg_kw),
            update_nmf=update_nmf,
            Vb_fixed=None if Vb_fixed is None else jnp.asarray(Vb_fixed[b]),
            init_nmf=(jnp.asarray(W0[b]), jnp.asarray(H0[b]),
                      jnp.asarray(g0[b])) if init else None,
            noise=None if noise is None else _jax_noise(noise, b)))
    return got, refs


def _assert_rows(got, refs):
    assert set(got) == set(refs[0])
    for k in refs[0]:
        for b, ref in enumerate(refs):
            assert_allclose(got[k][b].numpy(), np.asarray(ref[k]),
                            err_msg=f"{k}[{b}]", **TOL)


@pytest.mark.parametrize("m2", [False, True], ids=["M1", "M2"])
@pytest.mark.parametrize("noise_model", ["nmf", "spp", "hybrid"])
def test_mcem_run_matches_jax_under_injection(m2, noise_model):
    got, refs = _run_both(m2, noise_model, seed=20 + 3 * m2)
    _assert_rows(got, refs)


@pytest.mark.parametrize("bands", [1, 2])
def test_noise_gain_matches_jax_var0(bands):
    """The noise-gain branch from init_nmf at var_RW=0 (JAX takes no
    injected streams with the noise gain)."""
    got, refs = _run_both(True, "spp", seed=31, inject=False,
                          cfg_kw=dict(var_RW=0.0, noise_gain=True,
                                      noise_gain_bands=bands))
    _assert_rows(got, refs)
    assert got["b"].shape == ((B, N) if bands == 1 else (B, bands, N))


def test_batch_row_equals_the_row_alone():
    """mcem_m2_batch row r equals mcem_run on row r alone: a row's draws
    and init depend on its seed, not on its batch-mates."""
    tree = _tree(True, 5)
    model = module_from_params(tree)
    X, mask, y, Vb = map(_t, _inputs(6))
    cfg = MCEMConfig(**SMALL, var_RW=0.01)
    both = mcem_m2_batch(model, X, mask, y, [101, 202], cfg)
    for r, seed in enumerate((101, 202)):
        one = mcem_run(model, X[r:r + 1], mask[r:r + 1], y[r:r + 1], [seed],
                       cfg)
        for k, v in one.items():
            assert torch.equal(both[k][r], v[0]), k
    swapped = mcem_m2_batch(model, X.flip(0), mask.flip(0), y.flip(0),
                            [202, 101], cfg)
    assert torch.equal(swapped["WFs"][1], both["WFs"][0])
    assert both["WFs"].dtype == torch.float32


def test_padded_length_leaves_the_valid_prefix():
    """N padded to 128 and to 256: the same chain on the valid frames (the
    draws and the H init of a frame depend on its index only; the W sums
    and the cost skip pad frames)."""
    tree = _tree(True, 7)
    model = module_from_params(tree)
    X, mask, y, _ = _inputs(8)
    n = 100
    X, y = _t(X[:, :, :n]), _t(y[:, :, :n])
    cfg = MCEMConfig(**SMALL, var_RW=0.01)
    outs = []
    for n_pad in (128, 256):
        Xp, m = pad_power(X, n_pad)
        yp = torch.nn.functional.pad(y, (0, n_pad - n))
        outs.append(mcem_run(model, Xp, m, yp, [3, 4], cfg))
    for k in ("WFs", "WFn", "H", "Z", "g"):
        assert torch.equal(outs[1][k][..., :n], outs[0][k][..., :n]), k
    for k in ("W", "cost"):
        assert torch.equal(outs[1][k], outs[0][k]), k


def test_pad_power_matches_jax():
    X = np.random.RandomState(9).uniform(size=(F, 70)).astype(np.float32)
    got, m = pad_power(_t(X), 128)
    ref, rm = jax_engine.pad_power(jnp.asarray(X), 128)
    assert np.array_equal(got.numpy(), np.asarray(ref))
    assert np.array_equal(m.numpy(), np.asarray(rm))


def test_draws_depend_on_row_frame_and_step_only():
    keys = _chain_keys(_row_keys([5, 6], "cpu"), 2)
    Zn, U = _chain_draws(keys, 4, L, 64)
    Zn2, U2 = _chain_draws(keys.flip(0), 6, L, 128)
    assert torch.equal(Zn2[1, :4, :, :64], Zn[0])
    assert torch.equal(U2[0, :4, :64], U[1])
    assert abs(float(Zn.mean())) < 0.1 and 0.9 < float(Zn.std()) < 1.1
    assert not torch.equal(_chain_draws(_chain_keys(
        _row_keys([5, 6], "cpu"), 3), 4, L, 64)[0], Zn)


def _converged_inputs():
    tree = _tree(True, 12)
    X, mask, y, _ = _inputs(13)
    X[1] = np.where(mask[1][None] > 0, 0.2 * X[1] + 0.01, 1.0)
    return module_from_params(tree), _t(X), _t(mask), _t(y)


def test_converged_batch_row_equals_converged_single():
    """Rows that stop at different chunks: each row of the batch equals the
    single-utterance run, with the same iteration count."""
    model, X, mask, y = _converged_inputs()
    cfg = MCEMConfig(**{**SMALL, "niter": 8}, var_RW=0.01)
    tol = 0.05
    both = mcem_run_converged_batch(model, X, mask, y, [21, 22], cfg,
                                    tol=tol, check_every=2)
    iters = both["iters"].tolist()
    assert len(set(iters)) == 2, iters       # the rows stop apart
    for r, seed in enumerate((21, 22)):
        one = mcem_run_converged(model, X[r], mask[r], y[r], seed, cfg,
                                 tol=tol, check_every=2)
        assert one["iters"] == iters[r]
        assert torch.equal(both["cost"][r, :iters[r]], one["cost"])
        assert not both["cost"][r, iters[r]:].any()
        for k in ("WFs", "WFn", "W", "H", "g", "Z"):
            assert torch.equal(both[k][r], one[k]), k


def test_converged_run_to_its_budget_equals_mcem_run():
    """With a tolerance no cost change meets, the tol-stop run is mcem_run
    (the same chains, in the same order)."""
    model, X, mask, y = _converged_inputs()
    cfg = MCEMConfig(**{**SMALL, "niter": 4}, var_RW=0.01)
    conv = mcem_run_converged_batch(model, X, mask, y, [1, 2], cfg,
                                    tol=-float("inf"), check_every=2)
    ref = mcem_run(model, X, mask, y, [1, 2], cfg)
    assert conv["iters"].tolist() == [4, 4]
    for k in ref:
        assert torch.equal(conv[k], ref[k]), k


def test_refusals_match_jax():
    model, X, mask, y = _converged_inputs()
    with pytest.raises(ValueError, match="noise_gain"):
        mcem_run(model, X, mask, y, [1, 2],
                 MCEMConfig(**SMALL, noise_gain=True))
    with pytest.raises(ValueError, match="Vb_fixed"):
        mcem_run(model, X, mask, y, [1, 2], MCEMConfig(**SMALL),
                 update_nmf=False)
    with pytest.raises(ValueError, match="noise_gain"):
        mcem_run(model, X, mask, y, [1, 2],
                 MCEMConfig(**SMALL, noise_gain=True), update_nmf=False,
                 Vb_fixed=X, noise=(None,) * 4)
