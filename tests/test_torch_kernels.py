"""K1 (MH chain) and K2 (M-step sums): the port against the JAX Pallas
kernels, and the CUDA kernels against their plain PyTorch versions.

On the CPU the JAX kernels run in the Pallas TPU interpreter, as
tests/mcem/test_pallas.py runs them; the port's wrappers run their plain
versions because the tensors lie on the CPU. Inputs and noise streams are
made with numpy from a seed and handed to both packages. Tolerance: atol
2e-5 / rtol 2e-4 (float32, sums in another order), as test_pallas.py uses.
The CUDA kernels are held against the plain versions in test_torch_cuda.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

from guided_vae_nmf_tpu.models import dgm_init
from guided_vae_nmf_tpu.models.nets import decoder_apply
from guided_vae_nmf_tpu.mcem.pallas_engine import (
    _dec_parts as jax_dec_parts,
    mh_chain_pallas,
    nmf_sums_pallas,
)
from guided_vae_nmf_torch.mcem import (
    mh_chain,
    mh_chain_ref,
    nmf_sums,
    nmf_sums_ref,
)
from guided_vae_nmf_torch.mcem.fused_engine import _dec_parts
from guided_vae_nmf_torch.models import module_from_params

torch.set_num_threads(2)

B, F, N, L, H, K, Y = 2, 65, 128, 8, 16, 3, 10
TOL = dict(atol=2e-5, rtol=2e-4)


def _case(seed=0):
    """Seeded inputs for both packages: numpy arrays (frames-major)."""
    rng = np.random.RandomState(seed)
    dgm = dgm_init(jax.random.PRNGKey(seed), [F, Y, L, [H, H]])
    dec = dgm["decoder"]
    l0 = dec["hidden"][0]
    y = (rng.uniform(size=(B, N, Y)) > 0.5).astype(np.float32)
    ypre = np.asarray(jnp.einsum("bny,yh->bnh", y, l0["w"][L:]) + l0["b"])
    Z = rng.randn(B, N, L).astype(np.float32)
    zin = np.concatenate([Z, y], axis=-1).reshape(B * N, -1)
    Vs = np.asarray(decoder_apply(dec, zin)).reshape(B, N, F)
    return {
        "dgm": dgm, "ypre": ypre, "Z": Z, "Vs": Vs,
        "X2": rng.uniform(0.05, 1.05, (B, N, F)).astype(np.float32),
        "Wt": rng.uniform(0.05, 0.5, (B, K, F)).astype(np.float32),
        "Hf": rng.uniform(0.05, 0.5, (B, K, N)).astype(np.float32),
        "g": rng.uniform(0.5, 1.5, (B, N)).astype(np.float32),
        "mask": (np.arange(N)[None] < np.array([[N], [N - 37]])).astype(
            np.float32),
    }


def _noise(seed, n_steps):
    rng = np.random.RandomState(seed)
    return (rng.randn(B, n_steps, N, L).astype(np.float32),
            rng.uniform(1e-6, 1.0, (B, n_steps, N)).astype(np.float32))


def _torch_dec_w(dgm, device="cpu"):
    return _dec_parts(module_from_params(dgm, device=device).decoder, L)


def _t(a, device="cpu"):
    return torch.tensor(np.asarray(a), device=device)


def _jax_chain(c, mode, nsamples, burnin, var_rw, noise):
    Zn, U = noise
    return mh_chain_pallas(
        jax_dec_parts(c["dgm"]["decoder"], L), jnp.asarray(c["X2"]), None,
        jnp.asarray(c["g"]), jnp.asarray(c["ypre"]), jnp.asarray(c["Z"]),
        jnp.asarray(c["Vs"]), jnp.zeros((B, 1), jnp.int32), mode=mode,
        nsamples=nsamples, burnin=burnin, var_RW=var_rw,
        noise=(jnp.asarray(Zn), jnp.asarray(U)),
        WH=(jnp.asarray(c["Wt"]), jnp.asarray(c["Hf"])),
        mask=jnp.asarray(c["mask"]) if mode == "e" else None)


def _torch_chain(fn, c, mode, nsamples, burnin, var_rw, noise,
                 device="cpu"):
    t = lambda k: _t(c[k], device)  # noqa: E731
    return fn(_torch_dec_w(c["dgm"], device), t("X2"), (t("Wt"), t("Hf")),
              t("g"), t("ypre"), t("Z"), t("Vs"), mode=mode,
              nsamples=nsamples, burnin=burnin, var_RW=var_rw,
              noise=tuple(_t(a, device) for a in noise),
              mask=t("mask") if mode == "e" else None)


@pytest.mark.parametrize("var_rw", [0.0, 0.01])
def test_chain_e_mode_matches_pallas(var_rw):
    c = _case(0)
    nsamples, burnin = 3, 2
    noise = _noise(1, nsamples + burnin)
    Zj, Vsj, (sj, nwj, dwj) = _jax_chain(c, "e", nsamples, burnin, var_rw,
                                         noise)
    Zt, Vst, (st, nwt, dwt) = _torch_chain(mh_chain_ref, c, "e", nsamples,
                                           burnin, var_rw, noise)
    assert_allclose(Zt.numpy(), np.asarray(Zj), **TOL)
    assert_allclose(Vst.numpy(), np.asarray(Vsj), **TOL)
    assert_allclose(st.numpy(), np.asarray(sj), **TOL)
    assert_allclose(nwt.numpy(), np.asarray(nwj), **TOL)
    assert_allclose(dwt.numpy(), np.asarray(dwj), **TOL)
    if var_rw:
        # some sampling-phase proposals are accepted (consecutive samples
        # differ) and some rejected, or the check is vacuous
        sj = np.asarray(sj)
        moved = np.any(sj[:, 1:] != sj[:, :-1], axis=-1)
        assert 0 < moved.mean() < 1


@pytest.mark.parametrize("var_rw", [0.0, 0.01])
def test_chain_wf_mode_matches_pallas(var_rw):
    c = _case(1)
    nsamples, burnin = 4, 3
    noise = _noise(2, nsamples + burnin)
    Zj, Vsj, (wsj, wnj) = _jax_chain(c, "wf", nsamples, burnin, var_rw,
                                     noise)
    Zt, Vst, (wst, wnt) = _torch_chain(mh_chain_ref, c, "wf", nsamples,
                                       burnin, var_rw, noise)
    assert_allclose(Zt.numpy(), np.asarray(Zj), **TOL)
    assert_allclose(Vst.numpy(), np.asarray(Vsj), **TOL)
    assert_allclose(wst.numpy(), np.asarray(wsj), **TOL)
    assert_allclose(wnt.numpy(), np.asarray(wnj), **TOL)
    # the Wiener gains partition unity
    assert_allclose((wst + wnt).numpy() / nsamples, 1.0, atol=1e-5)


@pytest.mark.parametrize("mode", ["h", "g"])
def test_sums_match_pallas(mode):
    c = _case(2)
    R = 4
    samples = np.random.RandomState(3).uniform(
        0.01, 2.0, (B, R, N, F)).astype(np.float32)
    oj = nmf_sums_pallas(jnp.asarray(samples), None, jnp.asarray(c["g"]),
                         X2=jnp.asarray(c["X2"]), mode=mode,
                         WH=(jnp.asarray(c["Wt"]), jnp.asarray(c["Hf"])))
    ot = nmf_sums_ref(_t(samples), (_t(c["Wt"]), _t(c["Hf"])), _t(c["g"]),
                      _t(c["X2"]), mode=mode)
    for a, b in zip(ot, oj):
        assert tuple(a.shape) == tuple(np.shape(b))
        assert_allclose(a.numpy(), np.asarray(b), **TOL)


def test_wrappers_take_the_plain_version_on_cpu():
    c = _case(3)
    noise = _noise(4, 5)
    ref = _torch_chain(mh_chain_ref, c, "e", 3, 2, 0.01, noise)
    got = _torch_chain(mh_chain, c, "e", 3, 2, 0.01, noise)
    assert torch.equal(ref[0], got[0])
    assert all(torch.equal(a, b) for a, b in zip(ref[2], got[2]))
    assert mh_chain.launches == 0
    samples = ref[2][0]
    args = (samples, (_t(c["Wt"]), _t(c["Hf"])), _t(c["g"]), _t(c["X2"]))
    for mode in ("h", "g"):
        for a, b in zip(nmf_sums(*args, mode=mode),
                        nmf_sums_ref(*args, mode=mode)):
            assert torch.equal(a, b)
    assert nmf_sums.launches == 0


def test_chain_without_noise_draws_from_the_seed_on_cpu():
    c = _case(4)
    t = _t
    dec_w = _torch_dec_w(c["dgm"])
    args = (dec_w, t(c["X2"]), (t(c["Wt"]), t(c["Hf"])), t(c["g"]),
            t(c["ypre"]), t(c["Z"]), t(c["Vs"]))
    kw = dict(mode="e", nsamples=2, burnin=2, var_RW=0.01, mask=t(c["mask"]))
    a = mh_chain(*args, seed=5, **kw)
    b = mh_chain(*args, seed=5, **kw)
    d = mh_chain(*args, seed=6, **kw)
    assert torch.equal(a[0], b[0])
    assert not torch.equal(a[0], d[0])
