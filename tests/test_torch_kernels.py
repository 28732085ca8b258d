"""K1 (MH chain) and K2 (M-step sums), in the NMF-factor form (WH=, K1a /
K2a) and the given-noise-variance form (Vb=, K1b / K2b): the port against
the JAX Pallas kernels.

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
        "Vb": rng.uniform(0.01, 0.3, (B, N, F)).astype(np.float32),
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


def _jax_chain(c, mode, nsamples, burnin, var_rw, noise, vb=False):
    Zn, U = noise
    return mh_chain_pallas(
        jax_dec_parts(c["dgm"]["decoder"], L), jnp.asarray(c["X2"]),
        jnp.asarray(c["Vb"]) if vb else None,
        jnp.asarray(c["g"]), jnp.asarray(c["ypre"]), jnp.asarray(c["Z"]),
        jnp.asarray(c["Vs"]), jnp.zeros((B, 1), jnp.int32), mode=mode,
        nsamples=nsamples, burnin=burnin, var_RW=var_rw,
        noise=(jnp.asarray(Zn), jnp.asarray(U)),
        WH=None if vb else (jnp.asarray(c["Wt"]), jnp.asarray(c["Hf"])),
        mask=jnp.asarray(c["mask"]) if mode == "e" and not vb else None)


def _torch_chain(fn, c, mode, nsamples, burnin, var_rw, noise,
                 device="cpu", vb=False):
    t = lambda k: _t(c[k], device)  # noqa: E731
    return fn(_torch_dec_w(c["dgm"], device), t("X2"),
              None if vb else (t("Wt"), t("Hf")),
              t("g"), t("ypre"), t("Z"), t("Vs"), mode=mode,
              nsamples=nsamples, burnin=burnin, var_RW=var_rw,
              noise=tuple(_t(a, device) for a in noise),
              mask=t("mask") if mode == "e" and not vb else None,
              Vb=t("Vb") if vb else None)


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
    for vb in (False, True):
        ref = _torch_chain(mh_chain_ref, c, "e", 3, 2, 0.01, noise, vb=vb)
        got = _torch_chain(mh_chain, c, "e", 3, 2, 0.01, noise, vb=vb)
        assert torch.equal(ref[0], got[0])
        assert all(torch.equal(a, b) for a, b in zip(ref[2], got[2]))
    assert not any(mh_chain.launches.values())
    samples = ref[2][0]
    args = (samples, (_t(c["Wt"]), _t(c["Hf"])), _t(c["g"]), _t(c["X2"]))
    for mode in ("h", "g"):
        for a, b in zip(nmf_sums(*args, mode=mode),
                        nmf_sums_ref(*args, mode=mode)):
            assert torch.equal(a, b)
        for a, b in zip(
                nmf_sums(samples, None, _t(c["g"]), _t(c["X2"]), mode=mode,
                         Vb=_t(c["Vb"])),
                nmf_sums_ref(samples, None, _t(c["g"]), _t(c["X2"]),
                             mode=mode, Vb=_t(c["Vb"]))):
            assert torch.equal(a, b)
    assert not any(nmf_sums.launches.values())


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


@pytest.mark.parametrize("var_rw", [0.0, 0.01])
def test_chain_vb_e_mode_matches_pallas(var_rw):
    """K1b E-mode returns (samples, s1, s2) in the JAX order."""
    c = _case(5)
    nsamples, burnin = 3, 2
    noise = _noise(6, nsamples + burnin)
    Zj, Vsj, (sj, s1j, s2j) = _jax_chain(c, "e", nsamples, burnin, var_rw,
                                         noise, vb=True)
    Zt, Vst, (st, s1t, s2t) = _torch_chain(mh_chain_ref, c, "e", nsamples,
                                           burnin, var_rw, noise, vb=True)
    for got, want in ((Zt, Zj), (Vst, Vsj), (st, sj), (s1t, s1j),
                      (s2t, s2j)):
        assert tuple(got.shape) == tuple(np.shape(want))
        assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # s1 = sum 1/Vx and s2 = sum 1/Vx^2 over the dumped samples
    Vx = np.maximum(c["g"][:, None, :, None] * st.numpy() + c["Vb"][:, None],
                    1e-10)
    assert_allclose(s1t.numpy(), np.sum(1 / Vx, axis=1), rtol=1e-5)
    assert_allclose(s2t.numpy(), np.sum(Vx ** -2.0, axis=1), rtol=1e-5)
    if var_rw:
        moved = np.any(st.numpy()[:, 1:] != st.numpy()[:, :-1], axis=-1)
        assert 0 < moved.mean() < 1


@pytest.mark.parametrize("var_rw", [0.0, 0.01])
def test_chain_vb_wf_mode_matches_pallas(var_rw):
    c = _case(7)
    nsamples, burnin = 4, 3
    noise = _noise(8, nsamples + burnin)
    Zj, Vsj, (wsj, wnj) = _jax_chain(c, "wf", nsamples, burnin, var_rw,
                                     noise, vb=True)
    Zt, Vst, (wst, wnt) = _torch_chain(mh_chain_ref, c, "wf", nsamples,
                                       burnin, var_rw, noise, vb=True)
    for got, want in ((Zt, Zj), (Vst, Vsj), (wst, wsj), (wnt, wnj)):
        assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert_allclose((wst + wnt).numpy() / nsamples, 1.0, atol=1e-5)


@pytest.mark.parametrize("mode", ["h", "g"])
def test_sums_vb_match_pallas(mode):
    """K2b: 'h' returns (s1, s2) (B, N, F) in the JAX order, 'g' (num, den)
    (B, N)."""
    c = _case(9)
    R = 4
    samples = np.random.RandomState(10).uniform(
        0.01, 2.0, (B, R, N, F)).astype(np.float32)
    oj = nmf_sums_pallas(jnp.asarray(samples), jnp.asarray(c["Vb"]),
                         jnp.asarray(c["g"]), X2=jnp.asarray(c["X2"]),
                         mode=mode)
    ot = nmf_sums_ref(_t(samples), None, _t(c["g"]), _t(c["X2"]), mode=mode,
                      Vb=_t(c["Vb"]))
    for a, b in zip(ot, oj):
        assert tuple(a.shape) == tuple(np.shape(b))
        assert_allclose(a.numpy(), np.asarray(b), **TOL)
    if mode == "h":
        Vx = np.maximum(c["g"][:, None, :, None] * samples
                        + c["Vb"][:, None], 1e-10)
        assert_allclose(ot[0].numpy(), np.sum(1 / Vx, axis=1), rtol=1e-5)


@pytest.mark.parametrize("which", ["both", "neither"])
def test_wrappers_take_exactly_one_of_vb_and_wh(which):
    c = _case(11)
    t = _t
    WH = (t(c["Wt"]), t(c["Hf"])) if which == "both" else None
    Vb = t(c["Vb"]) if which == "both" else None
    with pytest.raises(ValueError, match="exactly one"):
        mh_chain(_torch_dec_w(c["dgm"]), t(c["X2"]), WH, t(c["g"]),
                 t(c["ypre"]), t(c["Z"]), t(c["Vs"]), mode="wf", Vb=Vb)
    samples = torch.rand((B, 2, N, F)) + 0.01
    with pytest.raises(ValueError, match="exactly one"):
        nmf_sums(samples, WH, t(c["g"]), t(c["X2"]), mode="g", Vb=Vb)
