"""The kernels' whole domain: the port's plain versions against the JAX
Pallas kernels where the TPU kernels take shapes the port's cluster chain
(K1a-K1d) and narrow sums (ranks up to 16) do not, the shapes its general
chain (K1g) and wide sums kernel take on the card: decoder hidden widths
that differ ([24, 40]), four hidden layers, NMF rank 20; the sums at ranks
17 and 32; and the fused engine with a decoder of unequal widths against
JAX's `mcem_batch_fused(init=...)`.

On the CPU the JAX kernels run in the Pallas TPU interpreter, as
tests/mcem/test_pallas.py runs them; the port's wrappers run their plain
versions because the tensors lie on the CPU. Inputs and noise streams are
made with numpy from a seed and handed to both packages; the chains run
under decisive noise (accept uniforms of 0 or inf), so no decision can
flip on rounding. Tolerance: atol 2e-5 / rtol 2e-4 (float32, sums in
another order), as test_pallas.py uses; the engine after three EM
iterations rtol 2e-4 / atol 2e-5, as tests/test_torch_engine.py holds it.
The CUDA kernels are held against the plain versions in
tests/test_torch_cuda.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

from guided_vae_nmf_tpu.mcem import MCEMConfig as JaxConfig
from guided_vae_nmf_tpu.mcem import mcem_batch_fused as jax_fused
from guided_vae_nmf_tpu.mcem.pallas_engine import (
    _dec_parts as jax_dec_parts,
    mh_chain_pallas,
    nmf_sums_pallas,
)
from guided_vae_nmf_tpu.models import dgm_init
from guided_vae_nmf_tpu.models.nets import decoder_apply
from guided_vae_nmf_torch.mcem import (
    MCEMConfig,
    mcem_batch_fused,
    mh_chain,
    mh_chain_ref,
    nmf_sums,
    nmf_sums_ref,
)
from guided_vae_nmf_torch.mcem.fused_engine import _dec_parts
from guided_vae_nmf_torch.mcem.mh_chain import widths
from guided_vae_nmf_torch.models import module_from_params

torch.set_num_threads(2)

B, F, N, L, Y = 2, 65, 128, 8, 10
TOL = dict(atol=2e-5, rtol=2e-4)
# (encoder h_dim as dgm_init takes it, NMF rank): the decoder mirrors it
DECODERS = {"40x24": ([40, 24], 3), "16x4": ([16] * 4, 3),
            "40x24_rank20": ([40, 24], 20)}
# (decoder, noise form): the Vb form has no rank, so rank 20 in WH only
CHAINS = [("40x24", False), ("40x24", True), ("16x4", False),
          ("16x4", True), ("40x24_rank20", False)]


def _case(seed, h_dim, K):
    """Seeded inputs for both packages (frames-major numpy arrays)."""
    rng = np.random.RandomState(seed)
    dgm = dgm_init(jax.random.PRNGKey(seed), [F, Y, L, h_dim])
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


def _decisive(seed, n_steps):
    rng = np.random.RandomState(seed)
    u = np.where(rng.uniform(size=(B, n_steps, N)) < 0.5, 0.0, np.inf)
    return (rng.randn(B, n_steps, N, L).astype(np.float32),
            u.astype(np.float32))


def _t(a):
    return torch.tensor(np.asarray(a))


@pytest.mark.parametrize("mode", ["e", "wf"])
@pytest.mark.parametrize("decoder,vb", CHAINS,
                         ids=[f"{d}-{'vb' if v else 'wh'}" for d, v in CHAINS])
def test_chain_matches_pallas_past_the_cluster_form(decoder, vb, mode):
    """mh_chain_ref against mh_chain_pallas: decoders of unequal widths and
    of four hidden layers, and rank 20 in the WH form; E and WF, both
    noise forms; some proposals accepted and some rejected."""
    h_dim, K = DECODERS[decoder]
    c = _case(3, h_dim, K)
    nsamples, burnin = 3, 2
    noise = _decisive(4, nsamples + burnin)
    wh = None if vb else (c["Wt"], c["Hf"])
    use_mask = mode == "e" and not vb
    Zj, Vsj, extra_j = mh_chain_pallas(
        jax_dec_parts(c["dgm"]["decoder"], L), jnp.asarray(c["X2"]),
        jnp.asarray(c["Vb"]) if vb else None, jnp.asarray(c["g"]),
        jnp.asarray(c["ypre"]), jnp.asarray(c["Z"]), jnp.asarray(c["Vs"]),
        jnp.zeros((B, 1), jnp.int32), mode=mode, nsamples=nsamples,
        burnin=burnin, var_RW=0.01,
        noise=tuple(jnp.asarray(a) for a in noise),
        WH=None if wh is None else tuple(jnp.asarray(a) for a in wh),
        mask=jnp.asarray(c["mask"]) if use_mask else None)
    dec_w = _dec_parts(module_from_params(c["dgm"]).decoder, L)
    assert widths(dec_w) == tuple(reversed(h_dim))
    args = (dec_w, _t(c["X2"]), None if wh is None else tuple(map(_t, wh)),
            _t(c["g"]), _t(c["ypre"]), _t(c["Z"]), _t(c["Vs"]))
    kw = dict(mode=mode, nsamples=nsamples, burnin=burnin, var_RW=0.01,
              noise=tuple(map(_t, noise)),
              mask=_t(c["mask"]) if use_mask else None,
              Vb=_t(c["Vb"]) if vb else None)
    Zt, Vst, extra_t = mh_chain_ref(*args, **kw)
    for got, want in zip((Zt, Vst) + extra_t, (Zj, Vsj) + tuple(extra_j)):
        assert tuple(got.shape) == tuple(np.shape(want))
        assert_allclose(got.numpy(), np.asarray(want), **TOL)
    if mode == "e":
        s = extra_t[0].numpy()
        moved = np.any(s[:, 1:] != s[:, :-1], axis=-1)
        assert 0 < moved.mean() < 1
    # the wrapper takes the plain version on CPU tensors, whatever the
    # decoder
    wrapped = mh_chain(*args, **kw)
    assert all(torch.equal(a, b) for a, b in zip(
        (wrapped[0], wrapped[1]) + wrapped[2], (Zt, Vst) + extra_t))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", ["h", "g"])
@pytest.mark.parametrize("K", [17, 32])
def test_sums_match_pallas_past_rank_16(K, mode, dtype):
    """nmf_sums_ref against nmf_sums_pallas at ranks the card runs on the
    wide kernel, over float32 samples and their bfloat16 rounding."""
    rng = np.random.RandomState(K)
    R = 3
    samples = rng.uniform(0.01, 2.0, (B, R, N, F)).astype(np.float32)
    X2 = rng.uniform(0.05, 1.05, (B, N, F)).astype(np.float32)
    Wt = rng.uniform(0.05, 0.5, (B, K, F)).astype(np.float32)
    Hf = rng.uniform(0.05, 0.5, (B, K, N)).astype(np.float32)
    g = rng.uniform(0.5, 1.5, (B, N)).astype(np.float32)
    sj = jnp.asarray(samples).astype(getattr(jnp, dtype))
    st = torch.tensor(samples).to(getattr(torch, dtype))
    oj = nmf_sums_pallas(sj, None, jnp.asarray(g), X2=jnp.asarray(X2),
                         mode=mode, WH=(jnp.asarray(Wt), jnp.asarray(Hf)))
    args = (st, (_t(Wt), _t(Hf)), _t(g), _t(X2))
    ot = nmf_sums_ref(*args, mode=mode)
    want = (B, N, K) if mode == "h" else (B, N)
    for a, b in zip(ot, oj):
        assert tuple(a.shape) == want == tuple(np.shape(b))
        assert_allclose(a.numpy(), np.asarray(b), **TOL)
    assert all(torch.equal(a, b) for a, b in zip(nmf_sums(*args, mode=mode),
                                                 ot))


@pytest.mark.parametrize("K", [3, 20])
def test_fused_engine_matches_jax_with_unequal_widths(K):
    """The port's fused engine against JAX's `mcem_batch_fused` for an M2
    whose decoder widths differ (dgm_init's h_dim [40, 24]: decoder 24, 40),
    weights carried across by `module_from_params` (models/convert.py),
    from the same warm start at var_RW = 0, three EM iterations."""
    tree = dgm_init(jax.random.PRNGKey(5), [F, Y, L, [40, 24]])
    rng = np.random.RandomState(6)
    X = rng.uniform(0.05, 1.05, (B, F, N)).astype(np.float32)
    mask = (np.arange(N)[None] < np.array([[N], [N - 40]])).astype(
        np.float32)
    X = np.where(mask[:, None, :] > 0, X, 1.0).astype(np.float32)
    y = (rng.uniform(size=(B, Y, N)) > 0.5).astype(np.float32)
    init = {"W": rng.uniform(0.05, 1, (B, F, K)).astype(np.float32),
            "H": rng.uniform(0.05, 1, (B, K, N)).astype(np.float32),
            "g": rng.uniform(0.5, 1.5, (B, N)).astype(np.float32),
            "Z": rng.randn(B, L, N).astype(np.float32)}
    small = dict(niter=3, nsamples_E_step=2, burnin_E_step=1, nsamples_WF=2,
                 burnin_WF=1, nmf_rank=K, var_RW=0.0)
    keys = jax.random.split(jax.random.PRNGKey(7), B)
    ref = jax_fused(tree, jnp.asarray(X), jnp.asarray(mask), jnp.asarray(y),
                    keys, JaxConfig(**small),
                    init={k: jnp.asarray(v) for k, v in init.items()})
    model = module_from_params(tree)
    assert [h.w.shape[1] for h in model.decoder.hidden] == [24, 40]
    got = mcem_batch_fused(model, _t(X), _t(mask), _t(y),
                           torch.Generator().manual_seed(0),
                           MCEMConfig(**small),
                           init={k: _t(v) for k, v in init.items()})
    for k in ("WFs", "WFn", "W", "H", "g", "Z", "cost"):
        assert tuple(got[k].shape) == tuple(ref[k].shape), k
        assert_allclose(got[k].numpy(), np.asarray(ref[k]), err_msg=k,
                        **TOL)
