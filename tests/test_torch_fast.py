"""Fast mode (K1c / K2c): the port against the JAX package on the CPU.

- `fast_log` / `fast_exp` equal the JAX package's `_fast_log` / `_fast_exp`
  bit for bit when JAX evaluates them op by op; under `jax.jit`, XLA:CPU
  contracts multiply-adds, so there the two agree to float32 rounding.
- The chain and the sums with the fast options against the Pallas kernels
  in interpret mode, under injected noise. The interpreter's approximate
  reciprocal (`pl.reciprocal(approx=True)`) is off from 1/x by up to about
  4e-3 relative, the CUDA kernel's `rcp.approx` by 1 ulp and the port's
  plain version not at all, so the JAX side runs with approx_recip=False
  and the port's float32 outputs are held at the exact-mode tolerance (atol
  2e-5 / rtol 2e-4). bfloat16 sample dumps are held within one bfloat16
  ulp (2^-7 to 2^-8 of the value): where the two float32 Vs differ by an
  ulp the dump may round to neighbouring bfloat16 values. A separate test
  holds the JAX outputs *with* its approximate reciprocal at rtol 1e-2.
- The fused driver and `enhance_waveform` in fast mode against JAX's at
  var_RW=0, again with JAX's reciprocal exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

import guided_vae_nmf_tpu.pipeline as jax_pipeline
from guided_vae_nmf_tpu.mcem import MCEMConfig as JaxConfig
from guided_vae_nmf_tpu.mcem import mcem_batch_fused as jax_fused
from guided_vae_nmf_tpu.mcem.pallas_engine import (
    _dec_parts as jax_dec_parts,
    _fast_exp,
    _fast_log,
    mh_chain_pallas,
    nmf_sums_pallas,
)
from guided_vae_nmf_tpu.models import classifier_init, dgm_init
from guided_vae_nmf_tpu.models.nets import decoder_apply
from guided_vae_nmf_torch.dsp import pad_signal_for_stft
from guided_vae_nmf_torch.mcem import MCEMConfig, mcem_batch_fused
from guided_vae_nmf_torch.mcem import mh_chain, mh_chain_ref, nmf_sums
from guided_vae_nmf_torch.mcem.fused_engine import _dec_parts
from guided_vae_nmf_torch.mcem.mh_chain import fast_exp, fast_log
from guided_vae_nmf_torch.models import module_from_params
from guided_vae_nmf_torch.pipeline import (
    _fast_kwargs,
    bucket_frames,
    enhance_waveform,
)

torch.set_num_threads(2)

B, F, N, L, H, K, Y = 2, 65, 128, 8, 16, 3, 10
TOL = dict(atol=2e-5, rtol=2e-4)
LOOSE = dict(atol=1e-5, rtol=1e-2)
LEVELS = {"bf16": dict(approx_trans=False), "trans": dict(approx_trans=True)}


def _case(seed):
    rng = np.random.RandomState(seed)
    dgm = dgm_init(jax.random.PRNGKey(seed), [F, Y, L, [H, H]])
    dec = dgm["decoder"]
    l0 = dec["hidden"][0]
    y = (rng.uniform(size=(B, N, Y)) > 0.5).astype(np.float32)
    Z = rng.randn(B, N, L).astype(np.float32)
    zin = np.concatenate([Z, y], axis=-1).reshape(B * N, -1)
    return {
        "dgm": dgm, "Z": Z,
        "ypre": np.asarray(jnp.einsum("bny,yh->bnh", y, l0["w"][L:])
                           + l0["b"]),
        "Vs": np.asarray(decoder_apply(dec, zin)).reshape(B, N, F),
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


def _t(a):
    return torch.tensor(np.asarray(a))


def assert_within_one_bf16_ulp(got, want):
    """Positive bfloat16 values: equal or neighbours, and rarely apart."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    ulp = 2.0 ** (np.floor(np.log2(want)) - 7)
    assert np.all(np.abs(got - want) <= ulp)
    assert np.mean(got != want) < 1e-3


def test_fast_log_exp_equal_the_jax_helpers():
    rng = np.random.RandomState(0)
    x = np.concatenate([
        10.0 ** rng.uniform(-30, 30, 50000),     # Vx range above VX_FLOOR
        rng.uniform(6e-8, 1.0, 20000),           # accept-test uniforms
    ]).astype(np.float32)
    y = np.concatenate([rng.uniform(-87.0, 88.0, 50000),
                        [-100.0, -87.0, 0.0, 88.0, 100.0]]).astype(np.float32)
    for ours, theirs, arg in ((fast_log, _fast_log, x),
                              (fast_exp, _fast_exp, y)):
        got = ours(torch.tensor(arg)).numpy()
        eager = np.asarray(theirs(jnp.asarray(arg)))
        assert np.array_equal(got.view(np.int32), eager.view(np.int32))
        jitted = np.asarray(jax.jit(theirs)(arg))
        assert_allclose(got, jitted, rtol=2.4e-7, atol=8e-6)
    assert np.abs(fast_log(torch.tensor(x)).numpy()
                  - np.log(x.astype(np.float64))).max() < 1e-5


def _jax_chain(c, mode, ns, bi, noise, vb, **fast):
    return mh_chain_pallas(
        jax_dec_parts(c["dgm"]["decoder"], L), jnp.asarray(c["X2"]),
        jnp.asarray(c["Vb"]) if vb else None, jnp.asarray(c["g"]),
        jnp.asarray(c["ypre"]), jnp.asarray(c["Z"]), jnp.asarray(c["Vs"]),
        jnp.zeros((B, 1), jnp.int32), mode=mode, nsamples=ns, burnin=bi,
        var_RW=0.01, noise=tuple(jnp.asarray(a) for a in noise),
        WH=None if vb else (jnp.asarray(c["Wt"]), jnp.asarray(c["Hf"])),
        mask=jnp.asarray(c["mask"]) if mode == "e" and not vb else None,
        **fast)


def _torch_chain(fn, c, mode, ns, bi, noise, vb, **fast):
    dec_w = _dec_parts(module_from_params(c["dgm"]).decoder, L)
    return fn(dec_w, _t(c["X2"]), None if vb else (_t(c["Wt"]), _t(c["Hf"])),
              _t(c["g"]), _t(c["ypre"]), _t(c["Z"]), _t(c["Vs"]), mode=mode,
              nsamples=ns, burnin=bi, var_RW=0.01,
              noise=tuple(_t(a) for a in noise),
              mask=_t(c["mask"]) if mode == "e" and not vb else None,
              Vb=_t(c["Vb"]) if vb else None, **fast)


@pytest.mark.parametrize("level", sorted(LEVELS))
@pytest.mark.parametrize("form", ["wh", "vb"])
@pytest.mark.parametrize("mode", ["e", "wf"])
def test_fast_chain_matches_pallas(mode, form, level):
    """K1c's plain version (bfloat16 dumps in E-mode; approx_recip; and
    approx_trans at the 'trans' level) against the Pallas chain."""
    c = _case(1)
    ns, bi = (3, 2) if mode == "e" else (4, 3)
    noise = _noise(2, ns + bi)
    vb = form == "vb"
    trans = LEVELS[level]["approx_trans"]
    ref = _jax_chain(c, mode, ns, bi, noise, vb, approx_trans=trans,
                     samples_dtype=jnp.bfloat16)
    got = _torch_chain(mh_chain, c, mode, ns, bi, noise, vb,
                       samples_dtype=torch.bfloat16, approx_recip=True,
                       approx_trans=trans)
    outs = list(zip((got[0], got[1]) + got[2], (ref[0], ref[1]) + ref[2]))
    for i, (a, b) in enumerate(outs):
        assert tuple(a.shape) == tuple(b.shape)
        if mode == "e" and i == 2:               # the sample dumps
            assert a.dtype == torch.bfloat16 and b.dtype == jnp.bfloat16
            assert_within_one_bf16_ulp(a.float().numpy(),
                                       np.asarray(b, np.float32))
        else:
            assert a.dtype == torch.float32
            assert_allclose(a.numpy(), np.asarray(b), **TOL)
    # some proposals are accepted and some rejected, or the check is vacuous
    assert np.any(got[0].numpy() != c["Z"])
    if mode == "e":
        s = got[2][0].float().numpy()
        assert 0 < np.mean(np.any(s[:, 1:] != s[:, :-1], axis=-1)) < 1


def test_trans_chain_tracks_the_exact_chain():
    """approx_trans changes the chain only at float32 rounding: the same
    accept decisions under the same streams (as the JAX package's
    test_approx_trans_chain_matches_exact shows for its kernel)."""
    c = _case(3)
    noise = _noise(4, 5)
    exact = _torch_chain(mh_chain_ref, c, "e", 3, 2, noise, True)
    trans = _torch_chain(mh_chain_ref, c, "e", 3, 2, noise, True,
                         approx_trans=True)
    assert not torch.equal(exact[1], trans[1])
    assert_allclose(trans[0].numpy(), exact[0].numpy(), atol=1e-5)
    for a, b in zip((trans[1],) + trans[2], (exact[1],) + exact[2]):
        assert_allclose(a.numpy(), b.numpy(), rtol=1e-4)


def _sums_case(seed):
    c = _case(seed)
    samples = np.random.RandomState(seed + 1).uniform(
        0.01, 2.0, (B, 4, N, F)).astype(np.float32)
    return c, jnp.asarray(samples, jnp.bfloat16)


def _jax_sums(c, samples, mode, form, approx_recip):
    vb = form == "vb"
    return nmf_sums_pallas(
        samples, jnp.asarray(c["Vb"]) if vb else None, jnp.asarray(c["g"]),
        X2=jnp.asarray(c["X2"]), mode=mode, approx_recip=approx_recip,
        WH=None if vb else (jnp.asarray(c["Wt"]), jnp.asarray(c["Hf"])))


def _torch_sums(c, samples, mode, form):
    vb = form == "vb"
    return nmf_sums(torch.tensor(np.asarray(samples, np.float32)).to(
        torch.bfloat16), None if vb else (_t(c["Wt"]), _t(c["Hf"])),
        _t(c["g"]), _t(c["X2"]), mode=mode, Vb=_t(c["Vb"]) if vb else None,
        approx_recip=True)


@pytest.mark.parametrize("form", ["wh", "vb"])
@pytest.mark.parametrize("mode", ["h", "g"])
def test_fast_sums_match_pallas(mode, form):
    """K2c's plain version over bfloat16 samples against the Pallas sums
    (exact reciprocal on the JAX side)."""
    c, samples = _sums_case(5)
    ref = _jax_sums(c, samples, mode, form, approx_recip=False)
    got = _torch_sums(c, samples, mode, form)
    for a, b in zip(got, ref):
        assert a.dtype == torch.float32
        assert tuple(a.shape) == tuple(np.shape(b))
        assert_allclose(a.numpy(), np.asarray(b), **TOL)


@pytest.mark.parametrize("form", ["wh", "vb"])
@pytest.mark.parametrize("mode", ["h", "g"])
def test_pallas_approx_recip_within_loose_tolerance(mode, form):
    """The Pallas sums with the interpreter's approximate reciprocal stay
    within rtol 1e-2 of the port's (its error, about 4e-3 relative per
    reciprocal, enters squared in the inv^2 sums)."""
    c, samples = _sums_case(7)
    ref = _jax_sums(c, samples, mode, form, approx_recip=True)
    exact = _jax_sums(c, samples, mode, form, approx_recip=False)
    got = _torch_sums(c, samples, mode, form)
    for a, b, e in zip(got, ref, exact):
        assert_allclose(a.numpy(), np.asarray(b), **LOOSE)
        # the interpreter's reciprocal really is approximate
        assert not np.allclose(np.asarray(b), np.asarray(e), rtol=1e-5)


def _engine_inputs(seed):
    rng = np.random.RandomState(seed)
    X = rng.uniform(0.05, 1.05, (B, F, N)).astype(np.float32)
    X[:, :, 30:33] *= 50.0
    mask = (np.arange(N)[None] < np.array([[N], [N - 40]])).astype(
        np.float32)
    X = np.where(mask[:, None, :] > 0, X, 1.0).astype(np.float32)
    y = (rng.uniform(size=(B, Y, N)) > 0.5).astype(np.float32)
    init = {"W": rng.uniform(0.05, 1, (B, F, K)).astype(np.float32),
            "H": rng.uniform(0.05, 1, (B, K, N)).astype(np.float32),
            "g": rng.uniform(0.5, 1.5, (B, N)).astype(np.float32),
            "Z": rng.randn(B, L, N).astype(np.float32)}
    Vb = (rng.uniform(size=(B, F, N)) * 0.2 + 0.05).astype(np.float32)
    return X, mask, y, init, Vb


@pytest.mark.parametrize("level", sorted(LEVELS))
@pytest.mark.parametrize("noise", ["nmf", "fixed"])
def test_fast_driver_matches_jax_var0(noise, level):
    """`mcem_batch_fused` with the fast kwargs (bfloat16 dumps, approx_recip,
    no cost pass) against JAX's from the same warm start, niter=2, var_RW=0;
    rtol 2e-3 for one-bfloat16-ulp dump roundings carried through two
    multiplicative updates."""
    tree = dgm_init(jax.random.PRNGKey(0), [F, Y, L, [H, H]])
    X, mask, y, init, Vb = _engine_inputs(8)
    small = dict(niter=2, nsamples_E_step=2, burnin_E_step=1, nsamples_WF=2,
                 burnin_WF=1, nmf_rank=K, var_RW=0.0)
    fixed = noise == "fixed"
    over = dict(noise_gain=True) if fixed else {}
    trans = LEVELS[level]["approx_trans"]
    ref = jax_fused(tree, jnp.asarray(X), jnp.asarray(mask), jnp.asarray(y),
                    jax.random.split(jax.random.PRNGKey(2), B),
                    JaxConfig(**small, **over), update_nmf=not fixed,
                    Vb_fixed=jnp.asarray(Vb) if fixed else None,
                    init={k: jnp.asarray(v) for k, v in init.items()},
                    compute_cost=False, samples_dtype=jnp.bfloat16,
                    approx_trans=trans)
    got = mcem_batch_fused(module_from_params(tree), _t(X), _t(mask), _t(y),
                           torch.Generator().manual_seed(0),
                           MCEMConfig(**small, **over),
                           update_nmf=not fixed,
                           Vb_fixed=_t(Vb) if fixed else None,
                           init={k: _t(v) for k, v in init.items()},
                           compute_cost=False, samples_dtype=torch.bfloat16,
                           approx_recip=True, approx_trans=trans)
    assert set(got) == set(ref)
    assert not got["cost"].any() and not np.asarray(ref["cost"]).any()
    for k in ref:
        assert_allclose(got[k].numpy(), np.asarray(ref[k]), rtol=2e-3,
                        atol=2e-5, err_msg=k)


def test_fast_kwargs_levels():
    assert _fast_kwargs(False) == {} and _fast_kwargs(None) == {}
    assert _fast_kwargs(True) == dict(samples_dtype=torch.bfloat16,
                                      approx_recip=True, compute_cost=False)
    assert _fast_kwargs("trans") == dict(samples_dtype=torch.bfloat16,
                                         approx_recip=True,
                                         compute_cost=False,
                                         approx_trans=True)
    for k, v in _fast_kwargs("trans").items():
        if k != "samples_dtype":
            assert jax_pipeline._fast_kwargs("trans")[k] == v
    for bad in ("1", "fast", 2):
        with pytest.raises(ValueError, match="fast"):
            _fast_kwargs(bad)


def _mixtures(seed, seconds):
    rng = np.random.RandomState(seed)
    out = []
    for sec in seconds:
        t = np.arange(int(sec * 16000)) / 16000
        s = np.sin(2 * np.pi * 180 * t) * (0.5 - 0.5 * np.cos(8 * np.pi * t))
        out.append(np.round((0.3 * s + 0.05 * rng.randn(len(t))) * 32767)
                   .astype(np.int16))
    return out


@pytest.mark.parametrize("noise_model", ["nmf", "spp2"])
@pytest.mark.parametrize("fast", [True, "trans"])
def test_enhance_waveform_fast_matches_jax(monkeypatch, fast, noise_model):
    """`enhance_waveform(fast=...)` against JAX's whole-waveform program with
    its reciprocal exact, at var_RW=0 with dnn labels: the speech and noise
    tracks within 12 PCM16 LSB (the NMF path carries one-bfloat16-ulp dump
    roundings through 2 EM iterations; measured 9), packed labels equal."""
    padded = [pad_signal_for_stft(x) for x in _mixtures(1, (1.6, 1.1))]
    n_pad = bucket_frames(max(nf for _, nf in padded))
    Lw = (n_pad - 1) * 256 + 1024
    x_b = np.zeros((2, Lw), np.int16)
    mask = np.zeros((2, n_pad), np.float32)
    for j, (xp, nf) in enumerate(padded):
        x_b[j, : min(len(xp), Lw)] = xp[:Lw]
        mask[j, :nf] = 1.0
    Fw, Hw = 513, 16
    tree = dgm_init(jax.random.PRNGKey(0), [Fw, Fw, L, [Hw, Hw]])
    cls = classifier_init(jax.random.PRNGKey(1), [Fw, [Hw, Hw], Fw])
    keys = jax.random.split(jax.random.PRNGKey(2), 2)
    small = dict(niter=2, nsamples_E_step=2, burnin_E_step=1, nsamples_WF=2,
                 burnin_WF=1, nmf_rank=K, var_RW=0.0)
    real = jax_pipeline._fast_kwargs
    monkeypatch.setattr(jax_pipeline, "_fast_kwargs",
                        lambda f: {**real(f), "approx_recip": False})
    # unjitted, so the patched mapping is traced anew (the kernels and the
    # engine inside stay jitted, keyed on their own static options)
    ref = jax_pipeline._enhance_waveform_jit.__wrapped__(
        tree, jnp.asarray(x_b), None, None, cls, None, None,
        jnp.asarray(mask), keys, JaxConfig(**small), use_fused=True,
        noise_model=noise_model, fast=fast, label_mode="dnn")
    init = None
    if noise_model == "nmf":
        k_w, k_h = jax.random.split(jax.random.split(keys[0])[0])
        init = {"W": torch.tensor(np.asarray(jnp.maximum(
                    jax.random.uniform(k_w, (2, Fw, K)), 1e-8))),
                "H": torch.tensor(np.asarray(jnp.maximum(
                    jax.random.uniform(k_h, (2, K, n_pad)), 1e-8)))}
    got = enhance_waveform(module_from_params(tree), x_b, mask,
                           MCEMConfig(**small),
                           classifier=module_from_params(cls),
                           label_mode="dnn", noise_model=noise_model,
                           fast=fast, init=init, device="cpu")
    for i in (0, 1):
        diff = np.abs(got[i].numpy().astype(np.int32)
                      - np.asarray(ref[i]).astype(np.int32))
        assert diff.max() <= 12, (i, diff.max())
    assert np.array_equal(got[3].numpy(), np.asarray(ref[3]))
    assert got[4].all() and np.asarray(ref[4]).all()
