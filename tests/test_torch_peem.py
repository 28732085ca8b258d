"""PEEM and the PEEM -> MCEM hybrid: the port against the JAX package on the
CPU.

- The eager helpers (`_precompute_label_proj`, `_decode_cond`,
  `nmf_m_step` with and without the noise gain, `_masked_cost`,
  `noise_gain_state` in the reference layout) against `engine.py`, per
  utterance: rtol 2e-4 / atol 2e-5 (float32, sums in another order).
- `peem_m1_batch` / `peem_m2_batch` against JAX's from JAX's own NMF init
  (rebuilt from the keys as `peem_run` draws it, passed as `init=`):
  rtol 2e-4 / atol 2e-5 after 6 EM iterations of 3 gradient steps (the
  gradient differs from `jax.grad`'s by float32 rounding).
- `peem_mcem_m2_batch` against JAX's at var_RW=0, where the refinement's
  chains are deterministic: rtol 2e-4 / atol 2e-5.
- `enhance_waveform` with `PEEMConfig` and `HybridConfig(var_RW=0)` on the
  spp and spp2 noise models, which draw no random init, against
  `_enhance_waveform_jit`: PCM16 within 2 LSB over each utterance's own
  samples, packed labels equal. Past an utterance's end lie the ISTFT
  tail of its reflect padding, which every caller trims; in its last
  samples the masked ISTFT divides by a window sum near zero, and there
  the float32 differences of the two STFTs reach tens of LSB (measured 14
  and 39 with spp2).
- `framewise_uniform`: the same init whatever the padded length.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

from guided_vae_nmf_tpu.mcem import HybridConfig as JaxHybrid
from guided_vae_nmf_tpu.mcem import MCEMConfig as JaxMCEM
from guided_vae_nmf_tpu.mcem import PEEMConfig as JaxPEEM
from guided_vae_nmf_tpu.mcem import engine as jax_engine
from guided_vae_nmf_tpu.mcem import peem as jax_peem
from guided_vae_nmf_tpu.models import classifier_init, dgm_init, vae_init
from guided_vae_nmf_tpu.pipeline import _enhance_waveform_jit
from guided_vae_nmf_torch.dsp import pad_signal_for_stft
from guided_vae_nmf_torch.mcem import (
    HybridConfig,
    MCEMConfig,
    PEEMConfig,
    peem_m1_batch,
    peem_m2_batch,
    peem_mcem_m2_batch,
)
from guided_vae_nmf_torch.mcem.engine import (
    _decode_cond,
    _masked_cost,
    _precompute_label_proj,
    framewise_uniform,
    nmf_m_step,
    noise_gain_state,
)
from guided_vae_nmf_torch.models import module_from_params
from guided_vae_nmf_torch.pipeline import (
    _spp2_pass1_cfg,
    bucket_frames,
    enhance_files,
    enhance_to_audio,
    enhance_waveform,
    validate_noise_model,
)
from guided_vae_nmf_torch.data import write_wav

torch.set_num_threads(2)

B, F, N, L, H, K, Y = 2, 65, 128, 8, 16, 3, 10
TOL = dict(rtol=2e-4, atol=2e-5)
SMALL = dict(niter=6, e_steps=3, nmf_rank=K)


def _t(a):
    return None if a is None else torch.tensor(np.asarray(a))


def _inputs(seed, y_dim=Y):
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


def _jax_peem_init(keys, cfg):
    """The NMF init `peem_run` draws from each utterance's key."""
    Ws, Hs = [], []
    for key in keys:
        _, k_w, k_h = jax.random.split(key, 3)
        Ws.append(jnp.maximum(jax.random.uniform(k_w, (F, cfg.nmf_rank)),
                              cfg.eps))
        Hs.append(jnp.maximum(jax_engine.framewise_uniform(
            k_h, cfg.nmf_rank, N), cfg.eps))
    return {"W": _t(jnp.stack(Ws)), "H": _t(jnp.stack(Hs))}


def _assert_results_match(got, ref, keys=None):
    keys = keys or list(ref)
    assert set(got) == set(ref)
    for k in keys:
        assert tuple(got[k].shape) == tuple(np.shape(ref[k])), k
        assert_allclose(got[k].numpy(), np.asarray(ref[k]), err_msg=k, **TOL)


def test_configs_equal_the_jax_package():
    assert dataclasses.asdict(PEEMConfig()) == dataclasses.asdict(JaxPEEM())
    assert dataclasses.asdict(HybridConfig()) == \
        dataclasses.asdict(JaxHybrid())
    cfg = HybridConfig(niter=7, refine=3, var_RW=0.0, nmf_rank=4)
    ours = cfg.split()
    theirs = JaxHybrid(**dataclasses.asdict(cfg)).split()
    assert dataclasses.asdict(ours[0]) == dataclasses.asdict(theirs[0])
    assert dataclasses.asdict(ours[1]) == dataclasses.asdict(theirs[1])
    assert isinstance(ours[1], MCEMConfig)
    assert dataclasses.asdict(MCEMConfig()) == dataclasses.asdict(JaxMCEM())


@pytest.mark.parametrize("model", ["m2", "m1"])
def test_label_proj_and_decode_match_jax(model):
    rng = np.random.RandomState(3)
    if model == "m2":
        tree = dgm_init(jax.random.PRNGKey(1), [F, Y, L, [H, H]])
        y = (rng.uniform(size=(B, Y, N)) > 0.5).astype(np.float32)
    else:
        tree = vae_init(jax.random.PRNGKey(1), [F, L, [H, H]])
        y = None
    dec = module_from_params(tree).decoder
    Z = rng.randn(B, L, N).astype(np.float32)
    ypre = _precompute_label_proj(dec, _t(y), L)
    Vs = _decode_cond(dec, ypre, _t(Z))
    assert Vs.shape == (B, F, N)
    for b in range(B):
        ref_pre = jax_engine._precompute_label_proj(
            tree["decoder"], None if y is None else jnp.asarray(y[b]), L)
        assert_allclose(ypre[0 if y is None else b].numpy(),
                        np.asarray(ref_pre), **TOL)
        ref = jax_engine._decode_cond(tree["decoder"], ref_pre,
                                      jnp.asarray(Z[b]))
        assert_allclose(Vs[b].numpy(), np.asarray(ref), **TOL)


def _m_step_case(seed, R):
    rng = np.random.RandomState(seed)
    X = rng.uniform(0.05, 1.05, (B, F, N)).astype(np.float32)
    X[:, :8, 30:33] *= 50.0
    mask = np.ones((B, N), np.float32)
    mask[0, N - 30:] = 0.0
    return dict(
        X=X, mask=mask,
        W=rng.uniform(0.05, 1, (B, F, K)).astype(np.float32),
        H=rng.uniform(0.05, 1, (B, K, N)).astype(np.float32),
        g=rng.uniform(0.5, 1.5, (B, N)).astype(np.float32),
        Vs=rng.uniform(0.01, 2.0, (B, R, F, N)).astype(np.float32),
        Vb=rng.uniform(0.05, 0.3, (B, F, N)).astype(np.float32))


@pytest.mark.parametrize("case", ["nmf", "nmf_floor", "fixed", "gain1",
                                  "gain2"])
@pytest.mark.parametrize("R", [1, 3])
def test_nmf_m_step_matches_jax(case, R):
    """W -> Vb -> H -> L1 normalisation -> g with the masked W sums; the
    additive-floor form (nmf_floor: W H + Vb_fixed); g alone at a fixed
    Vb; the noise gain b per frame and on 2 bands."""
    c = _m_step_case(12, R)
    update_nmf = case.startswith("nmf")
    Vbf = c["Vb"] if case != "nmf" else None
    bands = {"gain1": 1, "gain2": 2}.get(case)
    kw, jkw, b0 = {}, {}, None
    if bands:
        b0, _, band_map = noise_gain_state(F, N, bands, _t(Vbf), B,
                                           frames_major=False)
        b0 = b0 * torch.linspace(0.8, 1.2, N)
        kw = dict(b=b0, band_map=band_map)
    got = nmf_m_step(_t(c["X"]), _t(c["mask"]), _t(c["W"]), _t(c["H"]),
                     _t(c["g"]), _t(c["Vs"]), update_nmf=update_nmf,
                     Vb_fixed=_t(Vbf), **kw)
    for b in range(B):
        if bands:
            jb, _, jmap = jax_engine.noise_gain_state(
                F, N, bands, jnp.asarray(Vbf[b]), jnp.float32)
            jkw = dict(b=jnp.asarray(b0[b].numpy()), band_map=jmap)
        ref = jax_engine.nmf_m_step(
            jnp.asarray(c["X"][b]), jnp.asarray(c["mask"][b]),
            jnp.asarray(c["W"][b]), jnp.asarray(c["H"][b]),
            jnp.asarray(c["g"][b]), jnp.asarray(c["Vs"][b]),
            update_nmf=update_nmf,
            Vb_fixed=None if Vbf is None else jnp.asarray(Vbf[b]), **jkw)
        assert len(got) == len(ref)
        for name, a, r in zip("WHgb", got, ref):
            assert_allclose(a[b].numpy(), np.asarray(r), err_msg=name, **TOL)


def test_masked_cost_matches_jax():
    c = _m_step_case(13, 3)
    got = _masked_cost(_t(c["X"]), _t(c["mask"]), _t(c["Vb"]), _t(c["g"]),
                       _t(c["Vs"]))
    assert got.shape == (B,)
    for b in range(B):
        ref = jax_engine._masked_cost(
            jnp.asarray(c["X"][b]), jnp.asarray(c["mask"][b]),
            jnp.asarray(c["Vb"][b]), jnp.asarray(c["g"][b]),
            jnp.asarray(c["Vs"][b]))
        assert_allclose(got[b].item(), float(ref), **TOL)


@pytest.mark.parametrize("bands", [1, 3])
def test_noise_gain_state_reference_layout(bands):
    """The reference layout (B, F, N) is the JAX unbatched layout with a
    batch axis, and the transpose of the fused engine's."""
    Vb = torch.rand((B, F, N)) + 0.1
    b0, eff, band_map = noise_gain_state(F, N, bands, Vb, B,
                                         frames_major=False)
    b = b0 * torch.linspace(0.5, 2.0, N)
    _, eff_fm, _ = noise_gain_state(F, N, bands, Vb.transpose(1, 2), B)
    assert torch.allclose(eff(b), eff_fm(b).transpose(1, 2))
    for i in range(B):
        _, jeff, _ = jax_engine.noise_gain_state(
            F, N, bands, jnp.asarray(Vb[i].numpy()), jnp.float32)
        assert_allclose(eff(b)[i].numpy(), np.asarray(jeff(
            jnp.asarray(b[i].numpy()))), rtol=1e-6)


def test_framewise_uniform_is_padding_invariant():
    a = framewise_uniform(7, (B, K, 128), "cpu")
    b = framewise_uniform(7, (B, K, 256), "cpu")
    assert a.shape == (B, K, 128) and a.dtype == torch.float32
    assert torch.equal(a, b[..., :128])
    assert not torch.equal(a, framewise_uniform(8, (B, K, 128), "cpu"))
    assert not torch.equal(a, framewise_uniform(7, (B, K, 128), "cpu",
                                                stream=1))
    assert not torch.equal(a[0], a[1])
    big = framewise_uniform(3, (64, 1024), "cpu")
    assert 0.0 <= big.min() and big.max() < 1.0
    assert abs(big.mean().item() - 0.5) < 0.01
    assert abs(big.var().item() - 1 / 12) < 0.005


def test_peem_init_depends_on_the_seed_not_the_state():
    """PEEM's init comes from the generator's seed: the same for any
    padded length on its valid frames, whatever the generator has drawn."""
    tree = dgm_init(jax.random.PRNGKey(0), [F, Y, L, [H, H]])
    model = module_from_params(tree)
    X, mask, y, _ = _inputs(4)
    cfg = PEEMConfig(niter=1, e_steps=1, nmf_rank=K)
    gen = torch.Generator().manual_seed(5)
    a = peem_m2_batch(model, _t(X), _t(mask), _t(y), gen, cfg)
    torch.rand(3, generator=gen)
    pad = N + 128
    Xp = np.ones((B, F, pad), np.float32)
    Xp[..., :N] = X
    mp = np.zeros((B, pad), np.float32)
    mp[:, :N] = mask
    yp = np.zeros((B, Y, pad), np.float32)
    yp[..., :N] = y
    b = peem_m2_batch(model, _t(Xp), _t(mp), _t(yp), gen, cfg)
    valid = mask > 0
    for k in ("WFs", "H"):
        assert_allclose(b[k].numpy()[..., :N][np.broadcast_to(
            valid[:, None], a[k].shape)], a[k].numpy()[np.broadcast_to(
                valid[:, None], a[k].shape)], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("case", ["m2", "m1", "fixed", "gain1", "gain2"])
def test_peem_matches_jax(case):
    """peem_m1_batch / peem_m2_batch against JAX's: NMF (M2 and M1) from
    JAX's init, the fixed noise model (update_nmf=False, Vb_fixed=), and
    the noise gain on 1 and 2 bands."""
    m1 = case == "m1"
    if m1:
        tree = vae_init(jax.random.PRNGKey(0), [F, L, [H, H]])
    else:
        tree = dgm_init(jax.random.PRNGKey(0), [F, Y, L, [H, H]])
    X, mask, y, Vb = _inputs(1, y_dim=0 if m1 else Y)
    fixed = case in ("fixed", "gain1", "gain2")
    over = {}
    if case.startswith("gain"):
        over = dict(noise_gain=True, noise_gain_bands=int(case[-1]))
    keys = jax.random.split(jax.random.PRNGKey(2), B)
    jcfg = JaxPEEM(**SMALL, **over)
    jargs = (tree, jnp.asarray(X), jnp.asarray(mask))
    jkw = dict(update_nmf=not fixed,
               Vb_fixed=jnp.asarray(Vb) if fixed else None)
    if m1:
        ref = jax_peem.peem_m1_batch(*jargs, keys, jcfg, **jkw)
    else:
        ref = jax_peem.peem_m2_batch(*jargs, jnp.asarray(y), keys, jcfg,
                                     **jkw)
    args = (module_from_params(tree), _t(X), _t(mask))
    kw = dict(update_nmf=not fixed, Vb_fixed=_t(Vb) if fixed else None,
              init=None if fixed else _jax_peem_init(keys, jcfg))
    gen = torch.Generator().manual_seed(0)
    cfg = PEEMConfig(**SMALL, **over)
    if m1:
        got = peem_m1_batch(*args, gen, cfg, **kw)
    else:
        got = peem_m2_batch(*args, _t(y), gen, cfg, **kw)
    _assert_results_match(got, ref)
    cost = got["cost"].numpy()
    assert np.all(np.isfinite(cost)) and np.all(cost[:, -1] < cost[:, 0])
    assert_allclose((got["WFs"] + got["WFn"]).numpy(), 1.0, atol=1e-5)


@pytest.mark.parametrize("noise_model", ["nmf", "fixed"])
def test_peem_mcem_hybrid_matches_jax_var0(noise_model):
    tree = dgm_init(jax.random.PRNGKey(0), [F, Y, L, [H, H]])
    X, mask, y, Vb = _inputs(5)
    fixed = noise_model == "fixed"
    chain = dict(nsamples_E_step=2, burnin_E_step=1, nsamples_WF=2,
                 burnin_WF=1, nmf_rank=K, var_RW=0.0)
    pkw = dict(niter=4, e_steps=2, nmf_rank=K)
    keys = jax.random.split(jax.random.PRNGKey(3), B)
    ref = jax_peem.peem_mcem_m2_batch(
        tree, jnp.asarray(X), jnp.asarray(mask), jnp.asarray(y), keys,
        JaxPEEM(**pkw), JaxMCEM(niter=2, **chain), update_nmf=not fixed,
        Vb_fixed=jnp.asarray(Vb) if fixed else None)
    got = peem_mcem_m2_batch(
        module_from_params(tree), _t(X), _t(mask), _t(y),
        torch.Generator().manual_seed(0), PEEMConfig(**pkw),
        MCEMConfig(niter=2, **chain), update_nmf=not fixed,
        Vb_fixed=_t(Vb) if fixed else None,
        init=None if fixed else _jax_peem_init(keys, JaxPEEM(**pkw)))
    assert got["cost"].shape == (B, 4 + 2)
    _assert_results_match(got, ref)


def _mixtures(seed, seconds):
    rng = np.random.RandomState(seed)
    out = []
    for sec in seconds:
        t = np.arange(int(sec * 16000)) / 16000
        s = np.sin(2 * np.pi * 180 * t) * (0.5 - 0.5 * np.cos(8 * np.pi * t))
        out.append(np.round((0.3 * s + 0.05 * rng.randn(len(t))) * 32767)
                   .astype(np.int16))
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


HYBRID_SMALL = dict(niter=3, refine=2, e_steps=2, nmf_rank=K,
                    nsamples_E_step=2, burnin_E_step=1, nsamples_WF=2,
                    burnin_WF=1, var_RW=0.0)


@pytest.mark.parametrize("noise_model", ["spp", "spp2"])
@pytest.mark.parametrize("algorithm", ["peem", "hybrid"])
def test_enhance_waveform_peem_and_hybrid_match_jax(algorithm, noise_model):
    """The whole waveform program with PEEM and the hybrid (var_RW=0) on
    the fixed-noise models, dnn labels: PCM16 within 2 LSB on each
    utterance's samples (float32 STFT / ISTFT of two FFT libraries; see
    the module docstring for the padding tail), packed labels equal."""
    xs = _mixtures(2, (1.3, 0.9))
    x_b, mask = _batch(xs)
    Fw = 513
    tree = dgm_init(jax.random.PRNGKey(0), [Fw, Fw, L, [H, H]])
    cls = classifier_init(jax.random.PRNGKey(1), [Fw, [H, H], Fw])
    if algorithm == "peem":
        jcfg, cfg = JaxPEEM(**SMALL), PEEMConfig(**SMALL)
    else:
        jcfg, cfg = JaxHybrid(**HYBRID_SMALL), HybridConfig(**HYBRID_SMALL)
    ref = _enhance_waveform_jit(
        tree, jnp.asarray(x_b), None, None, cls, None, None,
        jnp.asarray(mask), jax.random.split(jax.random.PRNGKey(2), 2), jcfg,
        use_fused=True, noise_model=noise_model, label_mode="dnn")
    got = enhance_waveform(module_from_params(tree), x_b, mask, cfg,
                           classifier=module_from_params(cls),
                           label_mode="dnn", noise_model=noise_model,
                           device="cpu")
    for i in (0, 1):
        assert got[i].shape == ref[i].shape
        for j, x in enumerate(xs):
            diff = np.abs(got[i].numpy()[j, :len(x)].astype(np.int32)
                          - np.asarray(ref[i])[j, :len(x)].astype(np.int32))
            assert diff.max() <= 2, (i, j, diff.max())
    assert np.array_equal(got[3].numpy(), np.asarray(ref[3]))
    assert got[4].all() and np.asarray(ref[4]).all()


def test_hybrid_refines_on_the_eager_engine():
    """HybridConfig with engine='xla': PEEM, then the eager engine's
    refinement, against the JAX package's `use_fused=False` (spp noise
    model, var_RW=0): PCM16 within 2 LSB on each utterance's samples."""
    xs = _mixtures(3, (1.1, 0.8))
    x_b, mask = _batch(xs)
    Fw = 513
    tree = dgm_init(jax.random.PRNGKey(0), [Fw, Fw, L, [H, H]])
    y_in = (np.random.RandomState(4).uniform(size=(2, Fw, mask.shape[1]))
            > 0.5).astype(np.float32)
    ref = _enhance_waveform_jit(
        tree, jnp.asarray(x_b), None, jnp.asarray(y_in), None, None, None,
        jnp.asarray(mask), jax.random.split(jax.random.PRNGKey(2), 2),
        JaxHybrid(**HYBRID_SMALL), use_fused=False, noise_model="spp",
        label_mode="host")
    got = enhance_waveform(module_from_params(tree), x_b, mask,
                           HybridConfig(**HYBRID_SMALL), y_in=y_in,
                           label_mode="host", noise_model="spp",
                           engine="xla", device="cpu")
    for i in (0, 1):
        for j, x in enumerate(xs):
            diff = np.abs(got[i].numpy()[j, :len(x)].astype(np.int32)
                          - np.asarray(ref[i])[j, :len(x)].astype(np.int32))
            assert diff.max() <= 2, (i, j, diff.max())


def test_other_entry_points_take_peem_and_hybrid(tmp_path):
    """enhance_to_audio and enhance_files run PEEM and the hybrid with the
    nmf noise model; the hybrid's fast mode changes its output."""
    Fw = 513
    model = module_from_params(dgm_init(jax.random.PRNGKey(4),
                                        [Fw, Fw, L, [H, H]]))
    xs = _mixtures(6, (0.8, 0.6))
    x_b, mask = _batch(xs[:1])
    from guided_vae_nmf_torch.dsp.stft import stft_batch_padded

    X = stft_batch_padded(torch.tensor(x_b.astype(np.float32) / 32768))
    X_tf = X[0, :, :int(mask.sum())].numpy()
    y = (np.abs(X_tf) > 0.01).astype(np.float32)
    hyb = HybridConfig(**{**HYBRID_SMALL, "var_RW": 0.01})
    outs = {}
    for name, cfg, fast in (("peem", PEEMConfig(**SMALL), False),
                            ("hybrid", hyb, False), ("hybrid_fast", hyb,
                                                     True)):
        s, n = enhance_to_audio(model, [X_tf], [12800], [y], cfg=cfg,
                                fast=fast, device="cpu")
        assert s[0].shape == n[0].shape == (12800,)
        assert np.isfinite(s[0]).all() and np.isfinite(n[0]).all()
        outs[name] = s[0]
    assert not np.allclose(outs["hybrid"], outs["hybrid_fast"])
    src = tmp_path / "in"
    src.mkdir()
    files = []
    for j, x in enumerate(xs):
        write_wav(str(src / f"u{j}_x.wav"), x, 16000)
        files.append(f"u{j}.wav")
    res = enhance_files(files, str(src), str(tmp_path / "out"), model,
                        classif_type="ones", cfg=PEEMConfig(**SMALL),
                        noise_model="spp2", device="cpu")
    assert res.n_processed == 2
    assert (tmp_path / "out" / "u1_s_est.wav").exists()


def test_spp2_first_pass_config_takes_any_engine_config():
    """spp2's first pass shortens an MCEMConfig and leaves PEEM and hybrid
    configs (which have no spp2_pass1_niter) as they are."""
    assert _spp2_pass1_cfg(MCEMConfig()).niter == 25
    assert _spp2_pass1_cfg(MCEMConfig(niter=10)).niter == 10
    for cfg in (PEEMConfig(), HybridConfig()):
        assert _spp2_pass1_cfg(cfg) is cfg


def test_hybrid_config_refuses_the_hybrid_noise_model():
    with pytest.raises(ValueError, match="hybrid"):
        validate_noise_model("hybrid", HybridConfig())
    for nm in ("nmf", "spp", "spp2"):
        validate_noise_model(nm, HybridConfig())
    with pytest.raises(ValueError, match="noise_gain"):
        validate_noise_model("nmf", PEEMConfig(noise_gain=True))
    x_b, mask = _batch(_mixtures(9, (0.5,)))
    model = module_from_params(dgm_init(jax.random.PRNGKey(9),
                                        [513, 513, L, [H, H]]))
    with pytest.raises(ValueError, match="hybrid"):
        enhance_waveform(model, x_b, mask, HybridConfig(**HYBRID_SMALL),
                         label_mode="ones", noise_model="hybrid",
                         device="cpu")
    # PEEM takes the hybrid noise model (Vb = W H + the SPP PSD in its
    # M-step), as the JAX package's does
    out = enhance_waveform(model, x_b, mask, PEEMConfig(**SMALL),
                           label_mode="ones", noise_model="hybrid",
                           device="cpu")
    assert out[4].all()
