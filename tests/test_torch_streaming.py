"""The port's streaming enhancers (guided_vae_nmf_torch/streaming.py) held
against the JAX package's on the CPU, module by module and as whole
streams, on seeded synthetic signals with small models (the M2 model is
JAX's `dgm_init([513, 513, 8, [32]])` carried across by
`module_from_params`, as JAX's own `_m2_cfg` shapes it).

Tolerances: enhanced frames and masks atol 2e-5 / rtol 1e-4 (two float32
FFT libraries and summation orders); SPP masks against `timo_mask` atol
1e-6; whole streams atol 2e-5 / rtol 1e-4 against JAX, and the Wiener
stream within 2e-6 of the port's offline program before PCM16. Every
state leaf of the M2 tick is compared after each tick at atol 1e-4 /
rtol 1e-4 (the tracker's noise PSD carries the bin powers, up to ~1e2)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

import guided_vae_nmf_tpu.streaming as J
from guided_vae_nmf_tpu.mcem.engine import _noise_gain_band_map as j_band_map
from guided_vae_nmf_tpu.mcem.engine import _precompute_label_proj as j_proj
from guided_vae_nmf_tpu.mcem.spp import spp_state_init as j_spp_init
from guided_vae_nmf_tpu.models import classifier_init, dgm_init
import guided_vae_nmf_torch.streaming as T
from guided_vae_nmf_torch.dsp import pad_signal_for_stft
from guided_vae_nmf_torch.mcem.engine import _precompute_label_proj
from guided_vae_nmf_torch.mcem.spp import timo_mask
from guided_vae_nmf_torch.models import module_from_params
from guided_vae_nmf_torch.pipeline import _wiener_waveform

torch.set_num_threads(2)

TOL = dict(atol=2e-5, rtol=1e-4)
STATE_TOL = dict(atol=1e-4, rtol=1e-4)
NFFT, F = 1024, 513


@functools.lru_cache(maxsize=None)
def _dgm(y_dim=513, seed=0):
    return dgm_init(jax.random.PRNGKey(seed), [513, y_dim, 8, [32]])


@functools.lru_cache(maxsize=None)
def _cls(seed=3, hidden=(16,)):
    return classifier_init(jax.random.PRNGKey(seed), [513, list(hidden), 513])


def _mods(*trees):
    return [module_from_params(t) for t in trees]


def _signal(seed, n, impulse=False):
    rng = np.random.RandomState(seed)
    t = np.arange(n) / 16000
    s = 0.1 * np.sin(2 * np.pi * np.cumsum(
        120 + (20 + 10 * seed) * np.sin(2 * np.pi * 0.9 * t)) / 16000)
    s *= np.clip(np.sin(2 * np.pi * 1.5 * t + seed), 0, None)
    x = s + 0.03 * rng.randn(n)
    if impulse:
        x[n // 3:n // 3 + 400] += 1.0 * rng.randn(400)
    return x.astype(np.float32)


def _frames(seed, k):
    return (0.1 * np.random.RandomState(seed).randn(k, NFFT)).astype(
        np.float32)


def _norm(seed=4):
    rng = np.random.RandomState(seed)
    return (rng.rand(513).astype(np.float32),
            (rng.rand(513) + 0.5).astype(np.float32))


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, tuple):
        return [x for t in tree for x in _leaves(t)]
    return [tree]


def _drive(enh, x, sizes):
    out, lo, i = [], 0, 0
    while lo < len(x):
        n = sizes[i % len(sizes)]
        out.append(enh.push(x[lo:lo + n]))
        lo += n
        i += 1
    out.append(enh.flush())
    return np.concatenate(out)


# ---------------------------------------------------------------------------
# module by module
# ---------------------------------------------------------------------------


def test_wiener_frames_match_jax():
    cls = _cls(hidden=(32, 32))
    mean, std = _norm()
    frames = _frames(0, 6)
    yj, mj = J._wiener_frames_jit(cls, jnp.asarray(frames), jnp.asarray(mean),
                                  jnp.asarray(std))
    (mod,) = _mods(cls)
    yt, mt = T._wiener_frames(mod, torch.tensor(frames), torch.tensor(mean),
                              torch.tensor(std), T._window("cpu"))
    assert_allclose(yt.numpy(), np.asarray(yj), **TOL)
    assert mt.dtype == torch.float16
    assert_allclose(mt.float().numpy(), np.asarray(mj, np.float32), atol=1e-3)


@pytest.mark.parametrize("ks", [(8, 8, 3), (5, 8)])
def test_spp_tick_matches_jax_with_state(ks):
    st_j = j_spp_init(F)
    st_t = T.spp_state_init(F)
    window = T._window("cpu")
    for i, k in enumerate(ks):
        frames = _frames(10 + i, 8)
        yj, mj, st_j = J._spp_tick_jit(jnp.asarray(frames), k, st_j)
        yt, mt, st_t = T._spp_tick(torch.tensor(frames), k, st_t, window)
        assert_allclose(yt.numpy(), np.asarray(yj), **TOL)
        assert_allclose(mt.numpy(), np.asarray(mj), **TOL)
        for a, b in zip(st_t, st_j):
            assert_allclose(a.numpy(), np.asarray(b), **STATE_TOL)


def _block_inputs(P, W=16, L=8, n_bands=1, seed=0):
    rng = np.random.RandomState(seed)
    X = (rng.rand(P, F, W) ** 3 * 4).astype(np.float32) + 1e-6
    X[:, :, W // 3] *= 200.0                        # an impulse frame
    Vb = (0.1 + rng.rand(P, F, W)).astype(np.float32)
    y = (rng.rand(P, F, W) > 0.5).astype(np.float32)
    Z = rng.randn(P, L, W).astype(np.float32) * 0.3
    g = (0.5 + rng.rand(P, W)).astype(np.float32)
    b = (np.ones((P, W)) if n_bands == 1 else
         np.ones((P, n_bands, W))).astype(np.float32)
    mask = np.ones((P, W), np.float32)
    mask[:, :3] = 0.0                               # invalid context
    return X, Vb, y, Z, g, b, mask


BLOCK_CASES = {
    "gain off": dict(),
    "gain on": dict(noise_gain=True),
    "gain on, 2 bands": dict(noise_gain=True, n_bands=2),
    "adaptive": dict(noise_gain=True, adaptive_iters=4,
                     adaptive_thresh=0.01),
    "adaptive, escalate_reinit": dict(noise_gain=True, adaptive_iters=4,
                                      adaptive_thresh=0.01,
                                      escalate_reinit=True),
    "adaptive, escalate_reinit, 2 bands": dict(
        noise_gain=True, n_bands=2, adaptive_iters=3, adaptive_thresh=0.01,
        escalate_reinit=True),
}


@pytest.mark.parametrize("case", list(BLOCK_CASES))
def test_block_em_matches_jax(case):
    kw = dict(BLOCK_CASES[case])
    n_bands = kw.pop("n_bands", 1)
    dgm = _dgm()
    (mod,) = _mods(dgm)
    X, Vb, y, Z, g, b, mask = _block_inputs(2, n_bands=n_bands)
    band_t = (None if n_bands == 1 else
              T._noise_gain_band_map(F, n_bands))
    got = T._m2_block_em(
        mod.decoder, torch.tensor(X),
        _precompute_label_proj(mod.decoder, torch.tensor(y), 8),
        torch.tensor(Vb), torch.tensor(Z), torch.tensor(g), torch.tensor(b),
        torch.tensor(mask), iters=3, e_steps=2, band_map=band_t, **kw)
    extras = got[4].numpy()
    for p in range(2):
        fn = jax.jit(functools.partial(J._m2_block_em, iters=3, e_steps=2,
                                       n_bands=n_bands, **kw))
        want = fn(dgm["decoder"], jnp.asarray(X[p]),
                  j_proj(dgm["decoder"], jnp.asarray(y[p]), 8),
                  jnp.asarray(Vb[p]), jnp.asarray(Z[p]), jnp.asarray(g[p]),
                  jnp.asarray(b[p]), jnp.asarray(mask[p]))
        for name, a, w in zip(("Z", "g", "b", "WFs"), got[:4], want):
            assert_allclose(a[p].numpy(), np.asarray(w), atol=1e-4,
                            rtol=2e-4, err_msg=f"{case}: {name}, lane {p}")
    if "adaptive_iters" in kw:
        assert extras.max() > 0                     # the budget engaged
    else:
        assert not extras.any()


def test_block_em_lanes_are_independent():
    """Two lanes together give each lane's result alone: the adaptive loop
    keeps a finished lane's values while the other lane runs on (lane 1
    starts from its own converged gain, so it does not escalate)."""
    (mod,) = _mods(_dgm())
    X, Vb, y, Z, g, b, mask = (torch.tensor(a)
                               for a in _block_inputs(2, seed=1))
    pre = _precompute_label_proj(mod.decoder, y, 8)
    warm = T._m2_block_em(mod.decoder, X, pre, Vb, Z, g, b, mask, iters=40,
                          e_steps=2, noise_gain=True)
    for a, w in zip((Z, g, b), warm):
        a[1] = w[1]
    kw = dict(iters=2, e_steps=2, noise_gain=True, adaptive_iters=4,
              adaptive_thresh=0.05)

    def run(rows):
        return T._m2_block_em(mod.decoder, X[rows], pre[rows], Vb[rows],
                              Z[rows], g[rows], b[rows], mask[rows], **kw)

    both = run([0, 1])
    assert both[4].tolist() == [4, 0]               # different budgets
    for p in range(2):
        alone = run([p])
        for a, w in zip(both, alone):
            assert_allclose(a[p].numpy(), w[0].numpy(), atol=1e-6,
                            rtol=1e-5)


def _j_state(C, y_dim, L=8, n_bands=1):
    z, o = jnp.zeros, jnp.ones
    return dict(spp=j_spp_init(F), vad=j_spp_init(1),
                res=(z((F,)), jnp.asarray(0.0, jnp.float32)),
                ctx_X=z((F, C)), ctx_y=z((y_dim, C)), ctx_Vb=o((F, C)),
                ctx_Z=z((L, C)), ctx_g=o((C,)),
                ctx_b=o((C,)) if n_bands == 1 else o((n_bands, C)),
                n_ctx=jnp.asarray(0, jnp.int32))


TICK_CASES = {
    "dnn, hard": dict(label_mode="dnn"),
    "timo, soft, residual": dict(label_mode="timo", soft_guidance=True,
                                 residual_tracking=True),
    "timo, VAD family": dict(label_mode="timo", y_dim=1),
    "dnn, log-power, gain ratio, 2 bands, adaptive": dict(
        label_mode="dnn", features="log-power", dnn_threshold=0.4,
        noise_gain=True, noise_gain_init="ratio", n_bands=2,
        adaptive_iters=3, escalate_reinit=True, residual_tracking=True),
    "timo, lookahead, gain": dict(label_mode="timo", lookahead=True,
                                  noise_gain=True),
}


@pytest.mark.parametrize("case", list(TICK_CASES))
def test_m2_tick_matches_jax_tick_core(case):
    """Four ticks (full, full, partial k < K, a k=0 drain) of the port's
    one-lane tick against JAX `_m2_tick_core` on the same state: outputs
    and every state leaf after each tick."""
    cfg = dict(TICK_CASES[case])
    y_dim = cfg.pop("y_dim", 513)
    n_bands = cfg.get("n_bands", 1)
    cfg.update(block_iters=2, e_steps=2)
    dgm, cls = _dgm(y_dim), _cls()
    mod, cmod = _mods(dgm, cls)
    mean, std = _norm(5)
    if cfg.get("features") == "log-power":
        mean, std = np.log(mean + 1e-3), std * 4
    C, K = 8, 4
    band_j = None if n_bands == 1 else j_band_map(F, n_bands)
    band_t = None if n_bands == 1 else T._noise_gain_band_map(F, n_bands)
    fn = jax.jit(functools.partial(J._m2_tick_core, **cfg))
    st_j = _j_state(C, y_dim, n_bands=n_bands)
    st_t = T._m2_state_init(1, F, y_dim, 8, C, n_bands, "cpu")
    frames_all = (_frames(20, 4 * K)
                  * np.linspace(0.2, 3, 4 * K)[:, None]).astype(np.float32)
    for i, k in enumerate((K, K, 3, 0)):
        frames = frames_all[i * K:(i + 1) * K].copy()
        frames[k:] = 0.0
        yj, mj, st_j = fn(dgm["encoder"], dgm["decoder"], cls,
                          jnp.asarray(mean), jnp.asarray(std), band_j,
                          jnp.asarray(frames), k, st_j)
        yt, mt, st_t, info = T._m2_tick(
            mod, cmod, torch.tensor(mean), torch.tensor(std), band_t,
            T._window("cpu"), torch.tensor(frames)[None],
            torch.tensor([k]), st_t, **cfg)
        assert_allclose(yt[0].numpy(), np.asarray(yj), atol=1e-4, rtol=2e-4,
                        err_msg=f"{case}: y, tick {i}")
        assert_allclose(mt[0].numpy(), np.asarray(mj), atol=1e-4, rtol=2e-4,
                        err_msg=f"{case}: m, tick {i}")
        # JAX's tree orders dict keys sorted, as `_leaves` does
        flat = jax.tree_util.tree_flatten_with_path(st_j)[0]
        names = [jax.tree_util.keystr(p) for p, _ in flat]
        want = [w for _, w in flat]
        got = _leaves(st_t)
        assert len(got) == len(want)
        for name, a, w in zip(names, got, want):
            assert_allclose(a[0].double().numpy(),
                            np.asarray(w, np.float64), **STATE_TOL,
                            err_msg=f"{case}: {name}, tick {i}")
        assert info["labels"].shape == (1, K, y_dim)


# ---------------------------------------------------------------------------
# whole streams
# ---------------------------------------------------------------------------


def test_wiener_stream_equals_offline_and_jax():
    """Ragged pushes: the stream equals the port's offline program before
    PCM16 and JAX's stream."""
    cls = _cls(hidden=(32, 32))
    (mod,) = _mods(cls)
    mean, std = _norm()
    x = _signal(1, 19000)
    rng = np.random.RandomState(1)
    sizes = list(rng.randint(160, 4000, 12))
    got = _drive(T.StreamingWienerEnhancer(mod, mean, std, device="cpu"), x,
                 sizes)
    want = _drive(J.StreamingWienerEnhancer(cls, mean, std), x, sizes)
    assert len(got) == len(x)
    assert_allclose(got, want, **TOL)

    xp, nf = pad_signal_for_stft(x)
    _, m_off = _wiener_waveform(mod, xp[None].astype(np.float32), mean, std,
                                np.ones((1, nf), np.float32))
    # the offline float track: the same program without the PCM16 step
    import guided_vae_nmf_torch.pipeline as pl

    orig = pl._to_pcm16
    try:
        pl._to_pcm16 = lambda w: w
        s_off, _ = _wiener_waveform(mod, xp[None].astype(np.float32), mean,
                                    std, np.ones((1, nf), np.float32))
    finally:
        pl._to_pcm16 = orig
    assert_allclose(got, s_off[0, :len(x)].numpy(), atol=2e-6)
    enh = T.StreamingWienerEnhancer(mod, mean, std, device="cpu")
    _drive(enh, x, [5000])
    assert_allclose(enh.masks.astype(np.float32),
                    m_off[0].float().numpy(), atol=1e-3)


def test_spp_stream_masks_equal_timo_mask_and_jax():
    x = _signal(2, 21000)
    enh = T.StreamingSPPEnhancer(chunk_frames=8, device="cpu")
    got = _drive(enh, x, [3000, 777, 4096])
    want = _drive(J.StreamingSPPEnhancer(chunk_frames=8), x,
                  [3000, 777, 4096])
    assert_allclose(got, want, **TOL)
    from guided_vae_nmf_torch.dsp import stft

    X = stft(x.astype(np.float64))
    whole = timo_mask(torch.tensor(np.abs(X) ** 2, dtype=torch.float32))
    assert enh.masks.shape == whole.shape
    assert_allclose(enh.masks.astype(np.float32), whole.numpy(), atol=1e-3)


STREAM_CASES = {
    "dnn hard": dict(label_mode="dnn"),
    "dnn soft, residual": dict(label_mode="dnn", soft_guidance=True,
                               residual_tracking=True),
    "timo hard": dict(label_mode="timo"),
    "timo VAD family": dict(label_mode="timo", y_dim=1),
    "real-noise settings": dict(label_mode="timo", soft_guidance=True,
                                residual_tracking=True, noise_gain=True),
    "streaming-low-latency settings": dict(
        label_mode="timo", soft_guidance=True, residual_tracking=True,
        noise_gain=True, noise_gain_bands=2, adaptive_iters=6),
    "lookahead, escalate_reinit": dict(
        label_mode="timo", noise_gain=True, adaptive_iters=4,
        escalate_reinit=True, lookahead=True),
    "lookahead, chunk 4, ratio init": dict(
        label_mode="timo", noise_gain=True, noise_gain_init="ratio",
        lookahead=True),
}


@pytest.mark.parametrize("case", list(STREAM_CASES))
def test_m2_stream_matches_jax(case):
    """A whole stream with ragged pushes (partial chunks included) through
    the port and JAX: output, masks and the state views."""
    kw = dict(STREAM_CASES[case])
    y_dim = kw.pop("y_dim", 513)
    kw.update(chunk_frames=4, context_frames=12, block_iters=2, e_steps=2)
    dgm, cls = _dgm(y_dim), _cls()
    mod, cmod = _mods(dgm, cls)
    mean, std = _norm(6)
    x = _signal(3, 15000, impulse=True)
    sizes = [700, 1900, 4096, 333]
    jk = dict(kw, mean=mean, std=std)
    tk = dict(jk, device="cpu")
    if kw["label_mode"] == "dnn":
        jk["classifier_params"] = cls
        tk["classifier"] = cmod
    ej = J.StreamingM2Enhancer(dgm, **jk)
    et = T.StreamingM2Enhancer(mod, **tk)
    got, want = _drive(et, x, sizes), _drive(ej, x, sizes)
    assert len(got) == len(x)
    assert_allclose(got, want, **TOL, err_msg=case)
    assert_allclose(et.masks.astype(np.float32),
                    ej.masks.astype(np.float32), atol=2e-3)
    assert_allclose(et._ctx_valid, ej._ctx_valid)
    assert_allclose(et._ctx_b, ej._ctx_b, **STATE_TOL)
    if kw.get("residual_tracking"):
        assert_allclose(et._res, ej._res, **STATE_TOL)


def test_m2_stream_independent_of_push_split():
    (mod,) = _mods(_dgm())
    kw = dict(label_mode="timo", chunk_frames=4, context_frames=12,
              block_iters=2, e_steps=2, device="cpu")
    x = _signal(4, 12000)
    a = _drive(T.StreamingM2Enhancer(mod, **kw), x, [12000])
    b = _drive(T.StreamingM2Enhancer(mod, **kw), x, [313, 2048, 999])
    np.testing.assert_array_equal(a, b)


def test_m2_warmup_context_and_reset():
    (mod,) = _mods(_dgm())
    enh = T.StreamingM2Enhancer(mod, label_mode="timo", chunk_frames=4,
                                context_frames=12, block_iters=1, e_steps=1,
                                residual_tracking=True, device="cpu")
    assert enh._ctx_valid.sum() == 0 and enh._res is None
    enh.push(_signal(5, 4000))
    assert 0 < enh._ctx_valid.sum() <= 12
    assert enh._res is not None and np.all(np.isfinite(enh._res))
    enh.reset()
    assert enh._ctx_valid.sum() == 0 and enh._res is None


# ---------------------------------------------------------------------------
# constructor checks and the OLA contract
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kw, match", [
    (dict(label_mode="dnn"), "classifier"),
    (dict(noise_gain_init="x"), "noise_gain_init"),
    (dict(noise_gain_init="ratio"), "noise_gain=True"),
    (dict(noise_gain_bands=2), "noise_gain=True"),
    (dict(adaptive_iters=4), "adaptive_iters"),
    (dict(noise_gain=True, escalate_reinit=True), "escalate_reinit"),
    (dict(chunk_frames=32, context_frames=24, lookahead=True), "lookahead"),
])
def test_m2_constructor_checks(kw, match):
    (mod,) = _mods(_dgm())
    kw = dict(dict(label_mode="timo"), **kw)
    with pytest.raises(ValueError, match=match):
        T.StreamingM2Enhancer(mod, device="cpu", **kw)


def test_m2_needs_a_dgm():
    from guided_vae_nmf_tpu.models import vae_init

    (m1,) = _mods(vae_init(jax.random.PRNGKey(0), [513, 8, [16]]))
    with pytest.raises(ValueError, match="DGM"):
        T.StreamingM2Enhancer(m1, label_mode="timo", device="cpu")


def test_push_after_flush_non_finite_and_empty_flush():
    enh = T.StreamingSPPEnhancer(chunk_frames=4, device="cpu")
    assert enh.flush().size == 0                  # flush without push
    with pytest.raises(RuntimeError, match="after flush"):
        enh.push(np.zeros(100, np.float32))
    enh.reset()
    enh.push(np.zeros(2000, np.float32))
    bad = np.zeros(1000, np.float32)
    bad[500] = np.nan
    with pytest.raises(ValueError, match="non-finite"):
        enh.push(bad)
    y = enh.push(np.zeros(2000, np.float32))     # the stream survives
    assert np.all(np.isfinite(y))


def test_incremental_latency_and_short_stream():
    enh = T.StreamingSPPEnhancer(chunk_frames=4, device="cpu")
    x = _signal(6, 8000)
    first = enh.push(x[:4000])
    assert first.size > 0                          # streaming, not batch
    rest = np.concatenate([enh.push(x[4000:]), enh.flush()])
    assert first.size + rest.size == len(x)
    short = T.StreamingSPPEnhancer(chunk_frames=4, device="cpu")
    assert short.push(x[:300]).size == 0          # shorter than the lead
    assert short.flush().shape == (300,)
    masks_off = T.StreamingSPPEnhancer(chunk_frames=4, keep_masks=False,
                                       device="cpu")
    with pytest.raises(RuntimeError, match="keep_masks"):
        masks_off.masks


def test_bounded_memory_trim_is_bit_identical():
    x = (0.05 * np.random.RandomState(3).randn(8 * 16000)).astype(np.float32)
    ref = T.StreamingSPPEnhancer(chunk_frames=8, device="cpu")
    ref.TRIM_CHUNK = 1 << 62
    trim = T.StreamingSPPEnhancer(chunk_frames=8, device="cpu")
    trim.TRIM_CHUNK = 8192
    out_r, out_t = [], []
    for lo in range(0, len(x), 3210):
        out_r.append(ref.push(x[lo:lo + 3210]))
        out_t.append(trim.push(x[lo:lo + 3210]))
    bound = trim.TRIM_CHUNK + 4 * 1024 + 2 * 4000
    assert len(trim._pad) < bound and trim._raw.size < bound
    assert trim._y.size < 2 * bound and len(ref._pad) > len(x)
    out_r.append(ref.flush())
    out_t.append(trim.flush())
    np.testing.assert_array_equal(np.concatenate(out_r),
                                  np.concatenate(out_t))
