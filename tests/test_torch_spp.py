"""The SPP noise tracker and the timo labels: the port's torch trackers
against the JAX package's `lax.scan` trackers, and the port's numpy copies
against the originals. Inputs are made with numpy from a seed. Tolerance:
rtol 1e-5 (float32, the same recurrence; XLA may contract or reorder a
few float32 operations), with an absolute floor of 1e-7 for SPP values
that are exactly 0 in one package and a rounding residue in the other."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

from guided_vae_nmf_tpu.mcem import spp as jspp
from guided_vae_nmf_torch.mcem import spp as tspp

torch.set_num_threads(2)

TOL = dict(rtol=1e-5, atol=1e-7)


def _power(seed, B=2, F=65, N=60):
    """(B, F, N) power spectrograms: low noise, a speech-like block and a
    loud burst, so the tracker leaves its 10-frame init phase, flags speech
    and hits its stuck-probability clamp."""
    rng = np.random.RandomState(seed)
    P = 0.1 * rng.rand(B, F, N)
    P[:, 5:20, 20:40] += 3.0 * rng.rand(B, 15, 20)
    P[:, :, 45:48] *= 200.0
    return P.astype(np.float32)


@pytest.mark.parametrize("seed,F,N", [(0, 65, 60), (1, 513, 40)])
def test_spp_track_matches_jax(seed, F, N):
    P = _power(seed, F=F, N=N)
    want_psd, want_spp = jax.vmap(jspp.spp_track_jax)(jnp.asarray(P))
    got_psd, got_spp = tspp.spp_track(torch.tensor(P))
    assert got_psd.shape == P.shape and got_spp.shape == P.shape
    assert_allclose(got_psd.numpy(), np.asarray(want_psd), **TOL)
    assert_allclose(got_spp.numpy(), np.asarray(want_spp), **TOL)
    # leaves the init phase and detects the speech block
    assert np.all(got_spp.numpy()[..., :10] == 0)
    assert got_spp.numpy()[:, 5:20, 25:35].mean() > 0.8


def test_spp_track_chunk_equals_whole_track():
    """Chunked, state-carrying tracking equals the whole track exactly,
    with ragged chunks and a final chunk whose pad frames are gated out."""
    P = torch.tensor(_power(2))
    want_psd, want_spp = tspp.spp_track(P)
    state = tspp.spp_state_init(P.shape[1], batch=P.shape[0])
    got_psd, got_spp = [], []
    lo = 0
    for k in (1, 7, 4, 13, 2, 9):
        psd, spp, state = tspp.spp_track_chunk(P[..., lo:lo + k], state)
        got_psd.append(psd)
        got_spp.append(spp)
        lo += k
    k = P.shape[-1] - lo
    pad = torch.ones(P.shape[:2] + (k + 5,))
    pad[..., :k] = P[..., lo:]
    psd, spp, state2 = tspp.spp_track_chunk(pad, state, n_valid=k)
    got_psd.append(psd[..., :k])
    got_spp.append(spp[..., :k])
    assert torch.equal(torch.cat(got_psd, -1), want_psd)
    assert torch.equal(torch.cat(got_spp, -1), want_spp)
    assert state2[2].tolist() == [P.shape[-1]] * P.shape[0]
    # the pad frames advanced nothing
    _, _, state3 = tspp.spp_track_chunk(pad[..., :k], state)
    assert all(torch.equal(a, b) for a, b in zip(state2, state3))


def test_spp_track_chunk_matches_jax():
    P = _power(3)[0]                                    # (F, N)
    js = jspp.spp_state_init(P.shape[0])
    ts = tspp.spp_state_init(P.shape[0])
    for lo, k, n_valid in ((0, 16, None), (16, 20, None), (36, 24, 10)):
        chunk = P[:, lo:lo + k]
        jpsd, jsp, js = jspp.spp_track_chunk(jnp.asarray(chunk), js,
                                             n_valid=n_valid)
        tpsd, tsp, ts = tspp.spp_track_chunk(torch.tensor(chunk), ts,
                                             n_valid=n_valid)
        assert_allclose(tpsd.numpy(), np.asarray(jpsd), **TOL)
        assert_allclose(tsp.numpy(), np.asarray(jsp), **TOL)
        assert_allclose(ts[0].numpy(), np.asarray(js[0]), **TOL)
        assert_allclose(ts[1].numpy(), np.asarray(js[1]), **TOL)
        assert int(ts[2]) == int(js[2])


@pytest.mark.parametrize("kind", ["mask", "vad"])
def test_timo_labels_match_jax(kind):
    P = _power(4)
    if kind == "mask":
        want = jax.vmap(jspp.timo_mask_estimation_jax)(jnp.asarray(P))
        got = tspp.timo_mask(torch.tensor(P))
    else:
        want = jax.vmap(jspp.timo_vad_estimation_jax)(jnp.asarray(P))
        got = tspp.timo_vad(torch.tensor(P))
    assert tuple(got.shape) == tuple(want.shape)
    assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_numpy_copies_match_the_originals():
    S = _power(5)[0].astype(np.float64)
    for name in ("timo_mask_estimation", "timo_vad_estimation"):
        assert np.array_equal(getattr(tspp, name)(S), getattr(jspp, name)(S))
    m = jspp.timo_mask_estimation(S)
    assert np.array_equal(tspp.timo_noise_estimation(S, m),
                          jspp.timo_noise_estimation(S, m))
    frame_length = (S.shape[0] - 1) * 2
    assert np.array_equal(
        tspp.SPPNoiseEstimator(frame_length).from_stft(S.T),
        jspp.SPPNoiseEstimator(frame_length).from_stft(S.T))
    for const in ("SPP_FIX_SMOOTH", "SPP_PROB_SMOOTH", "SPP_PRIOR",
                  "SPP_SNR_OPT_DB", "SPP_NUM_FRAMES_INIT"):
        assert getattr(tspp, const) == getattr(jspp, const)
