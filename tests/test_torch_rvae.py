"""The RVAE with the Langevin E-step (`models.rvae`, `mcem.lstm_sweep`,
`mcem.rvae_engine`) against the benchmark's plain reference
(`gvbench/reference/rvae.py`: its own weights from the same seed, autograd
for the gradient), at small shapes on the CPU, and its route through
`pipeline.enhance_waveform`; on a card, the sweep kernels against the
plain loops at the published widths.

Tolerances. float64 (the port's modules cast to float64 on the CPU):
1e-10 relative, for the same arithmetic summed in another order. float32
against the float64 reference: 1e-4 relative for one network pass (a
sum of 65-513 products of values near 1, rounded a few times over the
recurrence), 2e-3 for the EM (two iterations of short chains whose
gradients scale each rounding by eta times the log joint's curvature).
The card: atol 2e-5 / rtol 2e-4 for a kernel against its plain version
(float32 in another order), and rows alone equal the batch bit for bit.

The file imports neither JAX nor the JAX package; its card cases carry
the `cuda` marker and skip without a card:

    python -m pytest --noconftest -q tests/test_torch_rvae.py
"""

import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

from guided_vae_nmf_torch import launch_counts, reset_launch_counts
from guided_vae_nmf_torch.mcem import MCEMConfig, PEEMConfig, HybridConfig
from guided_vae_nmf_torch.mcem.lstm_sweep import (
    backward_sweep, backward_sweep_ref, forward_sweep, langevin_update,
    langevin_update_ref, lik_grad, lik_grad_ref)
from guided_vae_nmf_torch.mcem.rvae_engine import (
    RVAEConfig, as_rvae_config, chain_noise, decoder_parts, langevin_chain,
    mcem_batch_rvae)
from guided_vae_nmf_torch.models import RVAE, rvae_decode, rvae_encode_mean
from guided_vae_nmf_torch.models.rvae import bilstm_scan, rvae_init

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from gvbench.reference import rvae as ref  # noqa: E402

DIMS = [65, 4, 8, [8]]          # F, L, units, dense_g
SEED = 2**31 + 17
TINY = RVAEConfig(niter=2, nsamples_E_step=2, burnin_E_step=3,
                  nsamples_WF=2, burnin_WF=3, nmf_rank=3, ld_step=0.005)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def model(dtype=torch.float32, dims=DIMS):
    return rvae_init(torch.Generator().manual_seed(SEED), dims).to(dtype)


def pipe_model():
    """The STFT's 513 bins, the other widths small."""
    return model(dims=[513, 4, 8, [8]])


def ref_params(prec):
    return ref.Params(ref.init_weights(SEED, DIMS), prec, "cpu")


def batch(B=2, N=40, lengths=(40, 23), F=65, seed=3):
    g = torch.Generator().manual_seed(seed)
    X2 = torch.rand((B, N, F), generator=g) * 20 + 0.1
    mask = torch.zeros((B, N))
    for b, n in enumerate(lengths):
        mask[b, :n] = 1
    Z = torch.randn((B, N, DIMS[1]), generator=g)
    return X2, mask, Z, mask.sum(-1).to(torch.int32)


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


def valid(t, mask):
    return t[mask > 0]


def test_weights_are_the_references_draws():
    m = model()
    w = ref.init_weights(SEED, DIMS)
    got = dict(m.named_parameters())
    assert set(got) == set(w)
    for k, v in w.items():
        assert torch.equal(got[k], v), k


@pytest.mark.parametrize("prec,tol", [("f64", 1e-10), ("f32", 1e-4)])
def test_decoder_matches_reference(prec, tol):
    X2, mask, Z, lengths = batch()
    m = model(torch.float64)
    got = rvae_decode(m, Z.double(), lengths)
    want = ref.decode_logvar(ref_params("f64"), Z.double(), lengths, "f64")
    if prec == "f32":
        got = rvae_decode(model(), Z, lengths)
    assert rel(valid(got, mask), valid(want, mask)) < tol
    assert float(got[mask == 0].abs().max()) == pytest.approx(
        float(m.dec_out.b.abs().max()), rel=1e-6)


@pytest.mark.parametrize("prec,tol", [("f64", 1e-10), ("f32", 1e-4)])
def test_encoder_matches_reference(prec, tol):
    X2, mask, _, lengths = batch()
    want = ref.encode_mean(ref_params("f64"), X2.double(), lengths, "f64")
    if prec == "f64":
        got = rvae_encode_mean(model(torch.float64), X2.double(), lengths)
    else:
        got = rvae_encode_mean(model(), X2, lengths)
    assert rel(valid(got, mask), valid(want, mask)) < tol


def _port_grad(m, Z, X2, Vb, g, mask, lengths):
    dec = decoder_parts(m)
    Hout, save = forward_sweep(Z, lengths, *dec[:3])
    B, N, F = X2.shape
    O = (Hout.reshape(B * N, -1) @ dec[3]).reshape(B, N, F)
    _, G = lik_grad(O, dec[4], X2, Vb, g, mask, ref.VX_FLOOR)
    dH = (G.reshape(B * N, F) @ dec[3].T).reshape(B, N, -1)
    parts = backward_sweep(dH, save, lengths, *dec[:2])
    return parts.sum(0) - Z


@pytest.mark.parametrize("lengths", [(40, 40), (40, 23)])
def test_plain_sweep_gradient_matches_autograd(lengths):
    X2, mask, Z, lens = batch(lengths=lengths)
    X2, Z = X2.double(), Z.double()
    g = torch.Generator().manual_seed(9)
    Vb = torch.rand(X2.shape, generator=g, dtype=torch.float64) + 0.5
    gain = torch.rand(mask.shape, generator=g, dtype=torch.float64) + 0.5
    maskd = mask.double()
    got = _port_grad(model(torch.float64), Z, X2, Vb, gain, maskd, lens)
    want, _ = ref.grad_log_joint(ref_params("f64"), Z, X2, Vb, gain, maskd,
                                 lens, "f64")
    assert rel(valid(got, mask), valid(want, mask)) < 1e-10


def _draws(seed, cfg, B, N, L):
    """The batch generator's NMF init and the chains' eps, drawn as the
    engine draws them."""
    gen = torch.Generator().manual_seed(seed)
    W0 = torch.clamp_min(torch.rand((B, 65, cfg.nmf_rank), generator=gen),
                         cfg.eps)
    H0 = torch.clamp_min(torch.rand((B, cfg.nmf_rank, N), generator=gen),
                         cfg.eps)
    seeds = torch.randint(0, 2**62, (cfg.niter + 1,), generator=gen).tolist()
    e = cfg.burnin_E_step + cfg.nsamples_E_step
    w = cfg.burnin_WF + cfg.nsamples_WF
    draws = [chain_noise(s, (e, B, N, L), "cpu") for s in seeds[:-1]]
    draws.append(chain_noise(seeds[-1], (w, B, N, L), "cpu"))
    return W0, H0, draws


def test_mcem_matches_reference_em():
    X2, mask, _, _ = batch()
    B, N, F = X2.shape
    got = mcem_batch_rvae(model(), X2.transpose(1, 2), mask,
                          torch.Generator().manual_seed(21), TINY)
    W0, H0, draws = _draws(21, TINY, B, N, DIMS[1])
    want = ref.em(ref_params("f64"), X2.double(), mask.double(), W0, H0,
                  draws, dataclasses.asdict(TINY), "f64")
    m3 = mask > 0
    assert rel(got["Z"].transpose(1, 2)[m3], want["Z"][m3]) < 2e-3
    assert rel(got["WFs"].transpose(1, 2)[m3], want["WFs"][m3]) < 2e-3
    assert rel(got["WFn"].transpose(1, 2)[m3], want["WFn"][m3]) < 2e-3
    assert rel(got["W"], want["W"]) < 2e-3
    assert rel(got["H"].transpose(1, 2)[m3], want["H"].transpose(1, 2)[m3]
               ) < 2e-3
    assert rel(got["g"][m3], want["g"][m3]) < 2e-3
    assert rel(got["cost"], want["cost"]) < 2e-3


def test_batch_with_mixed_lengths_equals_rows_alone():
    """A Langevin chain over a batch of rows of 40 and 23 valid frames
    against each row run alone at its own length, on the same draws: the
    recurrence never crosses rows or reaches valid frames from pad ones."""
    X2, mask, Z, lengths = batch(lengths=(40, 23))
    m = model()
    dec = decoder_parts(m)
    gen = torch.Generator().manual_seed(4)
    Vb = torch.rand(X2.shape, generator=gen) + 0.5
    gain = torch.rand(mask.shape, generator=gen) + 0.5
    eps = torch.randn((5, *Z.shape), generator=gen)

    def run(rows, n):
        sl = (slice(rows[0], rows[-1] + 1), slice(0, n))
        Zr = Z[sl].contiguous()
        lens = lengths[sl[0]]
        out = langevin_chain(
            dec, X2[sl].contiguous(), Vb[sl].contiguous(),
            gain[sl].contiguous(), mask[sl].contiguous(), lens, Zr,
            forward_sweep(Zr, lens, *dec[:3]), 0, "e", 2, 3, 0.005,
            noise=lambda s, shape, d: eps[:, sl[0], sl[1]].contiguous())
        return out[0], out[2]

    Zb, Sb = run([0, 1], 40)
    for b, n in ((0, 40), (1, 23)):
        Za, Sa = run([b], n)
        assert_allclose(Zb[b, :n], Za[0], rtol=1e-6, atol=1e-6)
        assert_allclose(Sb[b, :, :n], Sa[0], rtol=1e-6, atol=1e-6)
        # pad frames keep their Z
        assert torch.equal(Zb[b, n:], Z[b, n:])


def test_as_rvae_config_from_mcem():
    cfg = as_rvae_config(MCEMConfig(niter=7, var_RW=0.01))
    assert cfg.niter == 7 and cfg.ld_step == pytest.approx(0.005)
    assert as_rvae_config(TINY) is TINY


def _pcm(B=2, seconds=(0.5, 0.35), seed=5):
    from guided_vae_nmf_torch.dsp import pad_signal_for_stft

    rng = np.random.default_rng(seed)
    rows = [pad_signal_for_stft((rng.standard_normal(int(16000 * s))
                                 * 3000).astype(np.int16))
            for s in seconds]
    n_pad = max(nf for _, nf in rows)
    L = (n_pad - 1) * 256 + 1024
    x = np.zeros((B, L), np.int16)
    mask = np.zeros((B, n_pad), np.float32)
    for b, (xp, nf) in enumerate(rows):
        x[b, :min(len(xp), L)] = xp[:L]
        mask[b, :nf] = 1
    return x, mask, [nf for _, nf in rows]


def test_enhance_waveform_runs_an_rvae_on_the_cpu():
    from guided_vae_nmf_torch.pipeline import enhance_waveform

    x, mask, lens = _pcm()
    s, n, y_soft, y_hard, ok = enhance_waveform(
        pipe_model(), x, mask, TINY,
        generator=torch.Generator().manual_seed(2), device="cpu")
    assert bool(ok.all())
    assert s.dtype == torch.int16 and s.shape[0] == 2
    assert n is not None and y_soft is None and y_hard is None
    assert int(s[0].abs().max()) > 0


ROUTES = {
    "labels": dict(label_mode="ones"),
    "spp": dict(noise_model="spp"),
    "spp2": dict(noise_model="spp2"),
    "hybrid_noise": dict(noise_model="hybrid"),
    "fast": dict(fast=True),
    "xla": dict(engine="xla"),
    "init": dict(init={"Z": torch.zeros(1)}),
    "peem": dict(cfg=PEEMConfig()),
    "hybrid": dict(cfg=HybridConfig()),
}


@pytest.mark.parametrize("route", list(ROUTES))
def test_unsupported_routes_raise(route):
    from guided_vae_nmf_torch.pipeline import enhance_waveform

    x, mask, _ = _pcm()
    kw = dict(ROUTES[route])
    cfg = kw.pop("cfg", TINY)
    with pytest.raises(NotImplementedError, match="RVAE"):
        enhance_waveform(pipe_model(), x, mask, cfg, device="cpu", **kw)


@pytest.mark.parametrize("what", ["service", "stream", "pool"])
def test_serving_and_streaming_refuse_an_rvae(what):
    from guided_vae_nmf_torch.serving import EnhancementService
    from guided_vae_nmf_torch.streaming import (MultiStreamM2Enhancer,
                                                StreamingM2Enhancer)

    make = {"service": lambda m: EnhancementService(m, device="cpu"),
            "stream": lambda m: StreamingM2Enhancer(m, label_mode="ones",
                                                    device="cpu"),
            "pool": lambda m: MultiStreamM2Enhancer(m, label_mode="ones",
                                                    device="cpu")}[what]
    with pytest.raises(NotImplementedError, match="RVAE"):
        make(pipe_model())


def test_launch_counts_list_the_sweep_kernels():
    """The four kernels count in the package's registry; the plain loops
    on the CPU launch nothing."""
    reset_launch_counts()
    m = model()
    X2, mask, _, _ = batch()
    mcem_batch_rvae(m, X2.transpose(1, 2), mask,
                    torch.Generator().manual_seed(1), TINY)
    counts = launch_counts()
    assert counts["lstm_sweep"] == {"fwd": 0, "bwd": 0, "lik": 0,
                                    "update": 0}
    assert not any(n for d in counts.values() for n in d.values())


def test_model_is_exported():
    assert isinstance(model(), RVAE)
    n = sum(p.numel() for p in rvae_init(torch.Generator().manual_seed(1),
                                         [513, 16, 128, [128]]).parameters())
    # the published widths: about 1.1 M parameters
    assert 1.0e6 < n < 1.2e6


# -- on the card --------------------------------------------------------------

def _card_inputs(dev, B=64, N=256, seed=7):
    g = torch.Generator().manual_seed(seed)
    m = rvae_init(torch.Generator().manual_seed(SEED),
                  [513, 16, 128, [128]]).to(dev)
    lengths = torch.full((B,), N, dtype=torch.int32)
    lengths[1::3] = torch.randint(N // 3, N, (len(lengths[1::3]),),
                                  generator=g).to(torch.int32)
    Z = torch.randn((B, N, 16), generator=g).to(dev)
    dH = (torch.randn((B, N, 256), generator=g) * 0.1).to(dev)
    return m, lengths.to(dev), Z, dH


@pytest.mark.cuda
def test_sweep_kernels_match_plain_loops(cuda):
    m, lengths, Z, dH = _card_inputs(cuda)
    dec = decoder_parts(m)
    Hout, save = forward_sweep(Z, lengths, *dec[:3])
    H_ref, s_ref = bilstm_scan(Z, lengths, *dec[:3], keep=True)
    assert_allclose(Hout.cpu(), H_ref.cpu(), atol=2e-5, rtol=2e-4)
    assert_allclose(save.cpu(), s_ref.cpu(), atol=2e-5, rtol=2e-4)
    parts = backward_sweep(dH, s_ref, lengths, *dec[:2])
    want = backward_sweep_ref(dH, s_ref, lengths, *dec[:2])
    assert_allclose(parts.sum(0).cpu(), want.sum(0).cpu(), atol=2e-5,
                    rtol=2e-4)


@pytest.mark.cuda
def test_sweep_kernels_rows_alone_equal_the_batch(cuda):
    m, lengths, Z, dH = _card_inputs(cuda)
    dec = decoder_parts(m)
    Hout, save = forward_sweep(Z, lengths, *dec[:3])
    parts = backward_sweep(dH, save, lengths, *dec[:2])
    for b in (0, 1, 5, 63):
        sl = slice(b, b + 1)
        H1, s1 = forward_sweep(Z[sl].contiguous(), lengths[sl], *dec[:3])
        assert torch.equal(H1, Hout[sl])
        assert torch.equal(s1, save[:, sl])
        p1 = backward_sweep(dH[sl].contiguous(), s1, lengths[sl], *dec[:2])
        assert torch.equal(p1, parts[:, sl])


@pytest.mark.cuda
def test_elementwise_kernels_match_plain(cuda):
    g = torch.Generator(device=cuda).manual_seed(3)
    B, N, F = 4, 64, 513
    O = torch.randn((B, N, F), generator=g, device=cuda)
    bo = torch.randn((F,), generator=g, device=cuda)
    X2 = torch.rand((B, N, F), generator=g, device=cuda) * 10
    Vb = torch.rand((B, N, F), generator=g, device=cuda) + 0.1
    gain = torch.rand((B, N), generator=g, device=cuda) + 0.5
    mask = (torch.rand((B, N), generator=g, device=cuda) > 0.2).float()
    for a, b in zip(lik_grad(O, bo, X2, Vb, gain, mask, 1e-10),
                    lik_grad_ref(O, bo, X2, Vb, gain, mask, 1e-10)):
        assert_allclose(a.cpu(), b.cpu(), atol=2e-5, rtol=2e-4)
    Z = torch.randn((B, N, 16), generator=g, device=cuda)
    parts = torch.randn((4, B, N, 16), generator=g, device=cuda)
    eps = torch.randn((B, N, 16), generator=g, device=cuda)
    assert_allclose(langevin_update(Z, parts, eps, mask, 0.005).cpu(),
                    langevin_update_ref(Z, parts, eps, mask, 0.005).cpu(),
                    atol=2e-5, rtol=2e-4)


@pytest.mark.cuda
def test_langevin_step_launches(cuda):
    m, lengths, Z, _ = _card_inputs(cuda, B=8, N=64)
    dec = decoder_parts(m)
    X2 = torch.rand((8, 64, 513), device=cuda) * 10
    Vb = torch.ones_like(X2)
    gain = torch.ones((8, 64), device=cuda)
    mask = torch.ones((8, 64), device=cuda)
    fwd = forward_sweep(Z, lengths, *dec[:3])
    reset_launch_counts()
    langevin_chain(dec, X2, Vb, gain, mask, lengths, Z, fwd, 1, "e", 2, 3,
                   0.005)
    # five steps: one forward and one backward sweep, one likelihood and
    # one update pass each, and the likelihood pass at the start
    assert launch_counts()["lstm_sweep"] == {"fwd": 5, "bwd": 5, "lik": 6,
                                             "update": 5}
