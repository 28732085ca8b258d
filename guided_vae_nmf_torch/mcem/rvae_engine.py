"""MCEM of the recurrent VAE (`models.rvae`) with the NMF noise model and a
Langevin E-step, after Sadeghi and Serizel, "Posterior sampling algorithms
for unsupervised speech enhancement with recurrent variational
autoencoder" (arXiv:2309.10439), frames-major.

The log joint of a row is sum_n [- sum_f (log Vx_nf + X2_nf / Vx_nf)
- |z_n|^2 / 2] over its valid frames, Vx = max(g Vs + (W H)^T, VX_FLOOR)
and Vs = exp(decoder(Z)). The decoder's LSTMs couple the frames, so a
chain step moves every frame at once along the gradient, taken through
both LSTM directions over the whole sequence (a forward sweep, the output
layer, the likelihood's gradient, a backward sweep: `mcem.lstm_sweep`):

    Z <- Z + eta grad_Z log p(X, Z) + sqrt(2 eta) eps,   eps ~ N(0, I),

unadjusted (no accept test) and only at valid frames; pad frames keep
their Z. Per EM iteration: burnin_E_step + nsamples_E_step steps from the
current Z, the last nsamples_E_step iterates' Vs kept as the (B, R, N, F)
dumps of the fused engine's M-step (`fused_engine._nmf_m_step_batched`,
with the K2 sums), then the cost pass (`em_cost`, in the WH form). After
the EM iterations the Wiener-filter chain runs burnin_WF + nsamples_WF
steps and averages g Vs / Vx and Vb / Vx over its last nsamples_WF
iterates.

Draws: the NMF init and one seed an E chain plus one for the WF chain
come from the batch's generator as the fused engine draws them
(`fused_engine.em_draws`); a chain's eps
(steps, B, N, L) are `torch.randn` of a generator on the tensors' device
seeded with the chain's seed (:func:`chain_noise`), so they can be drawn
again from the seed alone.
"""

import dataclasses
from dataclasses import dataclass

import torch

from ..models.rvae import rvae_encode_mean, valid_lengths
from ..ops.profiling import span
from .engine import VX_FLOOR, MCEMConfig
from .em_cost import em_cost
from .fused_engine import _nmf_m_step_batched, em_draws, em_result
from .lstm_sweep import (backward_sweep, forward_sweep, langevin_update,
                         lik_grad)


@dataclass(frozen=True)
class RVAEConfig:
    """The chain lengths and NMF settings of `MCEMConfig`, and the
    Langevin step size `ld_step` (eta)."""
    niter: int = 100
    nsamples_E_step: int = 10
    burnin_E_step: int = 30
    nsamples_WF: int = 25
    burnin_WF: int = 75
    nmf_rank: int = 10
    eps: float = 1e-8
    ld_step: float = 0.005


def as_rvae_config(cfg):
    """An RVAEConfig as given, or from an MCEMConfig's chain lengths and
    NMF settings with eta = var_RW / 2 (the proposal variance of the MH
    random walk is the Langevin noise variance 2 eta)."""
    if isinstance(cfg, RVAEConfig):
        return cfg
    if isinstance(cfg, MCEMConfig):
        return RVAEConfig(**{f.name: getattr(cfg, f.name)
                             for f in dataclasses.fields(RVAEConfig)
                             if f.name != "ld_step"},
                          ld_step=cfg.var_RW / 2)
    raise NotImplementedError(
        f"an RVAE runs MCEM with an RVAEConfig or an MCEMConfig, not "
        f"{type(cfg).__name__}")


def chain_noise(seed, shape, device):
    """A chain's Langevin draws eps (steps, B, N, L) from its seed."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    return torch.randn(shape, generator=gen, device=device)


def decoder_parts(model):
    """(w_ih, w_hh, b, w_o, b_o): the decoder's LSTM weights stacked by
    direction and its output layer."""
    return (*model.decoder_weights(), model.dec_out.w, model.dec_out.b)


def _lik(dec, Hout, X2, Vb, g, mask):
    B, N, F = X2.shape
    O = (Hout.reshape(B * N, -1) @ dec[3]).reshape(B, N, F)
    return lik_grad(O, dec[4], X2, Vb, g, mask, VX_FLOOR)


def langevin_chain(dec, X2, Vb, g, mask, lengths, Z, fwd, seed, mode,
                   nsamples, burnin, eta, noise=chain_noise):
    """burnin + nsamples Langevin steps from Z (B, N, L), whose forward
    sweep (Hout, save) is `fwd`, at a fixed Vb (B, N, F) and gain g (B, N).
    Returns (Z, its forward sweep, extra): extra is the last `nsamples`
    iterates' Vs (B, R, N, F) in mode "e", (sum g Vs / Vx, sum Vb / Vx) over
    them, each (B, N, F), in mode "wf". `noise(seed, shape, device)` gives
    the draws."""
    w_ih, w_hh, b, wo, _ = dec
    B, N, L = Z.shape
    F = X2.shape[-1]
    eps = noise(seed, (burnin + nsamples, B, N, L), Z.device)
    Hout, save = fwd
    _, G = _lik(dec, Hout, X2, Vb, g, mask)
    if mode == "e":
        samples = torch.empty((B, nsamples, N, F), device=Z.device)
    else:
        ws = torch.zeros_like(X2)
        wn = torch.zeros_like(X2)
        g3 = g[..., None]
    for m in range(burnin + nsamples):
        dH = (G.reshape(B * N, F) @ wo.T).reshape(B, N, -1)
        parts = backward_sweep(dH, save, lengths, w_ih, w_hh)
        Z = langevin_update(Z, parts, eps[m], mask, eta)
        Hout, save = forward_sweep(Z, lengths, w_ih, w_hh, b)
        Vs, G = _lik(dec, Hout, X2, Vb, g, mask)
        if m < burnin:
            continue
        if mode == "e":
            samples[:, m - burnin] = Vs
        else:
            inv = 1.0 / torch.clamp_min(g3 * Vs + Vb, VX_FLOOR)
            ws += g3 * Vs * inv
            wn += Vb * inv
    return Z, (Hout, save), (samples if mode == "e" else (ws, wn))


def _noise_var(W, H):
    return torch.einsum("bfk,bkn->bnf", W, H).contiguous()


@torch.no_grad()
def mcem_batch_rvae(model, X_abs2, mask, generator, cfg=RVAEConfig(),
                    noise=chain_noise):
    """Full batched MCEM of an RVAE with the NMF noise model. X_abs2
    (B, F, N) with benign pad frames, mask (B, N) with each row's valid
    frames first, `generator` a torch.Generator on the tensors' device,
    cfg an RVAEConfig (or an MCEMConfig, see :func:`as_rvae_config`).
    Returns the fused engine's dict: {"WFs", "WFn" (B, F, N), "cost"
    (B, niter), "W" (B, F, K), "H" (B, K, N), "g" (B, N), "Z" (B, L, N)}.

    Spans: `gvnmf.engine`, under it `gvnmf.engine.init` (with
    `gvnmf.rvae.encode`), a `gvnmf.rvae.e_chain`, `gvnmf.em.m_step` and
    `gvnmf.em.cost` an EM iteration and `gvnmf.rvae.wf_chain`; a chain
    span counts its `steps`, `rows` and `timesteps` (the ordered timesteps
    its sweeps run: steps x N x 2)."""
    cfg = as_rvae_config(cfg)
    dev = X_abs2.device
    B, F, N = X_abs2.shape
    dec = decoder_parts(model)
    with span("gvnmf.engine", dev, niter=cfg.niter):
        with span("gvnmf.engine.init"):
            X2 = X_abs2.transpose(1, 2).contiguous()          # (B, N, F)
            mask = mask.to(torch.float32).contiguous()
            lengths = valid_lengths(mask)
            with span("gvnmf.rvae.encode"):
                Z = rvae_encode_mean(model, X2, lengths).contiguous()
            fwd = forward_sweep(Z, lengths, *dec[:3])
            W, H, seeds = em_draws(generator, B, F, N, cfg, dev)
            g = torch.ones((B, N), device=dev)

        def counts(steps):
            return dict(steps=steps, rows=B, timesteps=steps * N * 2)

        e_steps = cfg.burnin_E_step + cfg.nsamples_E_step
        costs = []
        for it in range(cfg.niter):
            with span("gvnmf.rvae.e_chain", **counts(e_steps)):
                Z, fwd, samples = langevin_chain(
                    dec, X2, _noise_var(W, H), g, mask, lengths, Z, fwd,
                    seeds[it], "e", cfg.nsamples_E_step, cfg.burnin_E_step,
                    cfg.ld_step, noise)
            with span("gvnmf.em.m_step"):
                W, H, g = _nmf_m_step_batched(X2, mask, W, H, g, samples)
            with span("gvnmf.em.cost"):
                WH = (W.transpose(1, 2).contiguous(), H)
                costs.append(em_cost(samples, WH, g, X2, mask))
        with span("gvnmf.rvae.wf_chain",
                  **counts(cfg.burnin_WF + cfg.nsamples_WF)):
            Z, fwd, (ws, wn) = langevin_chain(
                dec, X2, _noise_var(W, H), g, mask, lengths, Z, fwd,
                seeds[cfg.niter], "wf", cfg.nsamples_WF, cfg.burnin_WF,
                cfg.ld_step, noise)
        return em_result(cfg, ws, wn, costs, W, H, g, Z)
