"""PEEM, point-estimate EM (a gradient E-step, no sampling), and the
PEEM -> MCEM hybrid.

Counterpart of `guided_vae_nmf_tpu/mcem/peem.py`. The E-step takes a few
fixed-rate gradient steps on the latent MAP objective

    J(Z) = sum_f [log Vx + |X|^2 / Vx] + 0.5 ||Z||^2,  Vx = g Vs(Z) + Vb,

summed over the valid frames, and the M-step runs the multiplicative NMF
updates of `engine.nmf_m_step` on the single point estimate (R = 1). The
gradient comes from `torch.autograd.grad` in place of `jax.grad`. The
hybrid hands PEEM's final (W, H, g, Z) to the fused MCEM engine for a
short sampling refinement and its Wiener filter.

Everything is batched over B in the reference (F, N) orientation; the
PEEM part is plain PyTorch (cuBLAS products in full float32 on the card:
the package keeps TF32 off), and the hybrid's refinement runs the fused
engine's kernels.
"""

from dataclasses import dataclass

import torch

from .engine import (
    VX_FLOOR,
    MCEMConfig,
    _decode_cond,
    _fold_in,
    _masked_cost,
    _precompute_label_proj,
    fold_seed,
    framewise_uniform,
    mcem_run,
    nmf_m_step,
    noise_gain_state,
)
from .fused_engine import mcem_batch_fused


@dataclass(frozen=True)
class PEEMConfig:
    """PEEM hyper-parameters: `niter` EM iterations of `e_steps` gradient
    steps at rate `lr`."""

    niter: int = 50
    e_steps: int = 5
    lr: float = 5e-3
    nmf_rank: int = 10
    eps: float = 1e-8
    # Fixed-noise models only: per-frame (or per-band) noise gain b
    # (Vb = b * Vb_fixed), updated in the M-step like g.
    noise_gain: bool = False
    noise_gain_bands: int = 1


@dataclass(frozen=True)
class HybridConfig:
    """PEEM -> MCEM hybrid: `niter` PEEM iterations, then `refine`
    warm-started MCEM iterations and the sampled Wiener filter (the
    operating point for the paper's 500-iteration budget)."""

    niter: int = 500                 # PEEM iterations
    refine: int = 150                # MCEM refinement iterations
    e_steps: int = 5
    lr: float = 5e-3
    nmf_rank: int = 10
    eps: float = 1e-8
    nsamples_E_step: int = 10
    burnin_E_step: int = 30
    nsamples_WF: int = 25
    burnin_WF: int = 75
    var_RW: float = 0.01

    def split(self):
        """(PEEMConfig, MCEMConfig) of the two stages."""
        pcfg = PEEMConfig(niter=self.niter, e_steps=self.e_steps,
                          lr=self.lr, nmf_rank=self.nmf_rank, eps=self.eps)
        mcfg = MCEMConfig(niter=self.refine,
                          nsamples_E_step=self.nsamples_E_step,
                          burnin_E_step=self.burnin_E_step,
                          nsamples_WF=self.nsamples_WF,
                          burnin_WF=self.burnin_WF, var_RW=self.var_RW,
                          nmf_rank=self.nmf_rank, eps=self.eps)
        return pcfg, mcfg


def _map_objective(decoder, y_pre, X_abs2, Vb, g, Z, mask):
    """Negative log posterior (up to constants) summed over the valid
    frames of every utterance. An utterance's Z enters only its own terms,
    so the batch sum leaves each utterance's gradient as it is alone."""
    Vs = _decode_cond(decoder, y_pre, Z)
    Vx = torch.clamp_min(g[:, None, :] * Vs + Vb, VX_FLOOR)
    nll = torch.sum((torch.log(Vx) + X_abs2 / Vx) * mask[:, None, :])
    prior = 0.5 * torch.sum((Z * Z) * mask[:, None, :])
    return nll + prior


def _e_step(decoder, y_pre, X_abs2, Vb, g, Z, mask, cfg):
    """cfg.e_steps gradient steps on Z. Each step differentiates a fresh
    graph from a leaf copy of Z and detaches its result, so no graph
    outlives its step (the entry points run under no_grad)."""
    for _ in range(cfg.e_steps):
        with torch.enable_grad():
            Zl = Z.detach().requires_grad_()
            (grad,) = torch.autograd.grad(
                _map_objective(decoder, y_pre, X_abs2, Vb, g, Zl, mask), Zl)
        Z = (Z - cfg.lr * grad).detach()
    return Z


@torch.no_grad()
def peem_run(model, X_abs2, mask, y, generator,
             cfg: PEEMConfig = PEEMConfig(), update_nmf=True, Vb_fixed=None,
             init=None):
    """PEEM over a batch: X_abs2 (B, F, N) with benign pad frames, mask
    (B, N), y (B, y_dim, N) or None (M1), Vb_fixed (B, F, N) with
    update_nmf=False. Returns {"WFs", "WFn" (B, F, N), "cost" (B, niter),
    "W" (B, F, K), "H" (B, K, N), "g" (B, N), "Z" (B, L, N)}, and "b" when
    the noise gain is on.

    The NMF init is drawn from `generator`'s seed (not its state) with
    :func:`framewise_uniform`, so it is the same on every device and for
    every padded length; `init` {"W", "H"} replaces it, as in
    `mcem_batch_fused`. The E-step is deterministic."""
    if cfg.noise_gain and update_nmf:
        raise ValueError(
            "PEEMConfig.noise_gain requires a fixed noise model "
            "(update_nmf=False, i.e. noise_model 'spp'/'spp2')")
    if not update_nmf and Vb_fixed is None:
        raise ValueError("update_nmf=False needs Vb_fixed (B, F, N)")
    init = init or {}
    enc, dec = model.encoder, model.decoder
    B, F, N = X_abs2.shape
    dev = X_abs2.device
    y_dim = 0 if y is None else y.shape[1]
    L = dec.hidden[0].w.shape[0] - y_dim
    K = cfg.nmf_rank

    if "W" in init:
        W, H = init["W"], init["H"]
    elif update_nmf:
        seed = generator.initial_seed()
        W = torch.clamp_min(framewise_uniform(seed, (B, F, K), dev),
                            cfg.eps)
        H = torch.clamp_min(framewise_uniform(seed, (B, K, N), dev, stream=1),
                            cfg.eps)
    else:
        W = torch.ones((B, F, 1), device=dev)
        H = torch.zeros((B, 1, N), device=dev)
    g = torch.ones((B, N), device=dev)

    enc_in = X_abs2 if y is None else torch.cat([X_abs2, y], dim=1)
    _, mu, _ = enc(enc_in.transpose(1, 2).reshape(B * N, -1))
    Z = mu.reshape(B, N, L).transpose(1, 2)                 # (B, L, N)
    y_pre = _precompute_label_proj(dec, y, L)

    b = band_map = None
    if cfg.noise_gain:
        b, eff_vb, band_map = noise_gain_state(
            F, N, cfg.noise_gain_bands, Vb_fixed, B, frames_major=False)

    def noise_var(W, H, b):
        if b is not None:
            return eff_vb(b)
        return W @ H if update_nmf else Vb_fixed

    costs = []
    for _ in range(cfg.niter):
        Z = _e_step(dec, y_pre, X_abs2, noise_var(W, H, b), g, Z, mask, cfg)
        Vs = _decode_cond(dec, y_pre, Z)[:, None]            # (B, 1, F, N)
        if b is not None:
            W, H, g, b = nmf_m_step(X_abs2, mask, W, H, g, Vs,
                                    update_nmf=False, Vb_fixed=Vb_fixed,
                                    b=b, band_map=band_map)
        else:
            W, H, g = nmf_m_step(X_abs2, mask, W, H, g, Vs,
                                 update_nmf=update_nmf, Vb_fixed=Vb_fixed)
        costs.append(_masked_cost(X_abs2, mask, noise_var(W, H, b), g, Vs))

    Vb = noise_var(W, H, b)
    Vs = _decode_cond(dec, y_pre, Z)
    Vx = torch.clamp_min(g[:, None, :] * Vs + Vb, VX_FLOOR)
    out = {"WFs": (g[:, None, :] * Vs) / Vx, "WFn": Vb / Vx,
           "cost": (torch.stack(costs, dim=1) if costs
                    else torch.zeros((B, 0), device=dev)),
           "W": W, "H": H, "g": g, "Z": Z}
    if b is not None:
        out["b"] = b
    return out


def peem_m1_batch(model, X_abs2, mask, generator, cfg: PEEMConfig,
                  update_nmf=True, Vb_fixed=None, init=None):
    """PEEM with the label-free M1 VAE (see :func:`peem_run`)."""
    return peem_run(model, X_abs2, mask, None, generator, cfg,
                    update_nmf=update_nmf, Vb_fixed=Vb_fixed, init=init)


def peem_m2_batch(model, X_abs2, mask, y, generator, cfg: PEEMConfig,
                  update_nmf=True, Vb_fixed=None, init=None):
    """PEEM with the label-guided M2 model (see :func:`peem_run`)."""
    return peem_run(model, X_abs2, mask, y, generator, cfg,
                    update_nmf=update_nmf, Vb_fixed=Vb_fixed, init=init)


def peem_mcem_m2_batch(model, X_abs2, mask, y, generator, pcfg: PEEMConfig,
                       mcfg: MCEMConfig, update_nmf=True, Vb_fixed=None,
                       init=None, use_fused=True, seeds=None, **fused_kw):
    """PEEM warm start plus a short MCEM refinement: pcfg.niter PEEM
    iterations, then MCEM from PEEM's (W, H, g, Z) for mcfg.niter sampling
    iterations and the sampled Wiener filter. y=None runs M1. The
    refinement runs `mcem_batch_fused` with `fused_kw` (the fast-mode
    options) and a generator folded from `generator` with 7331, as the JAX
    package folds its keys; with use_fused=False it runs the eager
    engine's `mcem_run` on the row `seeds` folded with 7331 (and no fast
    options, as in the JAX package). `init` {"W", "H"} goes to PEEM. The
    result's "cost" is PEEM's trace followed by the refinement's."""
    r = peem_run(model, X_abs2, mask, y, generator, pcfg,
                 update_nmf=update_nmf, Vb_fixed=Vb_fixed, init=init)
    if use_fused:
        out = mcem_batch_fused(
            model, X_abs2, mask, y, _fold_in(generator, 7331), mcfg,
            update_nmf=update_nmf, Vb_fixed=Vb_fixed,
            init={k: r[k] for k in ("W", "H", "g", "Z")}, **fused_kw)
    else:
        out = mcem_run(model, X_abs2, mask, y,
                       [fold_seed(s, 7331) for s in seeds], mcfg,
                       update_nmf=update_nmf, Vb_fixed=Vb_fixed,
                       init_nmf=(r["W"], r["H"], r["g"]), init_Z=r["Z"])
    out["cost"] = torch.cat([r["cost"], out["cost"]], dim=-1)
    return out
