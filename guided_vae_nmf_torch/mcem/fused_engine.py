"""Batched MCEM around the fused chain (K1) and M-step sums (K2) kernels.

Counterpart of `_dec_parts`, `_masked_cost_batched` and `mcem_batch_fused`
in `guided_vae_nmf_tpu/mcem/pallas_engine.py`, for the NMF noise model in
exact mode. Per EM iteration: one E-mode chain (which also emits the
W-update num/den), the W update, one 'h' sums pass at the post-W noise
variance, the H update, L1 normalisation, one 'g' sums pass and the gain
update. A last WF-mode chain gives the Wiener filters. Frames-major
(B, N, F) inside; the result dict is in the reference (F, N) orientation.

CUDA tensors launch the kernels; CPU tensors run their plain versions.
"""

import torch

from .engine import VX_FLOOR, MCEMConfig
from .mh_chain import mh_chain
from .nmf_sums import nmf_sums


def _dec_parts(decoder, L):
    """Decoder weights for the chain: the z-rows of layer 1 split out,
    hidden layers 2..depth as (w, b) pairs, and the output layer."""
    l0 = decoder.hidden[0]
    return {
        "w1": l0.w[:L].contiguous(),
        "mid": tuple((layer.w, layer.b) for layer in decoder.hidden[1:]),
        "wo": decoder.out.w,
        "bo": decoder.out.b,
    }


def _masked_cost_batched(X2, mask, Vb, g, Vs):
    """(B,) masked expected negative log-likelihood; Vs (B, R, N, F)."""
    Vx = torch.clamp_min(g[:, None, :, None] * Vs + Vb[:, None], VX_FLOOR)
    per = torch.log(Vx) + X2[:, None] / Vx
    total = torch.sum(per * mask[:, None, :, None], dim=(1, 2, 3))
    count = Vs.shape[1] * X2.shape[-1] * torch.sum(mask, dim=1)
    return total / count


@torch.no_grad()
def mcem_batch_fused(model, X_abs2, mask, y, generator,
                     cfg: MCEMConfig = MCEMConfig(), update_nmf=True,
                     compute_cost=True, init=None):
    """Full batched MCEM. X_abs2 (B, F, N) with benign pad frames, mask
    (B, N), y (B, y_dim, N) or None (M1), `generator` a torch.Generator on
    the tensors' device. Returns {"WFs", "WFn" (B, F, N), "cost" (B, niter),
    "W" (B, F, K), "H" (B, K, N), "g" (B, N), "Z" (B, L, N)}.

    init: optional warm start in the result orientation: "W" and "H"
    replace the random NMF init, "g" the unit gain and "Z" the encoder's
    posterior mean; each key is optional."""
    if not update_nmf:
        raise NotImplementedError(
            "fixed-noise models (update_nmf=False) need the Vb-input kernel "
            "variants K1b/K2b (ROADMAP Queue 1, item 6)")
    if cfg.noise_gain:
        raise NotImplementedError(
            "noise_gain needs a fixed noise model (ROADMAP Queue 1, item 6)")
    init = init or {}
    enc, dec = model.encoder, model.decoder
    B, F, N = X_abs2.shape
    dev = X_abs2.device
    y_dim = 0 if y is None else y.shape[1]
    L = dec.hidden[0].w.shape[0] - y_dim

    X2 = X_abs2.transpose(1, 2).contiguous()                # (B, N, F)
    l0 = dec.hidden[0]
    if y is None:
        enc_in = X2
        ypre = l0.b.expand(B, N, l0.b.shape[0]).contiguous()
    else:
        yT = y.transpose(1, 2)                               # (B, N, y_dim)
        enc_in = torch.cat([X2, yT], dim=-1)
        ypre = (torch.einsum("bny,yh->bnh", yT, l0.w[L:]) + l0.b).contiguous()

    if "Z" in init:
        Z = init["Z"].transpose(1, 2).contiguous()           # (B, N, L)
    else:
        _, mu, _ = enc(enc_in.reshape(B * N, -1))
        Z = mu.reshape(B, N, L)
    dec_w = _dec_parts(dec, L)
    h = torch.tanh(Z @ dec_w["w1"] + ypre)
    for w, b in dec_w["mid"]:
        h = torch.tanh(h @ w + b)
    Vs = torch.exp(h @ dec_w["wo"] + dec_w["bo"])            # decode(Z)

    K = cfg.nmf_rank
    if "W" in init:
        Wt = init["W"].transpose(1, 2).contiguous()          # (B, K, F)
        H = init["H"].contiguous()
    else:
        W0 = torch.clamp_min(torch.rand((B, F, K), generator=generator,
                                        device=dev), cfg.eps)
        Wt = W0.transpose(1, 2).contiguous()
        H = torch.clamp_min(torch.rand((B, K, N), generator=generator,
                                       device=dev), cfg.eps)
    g = init["g"].contiguous() if "g" in init else torch.ones((B, N),
                                                             device=dev)
    # one chain seed per EM iteration and one for the WF chain, fetched to
    # the host in a single transfer
    seeds = torch.randint(0, 2**62, (cfg.niter + 1,), generator=generator,
                          device=dev).tolist()

    costs = []
    for it in range(cfg.niter):
        Z, Vs, (samples, numW, denW) = mh_chain(
            dec_w, X2, (Wt, H), g, ypre, Z, Vs, seeds[it], mode="e",
            nsamples=cfg.nsamples_E_step, burnin=cfg.burnin_E_step,
            var_RW=cfg.var_RW, mask=mask)
        Wt2 = Wt * torch.sqrt(numW / denW)
        numH, denH = nmf_sums(samples, (Wt2, H), g, X2, mode="h")
        H2 = H * torch.sqrt(numH / denH).transpose(1, 2)
        norm_col = torch.sum(torch.abs(Wt2), dim=2)           # (B, K)
        Wt2 = (Wt2 / norm_col[..., None]).contiguous()
        H2 = (H2 * norm_col[:, :, None]).contiguous()
        num_g, den_g = nmf_sums(samples, (Wt2, H2), g, X2, mode="g")
        g = g * torch.sqrt(num_g / den_g)
        if compute_cost:
            Vb2 = torch.einsum("bkf,bkn->bnf", Wt2, H2)
            costs.append(_masked_cost_batched(X2, mask, Vb2, g, samples))
        Wt, H = Wt2, H2

    Z, Vs, (ws, wn) = mh_chain(
        dec_w, X2, (Wt, H), g, ypre, Z, Vs, seeds[cfg.niter], mode="wf",
        nsamples=cfg.nsamples_WF, burnin=cfg.burnin_WF, var_RW=cfg.var_RW)
    cost = (torch.stack(costs, dim=1) if costs
            else torch.zeros((B, cfg.niter), device=dev))
    return {
        "WFs": (ws / cfg.nsamples_WF).transpose(1, 2),
        "WFn": (wn / cfg.nsamples_WF).transpose(1, 2),
        "cost": cost,
        "W": Wt.transpose(1, 2), "H": H, "g": g,
        "Z": Z.transpose(1, 2),
    }
