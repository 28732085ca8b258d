"""Batched MCEM around the fused chain (K1) and M-step sums (K2) kernels.

Counterpart of `_dec_parts`, `_nmf_m_step_batched`, `_masked_cost_batched`
(`em_cost`) and `mcem_batch_fused` in
`guided_vae_nmf_tpu/mcem/pallas_engine.py`, in
exact mode and in fast mode (the K1c / K2c options: bfloat16 sample dumps,
approximate reciprocal, bit-arithmetic exp / log), and with the chains'
decoder products on bfloat16 operands (K1d, `matmul_dtype`). Per EM
iteration with the NMF noise model: one E-mode chain
with WH (K1a, which also emits the W-update num/den), the W update, one 'h'
sums pass at the post-W noise variance (K2a), the H update, L1
normalisation, one 'g' sums pass (K2a) and the gain update. With a fixed
noise variance (update_nmf=False): one E-mode chain with Vb (K1b) and the
gain update on a 'g' sums pass (K2b); with the noise gain on, also an 'h'
sums pass (K2b) for the gain b between them. With `compute_cost`, each
iteration ends with the cost pass (`em_cost`: one kernel over the dumps, in
the WH form with the NMF factors, else in the Vb form). A last WF-mode
chain gives the Wiener filters. Frames-major (B, N, F) inside; the result
dict is in the reference (F, N) orientation.

CUDA tensors launch the kernels; CPU tensors run their plain versions.
"""

import torch

from ..ops.profiling import span
from .em_cost import em_cost
from .engine import MCEMConfig, noise_gain_state
from .mh_chain import live_pairs, mh_chain, plan_chain
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


def _nmf_m_step_batched(X2, mask, W, H, g, Vs, update_nmf=True,
                        Vb_fixed=None, approx_recip=False):
    """Batched NMF M-step, frames-major (X2 (B, N, F), Vs (B, R, N, F),
    W (B, F, K), H (B, K, N), g (B, N)) in the reference order W -> H ->
    L1 normalisation -> g. Every sample-buffer reduction runs on K2 with a
    given Vb: 'h' for the W and H updates, 'g' for the gain. With
    update_nmf=False only g updates, at Vb_fixed (B, N, F). Vs may be the
    chain's bfloat16 dumps; approx_recip goes to every sums pass. Returns
    (W, H, g)."""
    m3 = mask[..., None]

    def vb():
        if update_nmf:
            return torch.einsum("bfk,bkn->bnf", W, H).contiguous()
        return Vb_fixed

    def sums(Vb):
        a, b = nmf_sums(Vs, None, g, mode="h", Vb=Vb,
                        approx_recip=approx_recip)
        return b, a

    Vb = vb()
    if update_nmf:
        s2, s1 = sums(Vb)
        num = torch.einsum("bnf,bkn->bfk", X2 * s2 * m3, H)
        den = torch.einsum("bnf,bkn->bfk", s1 * m3, H)
        W = W * torch.sqrt(num / den)

        Vb = vb()
        s2, s1 = sums(Vb)
        num = torch.einsum("bnf,bfk->bkn", X2 * s2, W)
        den = torch.einsum("bnf,bfk->bkn", s1, W)
        H = H * torch.sqrt(num / den)

        norm_col = torch.sum(torch.abs(W), dim=1)          # (B, K)
        W = W / norm_col[:, None, :]
        H = H * norm_col[:, :, None]
        Vb = vb()

    num, den = nmf_sums(Vs, None, g, X2, mode="g", Vb=Vb,
                        approx_recip=approx_recip)
    g = g * torch.sqrt(num / den)
    return W, H, g


@torch.no_grad()
def mcem_batch_fused(model, X_abs2, mask, y, generator,
                     cfg: MCEMConfig = MCEMConfig(), update_nmf=True,
                     Vb_fixed=None, compute_cost=True, init=None,
                     samples_dtype=torch.float32, approx_recip=False,
                     approx_trans=False, matmul_dtype=torch.float32):
    """Full batched MCEM. X_abs2 (B, F, N) with benign pad frames, mask
    (B, N), y (B, y_dim, N) or None (M1), `generator` a torch.Generator on
    the tensors' device. Returns {"WFs", "WFn" (B, F, N), "cost" (B, niter),
    "W" (B, F, K), "H" (B, K, N), "g" (B, N), "Z" (B, L, N)}, and "b"
    ((B, N) or (B, n_bands, N)) when the noise gain is on.

    update_nmf=False keeps the noise variance at Vb_fixed (B, F, N) (the
    fixed-noise models spp / spp2) and draws no NMF init: W = ones
    (B, F, 1), H = zeros (B, 1, N). cfg.noise_gain then also learns a
    per-frame (or per-band) gain b on it.

    init: optional warm start in the result orientation: "W" and "H"
    replace the NMF init, "g" the unit gain and "Z" the encoder's posterior
    mean; each key is optional.

    Fast mode, as the JAX driver applies it: every E chain gets
    samples_dtype (its sample dumps), approx_recip and approx_trans; the WF
    chain approx_recip and approx_trans; every sums pass approx_recip. The
    initial Vs = decode(Z) stays exact, and the chain state stays float32.
    compute_cost=False skips the cost pass (the result's "cost" is zeros),
    as fast mode does. matmul_dtype=torch.bfloat16 runs the decoder
    products of every E chain and of the WF chain on bfloat16 operands
    (K1d); the initial decode stays float32.

    Every chain gets the mask's live flags (`mh_chain.live_pairs`): on
    the card the cluster form runs no chain on a tile pair of 32 frames
    that holds no valid frame, and leaves there Z, Vs and the chain's
    sums as a chain that rejects every proposal would. Valid frames do not
    change: no update mixes frames, and every sum over frames is masked.
    The `gvnmf.wf_chain` span counts the pairs (`k1_pairs`) and those the
    chains ran (`k1_live_pairs`: the live ones where the cluster form
    runs, every pair where another form or the CPU's plain version
    does)."""
    if cfg.noise_gain and update_nmf:
        raise ValueError(
            "MCEMConfig.noise_gain requires a fixed noise model "
            "(update_nmf=False, i.e. noise_model 'spp'/'spp2')")
    if not update_nmf and Vb_fixed is None:
        raise ValueError("update_nmf=False needs Vb_fixed (B, F, N)")
    init = init or {}
    dev = X_abs2.device
    mask = mask.to(torch.float32).contiguous()
    with span("gvnmf.engine", dev, niter=cfg.niter):
        with span("gvnmf.engine.init"):
            X2, ypre, Z, Vs, dec_w, Wt, H, Vbf, g, seeds = _start(
                model, X_abs2, y, generator, cfg, update_nmf, Vb_fixed,
                init, matmul_dtype)
            B, N, F = X2.shape
            b = eff_vb = band_map = None
            if cfg.noise_gain:
                b, eff_vb, band_map = noise_gain_state(
                    F, N, cfg.noise_gain_bands, Vbf, batch=B)
            # the plan's form may skip the tile pairs that hold no valid
            # frame
            live = live_pairs(mask)
            ran = live.numel()
            if dec_w["skips"]:
                ran = lambda: torch.count_nonzero(live)  # noqa: E731
        chain_kw = dict(nsamples=cfg.nsamples_E_step,
                        burnin=cfg.burnin_E_step, var_RW=cfg.var_RW,
                        samples_dtype=samples_dtype,
                        approx_recip=approx_recip, approx_trans=approx_trans,
                        matmul_dtype=matmul_dtype, live=live)
        sums_kw = dict(approx_recip=approx_recip)

        costs = []
        for it in range(cfg.niter):
            if update_nmf:
                with span("gvnmf.em.e_chain"):
                    Z, Vs, (samples, numW, denW) = mh_chain(
                        dec_w, X2, (Wt, H), g, ypre, Z, Vs, seeds[it],
                        mode="e", mask=mask, **chain_kw)
                with span("gvnmf.em.m_step"):
                    Wt2 = Wt * torch.sqrt(numW / denW)
                    numH, denH = nmf_sums(samples, (Wt2, H), g, X2,
                                          mode="h", **sums_kw)
                    H2 = H * torch.sqrt(numH / denH).transpose(1, 2)
                    norm_col = torch.sum(torch.abs(Wt2), dim=2)  # (B, K)
                    Wt = (Wt2 / norm_col[..., None]).contiguous()
                    H = (H2 * norm_col[:, :, None]).contiguous()
                    num_g, den_g = nmf_sums(samples, (Wt, H), g, X2,
                                            mode="g", **sums_kw)
                    g = g * torch.sqrt(num_g / den_g)
            elif cfg.noise_gain:
                # the chain and the 'h' sums run at the scaled Vb; the b
                # update splits the gradient with the unscaled Vbf
                # (band-restricted f-sums with several bands); g updates at
                # the new b
                Vb_eff = eff_vb(b)
                with span("gvnmf.em.e_chain"):
                    Z, Vs, (samples, _, _) = mh_chain(
                        dec_w, X2, None, g, ypre, Z, Vs, seeds[it],
                        mode="e", Vb=Vb_eff, **chain_kw)
                with span("gvnmf.em.m_step"):
                    s1, s2 = nmf_sums(samples, None, g, mode="h", Vb=Vb_eff,
                                      **sums_kw)
                    if band_map is None:
                        num_b = torch.sum(X2 * Vbf * s2, dim=-1)  # (B, N)
                        den_b = torch.sum(Vbf * s1, dim=-1)
                    else:
                        num_b = torch.einsum("bnf,kf->bkn", X2 * Vbf * s2,
                                             band_map)
                        den_b = torch.einsum("bnf,kf->bkn", Vbf * s1,
                                             band_map)
                    b = b * torch.sqrt(num_b / den_b)
                    Vb2 = eff_vb(b)
                    num_g, den_g = nmf_sums(samples, None, g, X2, mode="g",
                                            Vb=Vb2, **sums_kw)
                    g = g * torch.sqrt(num_g / den_g)
            else:
                with span("gvnmf.em.e_chain"):
                    Z, Vs, (samples, _, _) = mh_chain(
                        dec_w, X2, None, g, ypre, Z, Vs, seeds[it],
                        mode="e", Vb=Vbf, **chain_kw)
                with span("gvnmf.em.m_step"):
                    _, _, g = _nmf_m_step_batched(
                        X2, mask, None, None, g, samples, update_nmf=False,
                        Vb_fixed=Vbf, **sums_kw)
                Vb2 = Vbf
            if compute_cost:
                with span("gvnmf.em.cost"):
                    costs.append(em_cost(
                        samples, (Wt, H) if update_nmf else None, g, X2,
                        mask, Vb=None if update_nmf else Vb2))

        wf_kw = dict(nsamples=cfg.nsamples_WF, burnin=cfg.burnin_WF,
                     var_RW=cfg.var_RW, approx_recip=approx_recip,
                     approx_trans=approx_trans, matmul_dtype=matmul_dtype,
                     live=live)
        pairs = dict(k1_pairs=live.numel(), k1_live_pairs=ran)
        if update_nmf:
            with span("gvnmf.wf_chain", **pairs):
                Z, Vs, (ws, wn) = mh_chain(dec_w, X2, (Wt, H), g, ypre, Z,
                                           Vs, seeds[cfg.niter], mode="wf",
                                           **wf_kw)
        else:
            # the WF chain runs at the learned gain
            Vb_wf = eff_vb(b) if cfg.noise_gain else Vbf
            with span("gvnmf.wf_chain", **pairs):
                Z, Vs, (ws, wn) = mh_chain(dec_w, X2, None, g, ypre, Z, Vs,
                                           seeds[cfg.niter], mode="wf",
                                           Vb=Vb_wf, **wf_kw)
        out = em_result(cfg, ws, wn, costs, Wt.transpose(1, 2), H, g, Z)
        if cfg.noise_gain:
            out["b"] = b
        return out


def em_draws(generator, B, F, N, cfg, device, nmf=True):
    """The MCEM engines' draws from the batch's generator, in this order:
    with `nmf`, the NMF init W (B, F, K) and then H (B, K, N), uniform and
    floored at cfg.eps; then one chain seed an EM iteration and one for the
    WF chain, fetched to the host in a single transfer. Returns (W, H,
    seeds), W and H None without `nmf`."""
    W = H = None
    if nmf:
        K = cfg.nmf_rank
        W = torch.clamp_min(torch.rand((B, F, K), generator=generator,
                                       device=device), cfg.eps)
        H = torch.clamp_min(torch.rand((B, K, N), generator=generator,
                                       device=device), cfg.eps)
    seeds = torch.randint(0, 2**62, (cfg.niter + 1,), generator=generator,
                          device=device).tolist()
    return W, H, seeds


def em_result(cfg, ws, wn, costs, W, H, g, Z):
    """The MCEM engines' result: the Wiener filters "WFs", "WFn" (B, F, N),
    the WF chain's sums `ws`, `wn` (B, N, F) over its nsamples_WF samples;
    "cost" (B, niter), the iterations' costs stacked (zeros where none was
    computed); "W" (B, F, K), "H", "g" as given and "Z" (B, L, N) from the
    frames-major Z."""
    B = g.shape[0]
    return {
        "WFs": (ws / cfg.nsamples_WF).transpose(1, 2),
        "WFn": (wn / cfg.nsamples_WF).transpose(1, 2),
        "cost": (torch.stack(costs, dim=1) if costs
                 else torch.zeros((B, cfg.niter), device=g.device)),
        "W": W, "H": H, "g": g, "Z": Z.transpose(1, 2),
    }


def _start(model, X_abs2, y, generator, cfg, update_nmf, Vb_fixed, init,
           matmul_dtype):
    """The engine's starting state: the frames-major mixture power X2
    (B, N, F), the label pre-activation ypre, the encoder's Z and its
    decode Vs, the decoder planned once for every chain of the call
    (`mh_chain.plan_chain`), the NMF init (Wt (B, K, F), H), the fixed
    noise variance Vbf (frames-major, or None), the gain g and the chain
    seeds (:func:`em_draws`)."""
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
    W0, H0, seeds = em_draws(generator, B, F, N, cfg, dev,
                             nmf=update_nmf and "W" not in init)
    if "W" in init:
        Wt = init["W"].transpose(1, 2).contiguous()          # (B, K, F)
        H = init["H"].contiguous()
    elif update_nmf:
        Wt, H = W0.transpose(1, 2).contiguous(), H0
    else:
        Wt = torch.ones((B, 1, F), device=dev)
        H = torch.zeros((B, 1, N), device=dev)
    dec_w = plan_chain(dec_w, F, L, Wt.shape[1] if update_nmf else 0, N, dev,
                       matmul_dtype)
    Vbf = None if update_nmf else Vb_fixed.transpose(1, 2).contiguous()
    g = init["g"].contiguous() if "g" in init else torch.ones((B, N),
                                                             device=dev)
    return X2, ypre, Z, Vs, dec_w, Wt, H, Vbf, g, seeds
