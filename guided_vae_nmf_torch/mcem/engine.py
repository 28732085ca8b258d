"""MCEM hyper-parameters, the mixture-variance floor, the noise-gain state
and the eager helpers that PEEM runs on.

Counterpart of `guided_vae_nmf_tpu/mcem/engine.py`: `MCEMConfig`,
`VX_FLOOR`, `_noise_gain_band_map` and `noise_gain_state` (both layouts),
and, batched over B in the reference (F, N) orientation,
`_precompute_label_proj`, `_decode_cond`, `framewise_uniform`,
`nmf_m_step`, `_noise_var` and `_masked_cost`. The eager MH chain
(`_mh_scan`, `mcem_run`) is not ported (ROADMAP Queue 1, item 3): the fused
engine's chain kernel and its plain version stand in for it.
"""

from dataclasses import dataclass

import numpy as np
import torch

# Floor of the mixture variance Vx = g*Vs + Vb: late-EM underflow on
# near-silent bins would otherwise turn 1/Vx into inf.
VX_FLOOR = 1e-10


@dataclass(frozen=True)
class MCEMConfig:
    """Algorithm hyper-parameters; the defaults are the reference
    protocol's (100 EM iterations, E-chain 30 + 10, WF chain 75 + 25)."""

    niter: int = 100
    nsamples_E_step: int = 10
    burnin_E_step: int = 30
    nsamples_WF: int = 25
    burnin_WF: int = 75
    var_RW: float = 0.01
    nmf_rank: int = 10
    eps: float = 1e-8
    # noise_model='spp2' only: EM iterations of the first pass.
    spp2_pass1_niter: int = 25
    # Fixed-noise models only: learn a per-frame (or per-band) noise gain.
    noise_gain: bool = False
    noise_gain_bands: int = 1


def _noise_gain_band_map(F, n_bands, dtype=torch.float32, device=None):
    """(n_bands, F) 0/1 membership matrix of log-spaced frequency bands
    (band 0 includes the DC bin)."""
    if not 1 <= n_bands <= F:
        # an empty band would make its multiplicative update 0/0 = NaN
        raise ValueError(
            f"noise_gain_bands must be in [1, F={F}], got {n_bands}")
    edges = np.round(np.geomspace(1, F, n_bands + 1)).astype(np.int64)
    edges[0] = 0
    edges[-1] = F
    edges = np.maximum.accumulate(edges)
    for k in range(1, n_bands):              # force non-empty bands
        edges[k] = max(edges[k], edges[k - 1] + 1)
    m = np.zeros((n_bands, F), np.float32)
    for k in range(n_bands):
        m[k, edges[k]:edges[k + 1]] = 1.0
    return torch.as_tensor(m, dtype=dtype, device=device)


def noise_gain_state(F, N, n_bands, Vb_fixed, batch, frames_major=True):
    """Per-frame or per-band noise-gain state (MCEMConfig.noise_gain /
    noise_gain_bands): b (B, N) for one band or (B, n_bands, N), and the
    effective noise variance eff_vb(b) = scale(b) * Vb_fixed, contiguous.
    One definition for the fused engine and PEEM, so the band semantics
    cannot drift between them. Layouts: frames_major=True is the fused
    engine's, Vb_fixed (B, N, F); False is the reference orientation PEEM
    runs in, Vb_fixed (B, F, N) (the JAX package's unbatched layout with a
    batch axis in front).

    Returns (b0, eff_vb, band_map); band_map is None for one band."""
    dev, dtype = Vb_fixed.device, Vb_fixed.dtype
    if n_bands > 1:
        band_map = _noise_gain_band_map(F, n_bands, dtype, dev)
        b0 = torch.ones((batch, n_bands, N), dtype=dtype, device=dev)
        spec = "bkn,kf->bnf" if frames_major else "bkn,kf->bfn"

        def eff_vb(b_):                  # (B, K_b, N) -> Vb_fixed's layout
            return (torch.einsum(spec, b_, band_map) * Vb_fixed).contiguous()
    else:
        band_map = None
        b0 = torch.ones((batch, N), dtype=dtype, device=dev)

        def eff_vb(b_):                  # (B, N)
            scale = b_[:, :, None] if frames_major else b_[:, None, :]
            return (scale * Vb_fixed).contiguous()
    return b0, eff_vb, band_map


# ---------------------------------------------------------------------------
# Conditioned decoder
# ---------------------------------------------------------------------------


def _precompute_label_proj(decoder, y, L):
    """The label's share of the decoder's first layer, projected once:
    y (B, y_dim, N) -> y^T W1[L:] + b1 (B, N, h1); with y=None (M1) the
    bias alone, (1, 1, h1)."""
    l0 = decoder.hidden[0]
    if y is None:
        return l0.b[None, None, :]
    return torch.einsum("byn,yh->bnh", y, l0.w[L:]) + l0.b


def _decode_cond(decoder, y_pre, Z):
    """Decoder forward from Z (B, L, N) and the label projection
    (B, N, h1) -> speech variance Vs (B, F, N)."""
    l0 = decoder.hidden[0]
    L = Z.shape[1]
    h = torch.tanh(Z.transpose(1, 2) @ l0.w[:L] + y_pre)
    for layer in decoder.hidden[1:]:
        h = torch.tanh(layer(h))
    return torch.exp(decoder.out(h)).transpose(1, 2)


# ---------------------------------------------------------------------------
# Random init that does not depend on the padded length
# ---------------------------------------------------------------------------

_M32 = 0xFFFFFFFF


def _mul32(x, c):
    """(x * c) mod 2^32 for int64 x, c in [0, 2^32), with no intermediate
    past 2^49 (int64 products must not overflow)."""
    lo = (x & 0xFFFF) * c
    hi = ((x >> 16) * c) & 0xFFFF
    return (lo + (hi << 16)) & _M32


def _mix32(x):
    """A 32-bit integer hash (lowbias32) of int64 x in [0, 2^32)."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def framewise_uniform(seed, shape, device, *, stream=0):
    """Float32 uniforms in [0, 1) of `shape` whose element at index
    (i0, i1, ...) is a hash of (seed, stream, i0, i1, ...) alone: the same
    on every device and for every extent of the axes. An NMF init H
    (B, K, N) drawn from it, and the PEEM run that starts there, is the
    same on an utterance's valid frames however far its frame axis is
    padded. The JAX package folds the frame index into its key; its
    numbers cannot be reproduced, the property can."""
    seed = int(seed) & (2**64 - 1)
    h = torch.tensor(seed & _M32, dtype=torch.int64, device=device)
    for word in (seed >> 32, stream):
        h = _mix32(h ^ word)
    for axis, n in enumerate(shape):
        idx = torch.arange(n, dtype=torch.int64, device=device)
        h = _mix32(h[..., None] ^ idx) if axis else _mix32(h ^ idx)
    return (h >> 8).to(torch.float32) * (1.0 / 16777216.0)


def _fold_in(generator, data):
    """A new generator on the same device whose seed is a function of
    `generator`'s seed and `data` only (the counterpart of JAX's
    `fold_in`): it does not depend on how far `generator` has advanced."""
    seed = np.random.SeedSequence(
        [generator.initial_seed(), data]).generate_state(1, np.uint64)[0]
    return torch.Generator(device=generator.device).manual_seed(
        int(seed) >> 1)


# ---------------------------------------------------------------------------
# NMF M-step and cost (reference orientation, batched over B)
# ---------------------------------------------------------------------------


def _noise_var(W, H, update_nmf, Vb_fixed):
    """Noise variance of the noise models: NMF W H (B, F, N), the fixed
    Vb_fixed, or with both the SPP floor plus the NMF residual."""
    if not update_nmf:
        return Vb_fixed
    Vb = W @ H
    return Vb if Vb_fixed is None else Vb + Vb_fixed


def nmf_m_step(X_abs2, mask, W, H, g, Vs_samples, update_nmf=True,
               Vb_fixed=None, b=None, band_map=None):
    """Multiplicative W, H, g updates in the reference order: W; Vb; H;
    L1-normalise W with the compensating H rescale; Vb; g. Batched: X_abs2
    (B, F, N), mask (B, N) (pad frames out of the W sums), W (B, F, K), H
    (B, K, N), g (B, N), Vs_samples (B, R, F, N). With update_nmf=False
    only g updates, at Vb_fixed (B, F, N).

    b, fixed-noise models only: the noise gain (B, N), or (B, n_bands, N)
    with band_map (n_bands, F); Vb = scale(b) * Vb_fixed. b takes the
    gradient-split update of g (its coefficient in Vx is Vb_fixed, with
    the f-sums restricted to its band) before g does. Returns (W, H, g, b)
    when b is given, (W, H, g) otherwise."""

    def vx(Vb):                                      # (B, R, F, N)
        return torch.clamp_min(g[:, None, None, :] * Vs_samples
                               + Vb[:, None], VX_FLOOR)

    def g_update(Vx):
        num = torch.sum(X_abs2 * torch.sum(Vs_samples * Vx**-2, dim=1),
                        dim=1)
        den = torch.sum(torch.sum(Vs_samples * Vx**-1, dim=1), dim=1)
        return g * torch.sqrt(num / den)

    if b is not None:
        if update_nmf:
            raise ValueError("noise_gain requires a fixed noise model")
        if b.dim() == 3:
            def scaled(b_):
                return torch.einsum("kf,bkn->bfn", band_map, b_) * Vb_fixed

            def fsum(v):
                return torch.einsum("kf,bfn->bkn", band_map, v)
        else:
            def scaled(b_):
                return b_[:, None, :] * Vb_fixed

            def fsum(v):
                return torch.sum(v, dim=1)
        Vx = vx(scaled(b))
        num = fsum(X_abs2 * Vb_fixed * torch.sum(Vx**-2, dim=1))
        den = fsum(Vb_fixed * torch.sum(Vx**-1, dim=1))
        b = b * torch.sqrt(num / den)
        return W, H, g_update(vx(scaled(b))), b

    m = mask[:, None, :]
    Vb = _noise_var(W, H, update_nmf, Vb_fixed)
    if update_nmf:
        Vx = vx(Vb)
        s2 = torch.sum(Vx**-2, dim=1)
        s1 = torch.sum(Vx**-1, dim=1)
        num = torch.einsum("bfn,bkn->bfk", X_abs2 * s2 * m, H)
        den = torch.einsum("bfn,bkn->bfk", s1 * m, H)
        W = W * torch.sqrt(num / den)

        Vx = vx(_noise_var(W, H, True, Vb_fixed))
        s2 = torch.sum(Vx**-2, dim=1)
        s1 = torch.sum(Vx**-1, dim=1)
        num = torch.einsum("bfk,bfn->bkn", W, X_abs2 * s2)
        den = torch.einsum("bfk,bfn->bkn", W, s1)
        H = H * torch.sqrt(num / den)

        norm_col = torch.sum(torch.abs(W), dim=1)          # (B, K)
        W = W / norm_col[:, None, :]
        H = H * norm_col[:, :, None]
        Vb = _noise_var(W, H, True, Vb_fixed)
    return W, H, g_update(vx(Vb))


def _masked_cost(X_abs2, mask, Vb, g, Vs_samples):
    """(B,) expected negative log-likelihood over the valid frames; X_abs2
    and Vb (B, F, N), Vs_samples (B, R, F, N). Unfloored, as in the
    reference."""
    Vx = g[:, None, None, :] * Vs_samples + Vb[:, None]
    per_bin = torch.log(Vx) + X_abs2[:, None] / Vx
    total = torch.sum(per_bin * mask[:, None, None, :], dim=(1, 2, 3))
    count = Vs_samples.shape[1] * X_abs2.shape[1] * torch.sum(mask, dim=1)
    return total / count
