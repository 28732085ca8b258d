"""MCEM hyper-parameters, the mixture-variance floor, the noise-gain state,
the eager helpers that PEEM runs on, and the eager MCEM engine.

Counterpart of `guided_vae_nmf_tpu/mcem/engine.py`: `MCEMConfig`,
`VX_FLOOR`, `_noise_gain_band_map` and `noise_gain_state` (both layouts),
and, batched over B in the reference (F, N) orientation,
`_precompute_label_proj`, `_decode_cond`, `framewise_uniform`,
`nmf_m_step`, `_noise_var` and `_masked_cost`; then the eager engine, the
JAX package's XLA engine: the MH chain `_mh_scan` with
`mh_sample_posterior` and `mh_wiener_filter`, `mcem_run`, `pad_power`,
`mcem_m1_batch` / `mcem_m2_batch` and the tol-stop runs
`mcem_run_converged` / `mcem_run_converged_batch`. One (B, L, N) chain
carries the whole batch in plain PyTorch operations on the tensors'
device; it launches neither K1 nor K2 (JAX's XLA engine reaches no Pallas
kernel either), and it takes any decoder and noise model, the `hybrid`
one (Vb = W H + Vb_fixed) included.

The eager chain draws from a counter hash, not from a generator that
advances: the normals and uniforms of a frame are a hash of (row seed,
chain, step, frame) alone, so a row's draws depend neither on the padded
N nor on the other rows of its batch (the property JAX's per-frame
`fold_in` gives its XLA engine). JAX's numbers cannot be reproduced, the
property can. For the run to keep that property, a row's arithmetic must
not depend on the batch either: cuBLAS and the reductions order float32
sums by the shapes they are given, and on the H100 a row run alone and in
a batch of four differed by float32 roundings that flipped accept
decisions (1 to 120 of 120 frames after 100 iterations; with the NMF
noise model a flip moves W, and W moves every frame). So the EM runs
(`mcem_run`, the tol-stop runs) compute in float64 whatever their inputs'
dtype, and return the inputs' dtype: a rounding difference then sits
nine orders of magnitude below the float32 ones the chain is compared
with, so decisions do not flip and the returned float32 values agree.
The chain functions compute in their inputs' dtype.
"""

import copy
import math
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


def _row_keys(seeds, device):
    """(B,) int64 hash keys in [0, 2^32) of per-row seeds (any integers;
    their low 64 bits count)."""
    s = [int(x) & (2**64 - 1) for x in seeds]
    lo = torch.tensor([x & _M32 for x in s], dtype=torch.int64,
                      device=device)
    hi = torch.tensor([x >> 32 for x in s], dtype=torch.int64, device=device)
    return _mix32(lo ^ hi)


def _hash_axes(h, shape):
    """Hashes of shape h.shape + shape: h mixed with each index of `shape`
    in turn, so an element depends on its indices, not on the extents."""
    for n in shape:
        idx = torch.arange(n, dtype=torch.int64, device=h.device)
        h = _mix32(h.reshape(h.shape + (1,)) ^ idx)
    return h


def _unit(h):
    """Uniforms in [0, 1) from 32-bit hashes (24 bits of each)."""
    return (h >> 8).to(torch.float32) * (1.0 / 16777216.0)


def framewise_uniform(seed, shape, device, *, stream=0):
    """Float32 uniforms in [0, 1) of `shape` whose element at index
    (i0, i1, ...) is a hash of (seed, stream, i0, i1, ...) alone: the same
    on every device and for every extent of the axes. An NMF init H
    (B, K, N) drawn from it, and the PEEM run that starts there, is the
    same on an utterance's valid frames however far its frame axis is
    padded. The JAX package folds the frame index into its key; its
    numbers cannot be reproduced, the property can."""
    h = _mix32(_row_keys([seed], device)[0] ^ stream)
    return _unit(_hash_axes(h, shape))


def _fold_in(generator, data):
    """A new generator on the same device whose seed is a function of
    `generator`'s seed and `data` only (the counterpart of JAX's
    `fold_in`): it does not depend on how far `generator` has advanced."""
    return torch.Generator(device=generator.device).manual_seed(
        fold_seed(generator.initial_seed(), data) >> 1)


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
               Vb_fixed=None, b=None, band_map=None, group=None):
    """Multiplicative W, H, g updates in the reference order: W; Vb; H;
    L1-normalise W with the compensating H rescale; Vb; g. Batched: X_abs2
    (B, F, N), mask (B, N) (pad frames out of the W sums), W (B, F, K), H
    (B, K, N), g (B, N), Vs_samples (B, R, F, N). With update_nmf=False
    only g updates, at Vb_fixed (B, F, N).

    b, fixed-noise models only: the noise gain (B, N), or (B, n_bands, N)
    with band_map (n_bands, F); Vb = scale(b) * Vb_fixed. b takes the
    gradient-split update of g (its coefficient in Vx is Vb_fixed, with
    the f-sums restricted to its band) before g does. Returns (W, H, g, b)
    when b is given, (W, H, g) otherwise.

    group: when the frame axis is sharded (`parallel.frame_sharded_mcem`),
    the shard's group; the W update's num / den, the only sums across
    frames, go through `group.all_sum`. H, g, b and W's L1 normalisation
    over F stay local."""

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
        if group is not None:
            num, den = group.all_sum(num), group.all_sum(den)
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


def _masked_cost(X_abs2, mask, Vb, g, Vs_samples, group=None):
    """(B,) expected negative log-likelihood over the valid frames; X_abs2
    and Vb (B, F, N), Vs_samples (B, R, F, N). Unfloored, as in the
    reference. With a frame-sharded `group`, the total and the count are
    summed over the shards."""
    Vx = g[:, None, None, :] * Vs_samples + Vb[:, None]
    per_bin = torch.log(Vx) + X_abs2[:, None] / Vx
    total = torch.sum(per_bin * mask[:, None, None, :], dim=(1, 2, 3))
    count = Vs_samples.shape[1] * X_abs2.shape[1] * torch.sum(mask, dim=1)
    if group is not None:
        total, count = group.all_sum(total), group.all_sum(count)
    return total / count


# ---------------------------------------------------------------------------
# The eager engine: counter-hash draws
# ---------------------------------------------------------------------------

# hash streams of a row key
_W_STREAM, _H_STREAM, _CHAIN_STREAM = 1, 2, 3


def fold_seed(seed, data):
    """A row seed derived from `seed` and `data` alone (a second pass, a
    refinement): the eager engine's counterpart of folding a JAX key."""
    return int(np.random.SeedSequence(
        [int(seed) & (2**64 - 1), data]).generate_state(1, np.uint64)[0])


def row_seeds(seed, B):
    """B row seeds derived from one seed (a generator's initial seed) and
    each row's index."""
    return [fold_seed(seed, r) for r in range(B)]


def _derive(keys, *words):
    """Keys mixed with each word in turn (an int or a (B,) tensor)."""
    for w in words:
        keys = _mix32(keys ^ w)
    return keys


def _nmf_init(keys, F, K, N, eps):
    """The NMF init of each row from its key: W (B, F, K) and H (B, K, N)
    uniforms clamped at eps; H's column n depends on (key, n) alone."""
    def draw(stream, shape):
        return torch.clamp_min(_unit(_hash_axes(_derive(keys, stream),
                                                shape)), eps)

    return draw(_W_STREAM, (F, K)), draw(_H_STREAM, (K, N))


def _chain_keys(keys, chain):
    """The keys of chain `chain` (an int, or a (B,) tensor of per-row chain
    counts) of each row: E chains 0, 1, ..., then the WF chain."""
    return _derive(keys, _CHAIN_STREAM, chain)


def _chain_draws(ckeys, n_steps, L, N):
    """A chain's draws from its (B,) keys: normals Zn (B, n_steps, L, N)
    (Box-Muller of two hash uniforms each) and accept uniforms U
    (B, n_steps, N) in [0, 1); element (b, m, ., n) is a hash of
    (ckeys[b], m, n) and its component."""
    h = _hash_axes(ckeys, (n_steps, N))
    U = _unit(_mix32(h))
    bits = _mix32(h[..., None] ^ torch.arange(1, 2 * L + 1,
                                              device=ckeys.device))
    u1 = ((bits[..., :L] >> 8) + 1).to(torch.float32) * (1.0 / 16777216.0)
    u2 = _unit(bits[..., L:])
    zn = torch.sqrt(-2.0 * torch.log(u1)) * torch.cos((2 * math.pi) * u2)
    return zn.transpose(-1, -2), U


# ---------------------------------------------------------------------------
# The eager engine: Metropolis-Hastings chains
# ---------------------------------------------------------------------------


def _mh_scan(decoder, y_pre, X_abs2, Vb, g, Z0, Vs0, n_steps, var_RW,
             step_extra, keys=None, noise=None):
    """`n_steps` of the random-walk MH chain over a batch: X_abs2, Vb, Vs0
    (B, F, N), g (B, N), Z0 (B, L, N), y_pre from
    :func:`_precompute_label_proj`. One decoder evaluation a step: the
    per-frame accept selects Z, the proposal's Vs and its Vx.
    `step_extra(m, Z, Vs, Vx)` takes each step's state (sample buffers, WF
    sums). The draws come from the chain's (B,) `keys`
    (:func:`_chain_draws`), or from `noise` = (Zn (B, n_steps, L, N),
    U (B, n_steps, N)), the recorded streams of the fixed-randomness test
    mode. Returns (Z, Vs)."""
    L, N = Z0.shape[1:]
    Zn, U = noise if noise is not None else _chain_draws(keys, n_steps, L,
                                                         N)
    sqrt_var = float(np.sqrt(np.float32(var_RW)))
    gb = g[:, None, :]
    Z, Vs = Z0, Vs0
    Vx = torch.clamp_min(gb * Vs + Vb, VX_FLOOR)
    for m in range(n_steps):
        Zp = Z + sqrt_var * Zn[:, m]
        Vsp = _decode_cond(decoder, y_pre, Zp)
        Vxp = torch.clamp_min(gb * Vsp + Vb, VX_FLOOR)
        acc = torch.sum(torch.log(Vx) - torch.log(Vxp)
                        + (1.0 / Vx - 1.0 / Vxp) * X_abs2, dim=1) \
            + 0.5 * torch.sum(Z**2 - Zp**2, dim=1)
        is_acc = (torch.log(U[:, m]) < acc)[:, None, :]
        Z = torch.where(is_acc, Zp, Z)
        Vs = torch.where(is_acc, Vsp, Vs)
        Vx = torch.where(is_acc, Vxp, Vx)
        step_extra(m, Z, Vs, Vx)
    return Z, Vs


def mh_sample_posterior(decoder, y_pre, X_abs2, Vb, g, Z0, Vs0, nsamples,
                        burnin, var_RW, keys=None, noise=None):
    """E-step chain: the `nsamples` post-burn-in speech variances in a
    (B, R, F, N) buffer. Returns (Z, Vs, samples)."""
    B, F, N = X_abs2.shape
    buf = X_abs2.new_empty((B, nsamples, F, N))

    def keep(m, Z, Vs, Vx):
        if m >= burnin:
            buf[:, m - burnin] = Vs

    Z, Vs = _mh_scan(decoder, y_pre, X_abs2, Vb, g, Z0, Vs0,
                     nsamples + burnin, var_RW, keep, keys=keys, noise=noise)
    return Z, Vs, buf


def mh_wiener_filter(decoder, y_pre, X_abs2, Vb, g, Z0, Vs0, nsamples,
                     burnin, var_RW, keys=None, noise=None):
    """Wiener-filter chain: the posterior means of g Vs / Vx and Vb / Vx
    over the post-burn-in steps. Returns (WFs, WFn, Z, Vs)."""
    acc = [torch.zeros_like(X_abs2), torch.zeros_like(X_abs2)]
    gb = g[:, None, :]

    def accumulate(m, Z, Vs, Vx):
        if m >= burnin:
            acc[0] = acc[0] + (gb * Vs) / Vx
            acc[1] = acc[1] + Vb / Vx

    Z, Vs = _mh_scan(decoder, y_pre, X_abs2, Vb, g, Z0, Vs0,
                     nsamples + burnin, var_RW, accumulate, keys=keys,
                     noise=noise)
    return acc[0] / nsamples, acc[1] / nsamples, Z, Vs


# ---------------------------------------------------------------------------
# The eager engine: EM runs
# ---------------------------------------------------------------------------


def _check_noise_model(cfg, update_nmf, Vb_fixed):
    if cfg.noise_gain and update_nmf:
        raise ValueError(
            "MCEMConfig.noise_gain requires a fixed noise model "
            "(update_nmf=False, i.e. noise_model 'spp'/'spp2')")
    if not update_nmf and Vb_fixed is None:
        raise ValueError("update_nmf=False needs Vb_fixed (B, F, N)")


# The EM runs' working precision (see the module docstring).
_WIDE = torch.float64


def _wide(t):
    return None if t is None else t.to(_WIDE)


class _Run:
    """The fixed parts of one batched eager run (float64 copies of the
    model, the spectrogram, the labels' projection and the noise model)
    and its EM iteration."""

    def __init__(self, model, X_abs2, mask, y, cfg, update_nmf, Vb_fixed,
                 group=None):
        self.out_dtype = X_abs2.dtype
        self.group = group
        wide = copy.deepcopy(model).to(_WIDE)
        self.enc, self.dec = wide.encoder, wide.decoder
        self.X, self.mask, self.y = _wide(X_abs2), _wide(mask), _wide(y)
        self.cfg, self.update_nmf = cfg, update_nmf
        self.Vb_fixed = _wide(Vb_fixed)
        y_dim = 0 if y is None else y.shape[1]
        self.L = self.dec.hidden[0].w.shape[0] - y_dim
        self.y_pre = _precompute_label_proj(self.dec, self.y, self.L)
        self.eff_vb = self.band_map = None
        self.use_b = cfg.noise_gain and not update_nmf

    def init_state(self, keys, init_nmf=None, init_Z=None):
        """{W, H, g, Z, Vs} (and the noise gain b) at the start of EM."""
        B, F, N = self.X.shape
        dev, cfg = self.X.device, self.cfg
        if init_nmf is not None:
            W, H, g = init_nmf
        else:
            if self.update_nmf:
                W, H = _nmf_init(keys, F, cfg.nmf_rank, N, cfg.eps)
            else:
                # a fixed noise variance: Vb = Vb_fixed, no NMF factors
                W = torch.ones((B, F, 1), device=dev)
                H = torch.zeros((B, 1, N), device=dev)
            g = torch.ones((B, N), device=dev)
        if init_Z is not None:
            Z = init_Z
        else:
            enc_in = (self.X if self.y is None
                      else torch.cat([self.X, self.y], dim=1))
            _, mu, _ = self.enc(enc_in.transpose(1, 2).reshape(B * N, -1))
            Z = mu.reshape(B, N, self.L).transpose(1, 2)
        W, H, g, Z = map(_wide, (W, H, g, Z))
        state = {"W": W, "H": H, "g": g, "Z": Z,
                 "Vs": _decode_cond(self.dec, self.y_pre, Z)}
        if self.use_b:
            state["b"], self.eff_vb, self.band_map = noise_gain_state(
                F, N, cfg.noise_gain_bands, self.Vb_fixed, B,
                frames_major=False)
        return state

    def noise_var(self, state):
        if self.use_b:
            return self.eff_vb(state["b"])
        return _noise_var(state["W"], state["H"], self.update_nmf,
                          self.Vb_fixed)

    def em_iter(self, state, ckeys=None, noise=None):
        """One EM iteration: the E chain, the M-step in the reference
        order, the cost. Returns (new state, cost (B,))."""
        cfg = self.cfg
        Z, Vs, samples = mh_sample_posterior(
            self.dec, self.y_pre, self.X, self.noise_var(state), state["g"],
            state["Z"], state["Vs"], cfg.nsamples_E_step, cfg.burnin_E_step,
            cfg.var_RW, keys=ckeys, noise=noise)
        new = {"Z": Z, "Vs": Vs}
        if self.use_b:
            new["W"], new["H"], new["g"], new["b"] = nmf_m_step(
                self.X, self.mask, state["W"], state["H"], state["g"],
                samples, update_nmf=False, Vb_fixed=self.Vb_fixed,
                b=state["b"], band_map=self.band_map)
        else:
            new["W"], new["H"], new["g"] = nmf_m_step(
                self.X, self.mask, state["W"], state["H"], state["g"],
                samples, update_nmf=self.update_nmf, Vb_fixed=self.Vb_fixed,
                group=self.group)
        cost = _masked_cost(self.X, self.mask, self.noise_var(new), new["g"],
                            samples, group=self.group)
        return new, cost

    def wiener(self, state, ckeys=None, noise=None):
        cfg = self.cfg
        WFs, WFn, Z, _ = mh_wiener_filter(
            self.dec, self.y_pre, self.X, self.noise_var(state), state["g"],
            state["Z"], state["Vs"], cfg.nsamples_WF, cfg.burnin_WF,
            cfg.var_RW, keys=ckeys, noise=noise)
        return WFs, WFn, Z

    def result(self, state, WFs, WFn, Z, cost):
        """The run's result dict, in the inputs' dtype."""
        out = {"WFs": WFs, "WFn": WFn, "cost": cost, "W": state["W"],
               "H": state["H"], "g": state["g"], "Z": Z}
        if self.use_b:
            out["b"] = state["b"]
        return {k: v.to(self.out_dtype) for k, v in out.items()}


@torch.no_grad()
def mcem_run(model, X_abs2, mask, y, seeds, cfg: MCEMConfig = MCEMConfig(),
             update_nmf=True, Vb_fixed=None, init_nmf=None, init_Z=None,
             noise=None, group=None):
    """The full MCEM loop on the eager engine, over a batch.

    X_abs2 (B, F, N) power with benign pad frames (:func:`pad_power`),
    mask (B, N), y (B, y_dim, N) or None (M1), `seeds` B row seeds (ints).
    update_nmf=False keeps the noise variance at Vb_fixed (B, F, N) (the
    fixed-noise models; cfg.noise_gain then learns a gain b on it);
    update_nmf=True with Vb_fixed is the `hybrid` noise model,
    Vb = W H + Vb_fixed. init_nmf: optional (W (B, F, K), H (B, K, N),
    g (B, N)) replacing the NMF init; init_Z: optional (B, L, N) replacing
    the encoder's posterior mean. noise: optional recorded streams
    replacing every draw, (Zn_E (B, niter, sE, L, N), U_E (B, niter, sE,
    N), Zn_WF (B, sWF, L, N), U_WF (B, sWF, N)) with sE / sWF the E / WF
    chain lengths; not with the noise gain. group: the frame shard's group
    when the frame axis is sharded over a mesh (see
    `parallel.frame_sharded_mcem`): the W update's sums and the cost's
    total and count are summed over the shards, the rest stays local.

    Computes in float64 (see the module docstring). Returns {"WFs", "WFn"
    (B, F, N), "cost" (B, niter), "W", "H", "g", "Z" (B, L, N)}, and "b"
    with the noise gain, in X_abs2's dtype."""
    _check_noise_model(cfg, update_nmf, Vb_fixed)
    if noise is not None and cfg.noise_gain:
        raise ValueError("fixed-randomness injection (noise=) is not "
                         "supported with noise_gain")
    keys = _row_keys(seeds, X_abs2.device)
    run = _Run(model, X_abs2, mask, y, cfg, update_nmf, Vb_fixed, group)
    state = run.init_state(keys, init_nmf, init_Z)
    costs = []
    for it in range(cfg.niter):
        state, cost = run.em_iter(
            state, ckeys=_chain_keys(keys, it),
            noise=None if noise is None else (noise[0][:, it],
                                              noise[1][:, it]))
        costs.append(cost)
    WFs, WFn, Z = run.wiener(
        state, ckeys=_chain_keys(keys, cfg.niter),
        noise=None if noise is None else (noise[2], noise[3]))
    cost = (torch.stack(costs, dim=1) if costs
            else run.X.new_zeros((X_abs2.shape[0], 0)))
    return run.result(state, WFs, WFn, Z, cost)


@torch.no_grad()
def mcem_run_converged_batch(model, X_abs2, mask, y, seeds,
                             cfg: MCEMConfig = MCEMConfig(), tol=1e-4,
                             check_every=5, update_nmf=True, Vb_fixed=None):
    """MCEM with cost-based early stopping, batched: EM in
    `check_every`-iteration chunks; after each chunk a row stops once its
    chunk-end cost fell by less than `tol` since the last chunk, and
    `cfg.niter` (rounded up to whole chunks) is the budget. A stopped row
    is frozen: its state and its chain counter stop advancing (the batch
    still computes it, and drops the result), so each row's run equals
    :func:`mcem_run_converged` on that row alone. The Wiener chain then
    runs for every row.

    Arguments as :func:`mcem_run`. Returns its dict, with "cost"
    (B, budget) (0 past a row's executed iterations) and "iters" (B,)
    int64, the iterations each row ran."""
    _check_noise_model(cfg, update_nmf, Vb_fixed)
    B = X_abs2.shape[0]
    dev = X_abs2.device
    keys = _row_keys(seeds, dev)
    run = _Run(model, X_abs2, mask, y, cfg, update_nmf, Vb_fixed)
    state = run.init_state(keys)
    n_chunks = -(-cfg.niter // check_every)
    hist = run.X.new_zeros((B, n_chunks * check_every))
    active = torch.ones((B,), dtype=torch.bool, device=dev)
    prev = run.X.new_full((B,), float("inf"))
    iters = torch.zeros((B,), dtype=torch.int64, device=dev)
    for ci in range(n_chunks):
        if not bool(active.any()):
            break
        new, costs = state, []
        for j in range(check_every):
            new, cost = run.em_iter(new, ckeys=_chain_keys(keys, iters + j))
            costs.append(cost)
        costs = torch.stack(costs, dim=1)
        state = {k: torch.where(active.reshape((B,) + (1,) * (v.dim() - 1)),
                                new[k], v) for k, v in state.items()}
        span = slice(ci * check_every, (ci + 1) * check_every)
        hist[:, span] = torch.where(active[:, None], costs, hist[:, span])
        cur = costs[:, -1]
        iters = torch.where(active, iters + check_every, iters)
        still = active & ((prev - cur) >= tol)
        prev = torch.where(active, cur, prev)
        active = still
    WFs, WFn, Z = run.wiener(state, ckeys=_chain_keys(keys, iters))
    out = run.result(state, WFs, WFn, Z, hist)
    out["iters"] = iters
    return out


def mcem_run_converged(model, X_abs2, mask, y, seed,
                       cfg: MCEMConfig = MCEMConfig(), tol=1e-4,
                       check_every=5, update_nmf=True, Vb_fixed=None):
    """:func:`mcem_run_converged_batch` on one utterance: X_abs2 (F, N),
    mask (N,), y (y_dim, N) or None, Vb_fixed (F, N) or None, one seed.
    Returns the unbatched dict, "cost" trimmed to the executed iterations
    and "iters" an int."""
    def one(t):
        return None if t is None else t[None]

    out = mcem_run_converged_batch(model, one(X_abs2), one(mask), one(y),
                                   [seed], cfg, tol, check_every,
                                   update_nmf, one(Vb_fixed))
    iters = int(out.pop("iters")[0])
    out = {k: v[0] for k, v in out.items()}
    out["cost"] = out["cost"][:iters]
    out["iters"] = iters
    return out


def pad_power(X_abs2, N_pad, pad_value=1.0):
    """Pad (..., F, N) power spectrograms to (..., F, N_pad) with benign
    positive frames; returns (padded, mask (..., N_pad))."""
    N = X_abs2.shape[-1]
    out = torch.nn.functional.pad(X_abs2, (0, N_pad - N), value=pad_value)
    mask = X_abs2.new_zeros(X_abs2.shape[:-2] + (N_pad,))
    mask[..., :N] = 1.0
    return out, mask


def mcem_m1_batch(model, X_abs2, mask, seeds, cfg: MCEMConfig,
                  update_nmf=True, Vb_fixed=None):
    """:func:`mcem_run` with the label-free M1 VAE."""
    return mcem_run(model, X_abs2, mask, None, seeds, cfg,
                    update_nmf=update_nmf, Vb_fixed=Vb_fixed)


def mcem_m2_batch(model, X_abs2, mask, y, seeds, cfg: MCEMConfig,
                  update_nmf=True, Vb_fixed=None):
    """:func:`mcem_run` with the label-guided M2 model, y (B, y_dim, N)."""
    return mcem_run(model, X_abs2, mask, y, seeds, cfg,
                    update_nmf=update_nmf, Vb_fixed=Vb_fixed)
