"""MCEM hyper-parameters, the mixture-variance floor and the noise-gain
state.

Counterpart of the config part of `guided_vae_nmf_tpu/mcem/engine.py` and of
its `_noise_gain_band_map` / `noise_gain_state` (the batched layout the
fused engine uses). The eager engine itself (`_mh_scan`, `nmf_m_step`,
`mcem_run`) and the unbatched noise-gain layout are not ported yet (ROADMAP
Queue 1, item 3).
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


def noise_gain_state(F, N, n_bands, Vb_fixed, batch):
    """Per-frame or per-band noise-gain state (MCEMConfig.noise_gain /
    noise_gain_bands) in the fused engine's layout: Vb_fixed (B, N, F), b
    (B, N) for one band or (B, n_bands, N), and the effective noise variance
    eff_vb(b) = scale(b) * Vb_fixed (B, N, F), contiguous.

    Returns (b0, eff_vb, band_map); band_map is None for one band."""
    dev, dtype = Vb_fixed.device, Vb_fixed.dtype
    if n_bands > 1:
        band_map = _noise_gain_band_map(F, n_bands, dtype, dev)
        b0 = torch.ones((batch, n_bands, N), dtype=dtype, device=dev)

        def eff_vb(b_):                  # (B, K_b, N) -> (B, N, F)
            return (torch.einsum("bkn,kf->bnf", b_, band_map)
                    * Vb_fixed).contiguous()
    else:
        band_map = None
        b0 = torch.ones((batch, N), dtype=dtype, device=dev)

        def eff_vb(b_):                  # (B, N)
            return (b_[:, :, None] * Vb_fixed).contiguous()
    return b0, eff_vb, band_map
