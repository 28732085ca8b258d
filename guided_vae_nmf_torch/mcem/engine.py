"""MCEM hyper-parameters and the mixture-variance floor.

Counterpart of the config part of `guided_vae_nmf_tpu/mcem/engine.py`.
The eager engine itself (`_mh_scan`, `nmf_m_step`, `mcem_run`) is not
ported yet (ROADMAP Queue 1, item 3).
"""

from dataclasses import dataclass

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
