"""PyTorch + CUDA port of guided_vae_nmf_tpu for NVIDIA Hopper.

The JAX package `guided_vae_nmf_tpu` is the reference; this package runs
the M2-IBM enhancement main path, the fixed-noise path (spp / spp2 noise
models, noise gain, the real-noise and impulse-noise profiles, timo
labels), fast mode, the online service (`serving`, `http_serving`), the
streaming enhancers and their pool (`streaming`, the HTTP stream route),
the paper-config path (PEEM, the PEEM -> MCEM hybrid, `bench_niter500`)
and the evaluation protocol (`metrics`, the `gvnmf-torch` command line
`cli`, the evaluate / run_metrics / serve / doctor / streaming `scripts`)
in PyTorch, with hand-written CUDA kernels (`csrc/`) for the MH chain (K1),
the NMF M-step sums (K2), the EM cost pass (`mcem.em_cost`) and the RVAE
decoder's sweeps (`mcem.lstm_sweep`).

Float32 matrix products run in full float32, as the JAX path does.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def _wrappers():
    from .mcem import lstm_sweep
    from .mcem.em_cost import em_cost
    from .mcem.mh_chain import mh_chain
    from .mcem.nmf_sums import nmf_sums

    return {"mh_chain": mh_chain, "nmf_sums": nmf_sums,
            "lstm_sweep": lstm_sweep.kernels, "em_cost": em_cost}


def reset_launch_counts():
    """Set every kernel wrapper's launch counts to 0."""
    from . import _launches

    for fn in _wrappers().values():
        _launches.reset(fn)


def launch_counts():
    """Kernel launches per wrapper and variant since the last reset:
    {"mh_chain": {"e_wh": 100, "wf_wh": 1, "e_vb": 0, ..., "e_wh_fast": 0,
    ..., "wf_vb_trans": 0, "e_wh_mm16": 0, ..., "wf_vb_trans_mm16": 0},
    "nmf_sums": {"h_wh": 100, ..., "g_vb_fast": 0}, "lstm_sweep": {"fwd":
    0, "bwd": 0, "lik": 0, "update": 0}, "em_cost": {"wh": 100, "vb": 0,
    "wh_fast": 0, "vb_fast": 0}} (exact variants, the fast-mode ones, then
    the chain's with bfloat16 decoder products; the RVAE's Langevin step
    kernels; the EM cost pass, once an EM iteration where the cost is
    computed, in the WH or Vb form over float32 dumps, "_fast" over
    bfloat16 ones; see `mcem.mh_chain`, `mcem.nmf_sums`, `mcem.lstm_sweep`
    and `mcem.em_cost`)."""
    return {name: dict(fn.launches) for name, fn in _wrappers().items()}
