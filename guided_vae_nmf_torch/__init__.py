"""PyTorch + CUDA port of guided_vae_nmf_tpu for NVIDIA Hopper.

The JAX package `guided_vae_nmf_tpu` is the reference; this package runs
the M2-IBM enhancement main path, the fixed-noise path (spp / spp2 noise
models, noise gain, the real-noise and impulse-noise profiles, timo
labels), fast mode, the online service (`serving`, `http_serving`), the
streaming enhancers and their pool (`streaming`, the HTTP stream route),
the paper-config path (PEEM, the PEEM -> MCEM hybrid, `bench_niter500`)
and the evaluation protocol (`metrics`, the `gvnmf-torch` command line
`cli`, the evaluate / run_metrics / serve / doctor / streaming `scripts`)
in PyTorch, with hand-written CUDA kernels (`csrc/`) for the MH chain (K1)
and the NMF M-step sums (K2).

Float32 matrix products run in full float32, as the JAX path does.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def _wrappers():
    from .mcem.mh_chain import mh_chain
    from .mcem.nmf_sums import nmf_sums

    return {"mh_chain": mh_chain, "nmf_sums": nmf_sums}


def reset_launch_counts():
    """Set every kernel wrapper's launch counts to 0."""
    for fn in _wrappers().values():
        fn.launches = dict.fromkeys(fn.launches, 0)


def launch_counts():
    """Kernel launches per wrapper and variant since the last reset:
    {"mh_chain": {"e_wh": 100, "wf_wh": 1, "e_vb": 0, ..., "e_wh_fast": 0,
    ..., "wf_vb_trans": 0, "e_wh_mm16": 0, ..., "wf_vb_trans_mm16": 0},
    "nmf_sums": {"h_wh": 100, ..., "g_vb_fast": 0}} (exact variants, the
    fast-mode ones, then the chain's with bfloat16 decoder products; see
    `mcem.mh_chain` and `mcem.nmf_sums`)."""
    return {name: dict(fn.launches) for name, fn in _wrappers().items()}
