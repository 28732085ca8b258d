"""PyTorch + CUDA port of guided_vae_nmf_tpu for NVIDIA Hopper.

The JAX package `guided_vae_nmf_tpu` is the reference; this package runs
the same M2-IBM enhancement main path in PyTorch, with hand-written CUDA
kernels (`csrc/`) for the MH chain (K1) and the NMF M-step sums (K2).

Float32 matrix products run in full float32, as the JAX path does.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def reset_launch_counts():
    """Set every kernel wrapper's launch count to 0."""
    from .mcem.mh_chain import mh_chain
    from .mcem.nmf_sums import nmf_sums

    mh_chain.launches = 0
    nmf_sums.launches = 0


def launch_counts():
    from .mcem.mh_chain import mh_chain
    from .mcem.nmf_sums import nmf_sums

    return {"mh_chain": mh_chain.launches, "nmf_sums": nmf_sums.launches}
