"""The reference's streams against the card's: the Philox draws the
reference computes for a chain's seed equal the ones the program's chain
kernel draws (its `philox_streams` diagnostic), within float32 rounding of
the Box-Muller transcendentals. Needs an NVIDIA GPU; skips without one."""

import pytest
import tiny  # noqa: F401  (puts the checkout on sys.path)
import torch

from gvbench.reference.philox import philox_streams


@pytest.mark.cuda
def test_reference_philox_matches_the_kernel():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from guided_vae_nmf_torch.mcem.mh_chain import philox_streams as card

    dev = torch.device("cuda:0")
    for seed in (0, 11, 2**62 + 12345, 2**64 - 1):
        zn, u = card(seed, 3, 40, 32, 7, dev)
        rz, ru = philox_streams(seed, 3, 40, 32, 7, dev)
        assert torch.equal(u, ru)
        assert float((zn - rz).abs().max()) < 1e-5
