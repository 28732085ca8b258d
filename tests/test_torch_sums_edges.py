"""K2 (M-step sums) at the edges of its contract: the port's plain version
against the JAX Pallas kernel at R = 1 and 2, K = 1 and 16, F = 65 and 129,
float32 and bfloat16 samples, 'h' and 'g' mode, the NMF-factor form (WH=)
and the given-noise-variance form (Vb=); and the wrapper's shape check.

On the CPU the JAX kernel runs in the Pallas TPU interpreter, as
tests/mcem/test_pallas.py runs it; the port's wrapper runs its plain
version because the tensors lie on the CPU. Inputs are made with numpy
from a seed and handed to both packages; bfloat16 samples are the same
float32 values rounded to nearest even in both. Tolerance: atol 2e-5 /
rtol 2e-4 (float32, sums in another order). The CUDA kernel is held
against the plain version in test_torch_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

from guided_vae_nmf_tpu.mcem.pallas_engine import nmf_sums_pallas
from guided_vae_nmf_torch.mcem import nmf_sums, nmf_sums_ref
from guided_vae_nmf_torch.mcem.nmf_sums import FMAX, NARROW_RANK, check_widths

torch.set_num_threads(2)

B, N = 2, 128
TOL = dict(atol=2e-5, rtol=2e-4)

# (R, K, F, samples dtype, mode, form)
CASES = [
    (1, 1, 65, "float32", "h", "wh"),
    (2, 16, 129, "float32", "h", "wh"),
    (1, 16, 129, "float32", "g", "wh"),
    (2, 1, 65, "float32", "g", "wh"),
    (1, 0, 129, "float32", "h", "vb"),
    (2, 0, 129, "float32", "g", "vb"),
    (2, 3, 129, "bfloat16", "h", "wh"),
    (2, 3, 65, "bfloat16", "g", "wh"),
    (1, 0, 65, "bfloat16", "h", "vb"),
    (2, 0, 129, "bfloat16", "g", "vb"),
]


def _case(seed, R, K, F, dtype):
    rng = np.random.RandomState(seed)
    samples = rng.uniform(0.01, 2.0, (B, R, N, F)).astype(np.float32)
    return {
        "samples": samples,
        "X2": rng.uniform(0.05, 1.05, (B, N, F)).astype(np.float32),
        "Wt": rng.uniform(0.05, 0.5, (B, max(K, 1), F)).astype(np.float32),
        "H": rng.uniform(0.05, 0.5, (B, max(K, 1), N)).astype(np.float32),
        "g": rng.uniform(0.5, 1.5, (B, N)).astype(np.float32),
        "Vb": rng.uniform(0.01, 0.3, (B, N, F)).astype(np.float32),
    }


@pytest.mark.parametrize("R,K,F,dtype,mode,form", CASES)
def test_sums_edges_match_pallas(R, K, F, dtype, mode, form):
    c = _case(R * 100 + K + F, R, K, F, dtype)
    wh = form == "wh"
    sj = jnp.asarray(c["samples"]).astype(getattr(jnp, dtype))
    st = torch.tensor(c["samples"]).to(getattr(torch, dtype))
    oj = nmf_sums_pallas(
        sj, None if wh else jnp.asarray(c["Vb"]), jnp.asarray(c["g"]),
        X2=jnp.asarray(c["X2"]), mode=mode,
        WH=(jnp.asarray(c["Wt"]), jnp.asarray(c["H"])) if wh else None)
    t = lambda k: torch.tensor(c[k])  # noqa: E731
    ot = nmf_sums_ref(st, (t("Wt"), t("H")) if wh else None, t("g"),
                      t("X2"), mode=mode, Vb=None if wh else t("Vb"))
    want = {("h", "wh"): (B, N, K), ("h", "vb"): (B, N, F)}.get(
        (mode, form), (B, N))
    for a, b in zip(ot, oj):
        assert tuple(a.shape) == want == tuple(np.shape(b))
        assert_allclose(a.numpy(), np.asarray(b), **TOL)


@pytest.mark.parametrize("F,K", [(1, 1), (1, None), (65, NARROW_RANK),
                                 (129, None), (513, 10), (FMAX, 1),
                                 (FMAX, None), (65, NARROW_RANK + 1),
                                 (513, 64)])
def test_check_widths_takes_what_the_kernel_takes(F, K):
    """F from 1 to FMAX; any K >= 1 in the WH form (None: Vb), past
    NARROW_RANK on the wide kernel."""
    check_widths(F, K)


@pytest.mark.parametrize("F,K,match", [
    (0, None, "F=0"), (FMAX + 1, None, f"F={FMAX + 1}"),
    (FMAX + 1, 10, f"F={FMAX + 1}"), (65, 0, "NMF rank 0"),
    (513, -1, "NMF rank -1")])
def test_check_widths_rejects_what_the_kernel_does_not_take(F, K, match):
    with pytest.raises(ValueError, match=match):
        check_widths(F, K)


def test_plain_version_takes_any_width_on_cpu():
    """The kernel's F limit binds only on the card: on the CPU the wrapper
    runs the plain version at any F."""
    F = FMAX + 3
    c = _case(7, 2, 2, F, "float32")
    t = lambda k: torch.tensor(c[k])  # noqa: E731
    for mode in ("h", "g"):
        args = (t("samples"), (t("Wt"), t("H")), t("g"), t("X2"))
        for a, b in zip(nmf_sums(*args, mode=mode),
                        nmf_sums_ref(*args, mode=mode)):
            assert torch.equal(a, b)
