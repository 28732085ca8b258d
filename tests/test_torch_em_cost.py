"""The EM cost pass (`mcem.em_cost`) on the CPU: the plain version against
the JAX package's batched cost (`pallas_engine._masked_cost_batched`), in
the WH and Vb forms, over float32 and bfloat16 dumps; its per-frame sum
against the one-sum formula and float64; the wrapper's argument checks; a
row inside a longer padded batch against the row alone; and the fused
engine with and without the cost pass.

Tolerance: rtol 1e-5 / atol 1e-6. The cost is a mean of R N F float32
terms (log Vx + X2 / Vx, from about -4 to 50 here, a mean near 0.7) that
the versions add in other orders: the per-frame sum reads within 4.2e-7
of JAX's one sum and within 9.1e-8 of float64 at these shapes.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

from guided_vae_nmf_tpu.mcem.pallas_engine import (
    _masked_cost_batched as jax_cost)
from guided_vae_nmf_torch.mcem import MCEMConfig, mcem_batch_fused
from guided_vae_nmf_torch.mcem.em_cost import em_cost, em_cost_ref
from guided_vae_nmf_torch.models import dgm_init

torch.set_num_threads(2)

TOL = dict(rtol=1e-5, atol=1e-6)


def _case(seed, B=3, R=10, N=37, F=513, K=4, tail=True):
    """Dumps, NMF factors, the noise variance they give, g, X2 and a mask
    whose last row ends 11 frames early (`tail`)."""
    rng = np.random.RandomState(seed)
    f32 = lambda a: a.astype(np.float32)  # noqa: E731
    Wt = f32(rng.uniform(0.05, 0.5, (B, K, F)))
    H = f32(rng.uniform(0.05, 0.5, (B, K, N)))
    mask = np.ones((B, N), np.float32)
    if tail:
        mask[-1, N - 11:] = 0.0
    return {"samples": f32(rng.uniform(0.01, 2.0, (B, R, N, F))),
            "Wt": Wt, "H": H,
            "Vb": f32(np.einsum("bkn,bkf->bnf", H, Wt)),
            "g": f32(rng.uniform(0.5, 1.5, (B, N))),
            "X2": f32(rng.uniform(0.05, 1.05, (B, N, F))),
            "mask": mask}


def _args(c, form, dtype=torch.float32):
    t = torch.tensor
    samples = t(c["samples"]).to(dtype)
    if form == "wh":
        return (samples, (t(c["Wt"]), t(c["H"])), t(c["g"]), t(c["X2"]),
                t(c["mask"])), {}
    return (samples, None, t(c["g"]), t(c["X2"]), t(c["mask"])), \
        {"Vb": t(c["Vb"])}


def _one_sum(samples, Vb, g, X2, mask):
    """The cost as one masked sum over (R, N, F), the formula the fused
    engine used before the per-frame form, in the dtype given."""
    Vx = torch.clamp_min(g[:, None, :, None] * samples + Vb[:, None], 1e-10)
    per = torch.log(Vx) + X2[:, None] / Vx
    total = torch.sum(per * mask[:, None, :, None], dim=(1, 2, 3))
    return total / (samples.shape[1] * X2.shape[-1] * torch.sum(mask, dim=1))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("R", [1, 10])
@pytest.mark.parametrize("form", ["wh", "vb"])
def test_plain_cost_matches_jax(form, R, dtype):
    """F=513 (ragged against every tile), a masked tail; bfloat16 dumps
    against JAX over the same rounded values."""
    c = _case(1, R=R)
    args, kw = _args(c, form, dtype)
    got = em_cost(*args, **kw)
    samples = args[0].float().numpy()
    want = jax_cost(jnp.asarray(c["X2"]), jnp.asarray(c["mask"]),
                    jnp.asarray(c["Vb"]), jnp.asarray(c["g"]),
                    jnp.asarray(samples))
    assert got.shape == (3,) and got.dtype == torch.float32
    assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("mask", ["all", "tail", "holes"])
@pytest.mark.parametrize("form", ["wh", "vb"])
def test_per_frame_sum_matches_one_sum_and_float64(form, mask):
    """sum_n mask (sum_{r,f} per) equals the one masked sum over (r, n, f)
    within float32 rounding, and both the float64 evaluation."""
    c = _case(2, N=29, F=129, tail=mask == "tail")
    if mask == "holes":
        c["mask"][:, 3::5] = 0.0
    args, kw = _args(c, form)
    got = em_cost_ref(*args, **kw)
    t = torch.tensor
    one = _one_sum(t(c["samples"]), t(c["Vb"]), t(c["g"]), t(c["X2"]),
                   t(c["mask"]))
    f64 = _one_sum(*(t(c[k]).double() for k in ("samples", "Vb", "g", "X2",
                                                "mask")))
    assert_allclose(got.numpy(), one.numpy(), **TOL)
    assert_allclose(got.double().numpy(), f64.numpy(), **TOL)


def _bad_cases():
    c = _case(3, B=2, R=2, N=8, F=33)
    t = torch.tensor
    ok = dict(samples=t(c["samples"]), WH=(t(c["Wt"]), t(c["H"])),
              g=t(c["g"]), X2=t(c["X2"]), mask=t(c["mask"]), Vb=None)
    return c, ok


BAD = {
    "both": lambda c, a: dict(a, Vb=torch.tensor(c["Vb"])),
    "neither": lambda c, a: dict(a, WH=None),
    "samples_3d": lambda c, a: dict(a, samples=a["samples"][0]),
    "g": lambda c, a: dict(a, g=a["g"][:, :-1]),
    "X2": lambda c, a: dict(a, X2=a["X2"][..., :-1]),
    "mask": lambda c, a: dict(a, mask=a["mask"][:1]),
    "Wt": lambda c, a: dict(a, WH=(a["WH"][0][..., :-1], a["WH"][1])),
    "H": lambda c, a: dict(a, WH=(a["WH"][0], a["WH"][1][..., :-1])),
    "Vb": lambda c, a: dict(a, WH=None,
                            Vb=torch.tensor(c["Vb"])[:, :-1]),
    "device": lambda c, a: {k: (None if v is None else
                                tuple(x.to("meta") for x in v)
                                if isinstance(v, tuple) else v.to("meta"))
                            for k, v in a.items()},
}


@pytest.mark.parametrize("bad", sorted(BAD))
def test_wrapper_rejects_bad_arguments(bad):
    """Each check raises ValueError before any arithmetic; the unbroken
    call runs."""
    c, ok = _bad_cases()
    assert em_cost(**ok).shape == (2,)
    with pytest.raises(ValueError):
        em_cost(**BAD[bad](c, ok))


@pytest.mark.parametrize("form", ["wh", "vb"])
def test_padded_row_equals_row_alone(form):
    """A row alone, and the same row inside a batch of three whose other
    rows and whose 19 extra frames (mask 0, other values) differ."""
    c = _case(4, B=3, N=48, F=65)
    alone = {"samples": c["samples"][1:2, :, :29], "Wt": c["Wt"][1:2],
             "H": c["H"][1:2, :, :29], "Vb": c["Vb"][1:2, :29],
             "g": c["g"][1:2, :29], "X2": c["X2"][1:2, :29],
             "mask": np.ones((1, 29), np.float32)}
    c["mask"][1, 29:] = 0.0
    args, kw = _args(c, form)
    got = em_cost(*args, **kw)
    args, kw = _args(alone, form)
    want = em_cost(*args, **kw)
    assert_allclose(got[1:2].numpy(), want.numpy(), rtol=1e-6, atol=0)


@pytest.mark.parametrize("noise", ["nmf", "fixed", "gain"])
def test_cost_pass_leaves_other_outputs_unchanged(noise):
    """mcem_batch_fused with and without the cost pass: every other output
    bit for bit, the cost finite where computed and zeros where not."""
    B, F, N, y_dim = 2, 33, 24, 6
    model = dgm_init(torch.Generator().manual_seed(5), [F, y_dim, 8, [16]])
    rng = np.random.RandomState(6)
    X = torch.tensor(rng.uniform(0.05, 1.05, (B, F, N)).astype(np.float32))
    mask = torch.ones(B, N)
    mask[1, 17:] = 0.0
    y = torch.tensor((rng.uniform(size=(B, y_dim, N)) > 0.5).astype(
        np.float32))
    cfg = MCEMConfig(niter=2, nsamples_E_step=2, burnin_E_step=1,
                     nsamples_WF=2, burnin_WF=1, nmf_rank=3,
                     noise_gain=noise == "gain")
    kw = {}
    if noise != "nmf":
        kw = dict(update_nmf=False, Vb_fixed=torch.tensor(
            rng.uniform(0.01, 0.3, (B, F, N)).astype(np.float32)))
    outs = [mcem_batch_fused(model, X, mask, y,
                             torch.Generator().manual_seed(7), cfg,
                             compute_cost=cc, **kw) for cc in (True, False)]
    assert set(outs[0]) == set(outs[1])
    for k in outs[0]:
        if k != "cost":
            assert torch.equal(outs[0][k], outs[1][k]), k
    assert bool(torch.isfinite(outs[0]["cost"]).all())
    assert not outs[1]["cost"].any()
