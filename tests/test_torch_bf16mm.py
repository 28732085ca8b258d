"""K1d, the chain with the decoder's products on bfloat16 operands
(`matmul_dtype=torch.bfloat16`): the port's plain version against the
Pallas kernel (`mh_chain_pallas(matmul_dtype=jnp.bfloat16)`) in interpret
mode, the fused driver with the option against JAX's from the same warm
start, and the paper-config harness at tiny sizes.

On the CPU XLA computes a bfloat16 x bfloat16 product with
`preferred_element_type=float32` as a float32 sum of the exact products
(`test_xla_bf16_dot_sums_exact_products` holds it to that), which is what
the port's plain version computes (`a.to(bf16).float() @ b.to(bf16).float()`),
in another order. A different order can move a hidden output across a
bfloat16 rounding boundary and change that operand by one bfloat16 ulp; at
these sizes no element moves, so the outputs are held at the exact-mode
tolerance, atol 2e-5 / rtol 2e-4, and the bfloat16 outputs must differ from
the float32 chain's, or the check would be vacuous.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

import test_torch_fast as fast_cases
from guided_vae_nmf_tpu.mcem import MCEMConfig as JaxConfig
from guided_vae_nmf_tpu.mcem import mcem_batch_fused as jax_fused
from guided_vae_nmf_tpu.models import dgm_init
from guided_vae_nmf_torch.mcem import MCEMConfig, mcem_batch_fused
from guided_vae_nmf_torch.mcem import mh_chain, mh_chain_ref
from guided_vae_nmf_torch.mcem.mh_chain import _variant, bf16_weights
from guided_vae_nmf_torch.mcem.fused_engine import _dec_parts
from guided_vae_nmf_torch.models import module_from_params

torch.set_num_threads(2)

B, F, N, L, H, K, Y = (fast_cases.B, fast_cases.F, fast_cases.N,
                       fast_cases.L, fast_cases.H, fast_cases.K, fast_cases.Y)
TOL = dict(atol=2e-5, rtol=2e-4)


def _past_tol(a, b):
    return int(np.sum(np.abs(a - b) > TOL["atol"] + TOL["rtol"] * np.abs(b)))


def test_xla_bf16_dot_sums_exact_products():
    """`jnp.dot(bf16, bf16, preferred_element_type=f32)` on the CPU equals
    the float32 product of the rounded operands to float32 rounding (and
    not the product of the unrounded ones)."""
    rng = np.random.RandomState(0)
    a = rng.randn(16, 128).astype(np.float32)
    b = rng.randn(128, 513).astype(np.float32)
    ab, bb = jnp.asarray(a, jnp.bfloat16), jnp.asarray(b, jnp.bfloat16)
    got = np.asarray(jax.jit(lambda x, y: jnp.dot(
        x, y, preferred_element_type=jnp.float32))(ab, bb))
    exact = (np.asarray(ab, np.float64) @ np.asarray(bb, np.float64))
    assert_allclose(got, exact, rtol=1e-5, atol=1e-5)
    plain = (torch.tensor(a).to(torch.bfloat16).float()
             @ torch.tensor(b).to(torch.bfloat16).float()).numpy()
    assert_allclose(plain, exact, rtol=1e-5, atol=1e-5)
    assert np.abs(got - a @ b).max() > 1e-2


@pytest.mark.parametrize("form", ["wh", "vb"])
@pytest.mark.parametrize("mode", ["e", "wf"])
def test_bf16mm_chain_matches_pallas(mode, form):
    """K1d's plain version against the Pallas chain with bfloat16 products,
    under the same injected streams."""
    c = fast_cases._case(1)
    ns, bi = (3, 2) if mode == "e" else (4, 3)
    noise = fast_cases._noise(2, ns + bi)
    vb = form == "vb"
    ref = fast_cases._jax_chain(c, mode, ns, bi, noise, vb,
                                matmul_dtype=jnp.bfloat16)
    got = fast_cases._torch_chain(mh_chain, c, mode, ns, bi, noise, vb,
                                  matmul_dtype=torch.bfloat16)
    f32 = fast_cases._torch_chain(mh_chain, c, mode, ns, bi, noise, vb)
    for a, b, e in zip((got[0], got[1]) + got[2], (ref[0], ref[1]) + ref[2],
                       (f32[0], f32[1]) + f32[2]):
        assert a.dtype == torch.float32
        assert tuple(a.shape) == tuple(b.shape)
        assert_allclose(a.numpy(), np.asarray(b), **TOL)
    # Vs: the products really ran on rounded operands
    assert _past_tol(f32[1].numpy(), np.asarray(ref[1])) > 0.5 * ref[1].size


def test_bf16_weights_round_once():
    dec = module_from_params(dgm_init(jax.random.PRNGKey(3),
                                      [F, Y, L, [H, H]])).decoder
    dec_w = _dec_parts(dec, L)
    r = bf16_weights(dec_w)
    assert set(r) == {"w1", "mid", "wo", "bo"} and r["bo"] is dec_w["bo"]
    for w, w0 in ((r["w1"], dec_w["w1"]), (r["mid"][0][0], dec_w["mid"][0][0]),
                  (r["wo"], dec_w["wo"])):
        assert w.dtype == torch.float32
        assert torch.equal(w, w0.to(torch.bfloat16).float())
    assert torch.equal(bf16_weights(r)["wo"], r["wo"])     # idempotent


def test_matmul_dtype_launch_keys_and_refusals():
    assert _variant("e", "wh", torch.bfloat16, True, False,
                    torch.bfloat16) == "e_wh_fast_mm16"
    assert _variant("wf", "wh", torch.float32, True, False,
                    torch.bfloat16) == "wf_wh_fast_mm16"
    assert _variant("e", "vb", torch.float32, False, True,
                    torch.bfloat16) == "e_vb_trans_mm16"
    assert _variant("e", "vb", torch.float32, False, False,
                    torch.bfloat16) == "e_vb_mm16"
    assert _variant("e", "wh", torch.float32, False, False) == "e_wh"
    # 24 keys of the cluster form and the same 24 of the general form
    # (K1g: "_gen" after the form) and of the extended cluster form (K1e:
    # "_ext")
    cluster = [k for k in mh_chain.launches
               if "_gen" not in k and "_ext" not in k]
    assert len(cluster) == 24 and len(mh_chain.launches) == 72
    assert all(f"{k}_mm16" in mh_chain.launches for k in cluster
               if not k.endswith("_mm16"))
    for tag in ("_gen", "_ext"):
        assert all(k.replace("_wh", "_wh" + tag, 1).replace(
            "_vb", "_vb" + tag, 1) in mh_chain.launches for k in cluster)
    c = fast_cases._case(4)
    noise = fast_cases._noise(5, 3)
    for bad in (torch.float16, jnp.bfloat16, "bf16"):
        for fn in (mh_chain, mh_chain_ref):
            with pytest.raises(ValueError, match="matmul_dtype"):
                fast_cases._torch_chain(fn, c, "wf", 2, 1, noise, True,
                                        matmul_dtype=bad)


@pytest.mark.parametrize("noise_model", ["nmf", "fixed"])
def test_bf16mm_driver_matches_jax_var0(noise_model):
    """`mcem_batch_fused(matmul_dtype=bf16)` with the harness's fast_bf16mm
    options against JAX's from the same warm start, niter=2, var_RW=0, with
    JAX's reciprocal exact; rtol 2e-3 as for the fast driver (one-ulp
    bfloat16 dump roundings carried through two multiplicative updates)."""
    tree = dgm_init(jax.random.PRNGKey(0), [F, Y, L, [H, H]])
    X, mask, y, init, Vb = fast_cases._engine_inputs(9)
    small = dict(niter=2, nsamples_E_step=2, burnin_E_step=1, nsamples_WF=2,
                 burnin_WF=1, nmf_rank=K, var_RW=0.0)
    fixed = noise_model == "fixed"
    kw = dict(update_nmf=not fixed, compute_cost=False)
    ref = jax_fused(tree, jnp.asarray(X), jnp.asarray(mask), jnp.asarray(y),
                    jax.random.split(jax.random.PRNGKey(2), B),
                    JaxConfig(**small),
                    Vb_fixed=jnp.asarray(Vb) if fixed else None,
                    init={k: jnp.asarray(v) for k, v in init.items()},
                    samples_dtype=jnp.bfloat16, matmul_dtype=jnp.bfloat16,
                    **kw)
    t = fast_cases._t
    args = (module_from_params(tree), t(X), t(mask), t(y),
            torch.Generator().manual_seed(0), MCEMConfig(**small))
    common = dict(Vb_fixed=t(Vb) if fixed else None,
                  init={k: t(v) for k, v in init.items()},
                  samples_dtype=torch.bfloat16, approx_recip=True, **kw)
    got = mcem_batch_fused(*args, matmul_dtype=torch.bfloat16, **common)
    f32 = mcem_batch_fused(*args, **common)
    assert set(got) == set(ref)
    for k in ref:
        assert_allclose(got[k].numpy(), np.asarray(ref[k]), rtol=2e-3,
                        atol=2e-5, err_msg=k)
    # the option reached the chains: the float32 products' filters differ
    assert _past_tol(f32["WFs"].numpy(), np.asarray(ref["WFs"])) > 0


def test_harness_prints_one_json_line(capsys):
    """The paper-config harness on the CPU at tiny sizes with the shipped
    M2-IBM weights: one JSON line with every variant's keys."""
    from guided_vae_nmf_torch import bench_niter500

    out = bench_niter500.main(["--batch", "1", "--n", "16", "--niter", "1",
                               "--peem", "1", "--hybrid", "1",
                               "--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    rec = json.loads(lines[-1])
    assert rec == out
    assert sum(line.startswith("{") for line in lines) == 1
    for v in bench_niter500.VARIANTS:
        assert rec[f"{v}_s"] > 0 and rec[f"{v}_rtf"] > 0
    for k in ("peem_s", "peem_rtf", "peem_vs_fast_mcem", "hybrid_s",
              "hybrid_rtf"):
        assert rec[k] > 0
    assert rec["hybrid_refine"] == 1 and rec["device"] == "cpu"
    assert rec["batch"] == 1 and rec["n_frames"] == 16 and rec["niter"] == 1
