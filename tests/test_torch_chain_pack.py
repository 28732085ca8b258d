"""The chain kernel's per-CTA weight blocks (`mh_chain.pack_weights`).

The CUDA chain runs on thread-block clusters of `CLUSTER` CTAs; rank r
holds output bins [r Fsl, (r+1) Fsl) and hidden units [r Hsl, (r+1) Hsl)
of every decoder weight in shared memory, copied there from one
contiguous block per rank. These tests unpack the blocks on the CPU and
hold every slice against the decoder it came from, at ragged widths; and
they run the wrapper's CPU path with a planned decoder against the JAX
Pallas chain (interpret mode), as test_torch_kernels.py does with bare
parts: the plan's block reaches only the kernel.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

from guided_vae_nmf_tpu.mcem.pallas_engine import (
    _dec_parts as jax_dec_parts,
    mh_chain_pallas,
)
from guided_vae_nmf_tpu.models import dgm_init
from guided_vae_nmf_tpu.models.nets import decoder_apply
from guided_vae_nmf_torch.mcem import mh_chain
from guided_vae_nmf_torch.mcem.fused_engine import _dec_parts
from guided_vae_nmf_torch.mcem.mh_chain import (
    CLUSTER,
    bf16_weights,
    pack_weights,
    plan_chain,
)
from guided_vae_nmf_torch.models import module_from_params

TOL = dict(atol=2e-5, rtol=2e-4)


def _dec_w(rng, F, Hd, L, depth):
    t = lambda *s: torch.tensor(rng.randn(*s).astype(np.float32))  # noqa
    return {"w1": t(L, Hd), "mid": [(t(Hd, Hd), t(Hd))
                                     for _ in range(depth - 1)],
            "wo": t(Hd, F), "bo": t(F)}


def _unpack(block, F, Hd, L, depth):
    """A rank's block cut into (wo, bo, w1, [(w, b)]) at padded widths."""
    Fsp = (-(-F // CLUSTER) + 3) // 4 * 4
    Hsp = (-(-Hd // CLUSTER) + 3) // 4 * 4
    out, o = [], 0
    for shape in [(Hd, Fsp), (Fsp,), (L, Hsp)] + [(Hd, Hsp), (Hsp,)] * (
            depth - 1):
        n = int(np.prod(shape))
        out.append(block[o:o + n].reshape(shape))
        o += n
    assert o == block.numel()
    return out


@pytest.mark.parametrize("F,Hd,L,depth", [
    (513, 128, 32, 2), (65, 16, 8, 2), (100, 24, 7, 1), (257, 24, 5, 3),
    (768, 24, 32, 2), (130, 18, 3, 4), (129, 2, 4, 2)])
def test_pack_weights_layout(F, Hd, L, depth):
    """Every rank's block holds exactly its column slices, zero-padded to
    rows of a multiple of 4 floats; ragged and empty last slices included
    (H=2 leaves ranks 2 and 3 without units)."""
    d = _dec_w(np.random.RandomState(F + Hd), F, Hd, L, depth)
    packed = pack_weights(d)
    assert packed.shape[0] == CLUSTER and packed.is_contiguous()
    assert packed.shape[1] % 4 == 0
    Fsl, Hsl = -(-F // CLUSTER), -(-Hd // CLUSTER)
    for r in range(CLUSTER):
        c0, c1 = min(F, r * Fsl), min(F, (r + 1) * Fsl)
        j0, j1 = min(Hd, r * Hsl), min(Hd, (r + 1) * Hsl)
        wo, bo, w1, *mid = _unpack(packed[r], F, Hd, L, depth)
        assert torch.equal(wo[:, :c1 - c0], d["wo"][:, c0:c1])
        assert torch.equal(bo[:c1 - c0], d["bo"][c0:c1])
        assert torch.equal(w1[:, :j1 - j0], d["w1"][:, j0:j1])
        assert not wo[:, c1 - c0:].any() and not bo[c1 - c0:].any()
        assert not w1[:, j1 - j0:].any()
        for (w, b), pw, pb in zip(d["mid"], mid[::2], mid[1::2]):
            assert torch.equal(pw[:, :j1 - j0], w[:, j0:j1])
            assert torch.equal(pb[:j1 - j0], b[j0:j1])
            assert not pw[:, j1 - j0:].any() and not pb[j1 - j0:].any()


def test_pack_weights_keeps_the_decoder_and_rounding():
    """Packing leaves the decoder as it was; bfloat16-rounded weights are
    packed as they are, and a bfloat16-product plan packs its rounded
    weights; re-rounding a plan keeps only the parts, not its block."""
    d = _dec_w(np.random.RandomState(3), 65, 16, 8, 2)
    before = dict(d)
    pack_weights(d)
    assert d.keys() == before.keys() and all(d[k] is before[k] for k in d)
    r = pack_weights(bf16_weights(d))
    wo = _unpack(r[0], 65, 16, 8, 2)[0]
    assert torch.equal(wo[:, :17], d["wo"].to(torch.bfloat16).float()[:, :17])
    p = plan_chain(d, 65, 8, 3, 128, "cuda", torch.bfloat16)
    assert p["form"] == "cluster" and torch.equal(p["packed"], r)
    assert set(bf16_weights(p)) == {"w1", "mid", "wo", "bo"}


B, F, N, L, H, K, Y = 1, 65, 128, 8, 16, 3, 10


@pytest.mark.parametrize("mode", ["e", "wf"])
def test_packed_decoder_cpu_chain_matches_pallas(mode):
    """The wrapper's CPU path with a planned decoder is the plain version,
    and agrees with the JAX Pallas chain on the same inputs and noise."""
    rng = np.random.RandomState(5)
    dgm = dgm_init(jax.random.PRNGKey(5), [F, Y, L, [H, H]])
    dec = dgm["decoder"]
    l0 = dec["hidden"][0]
    y = (rng.uniform(size=(B, N, Y)) > 0.5).astype(np.float32)
    ypre = np.asarray(jnp.einsum("bny,yh->bnh", y, l0["w"][L:]) + l0["b"])
    Z = rng.randn(B, N, L).astype(np.float32)
    Vs = np.asarray(decoder_apply(
        dec, np.concatenate([Z, y], -1).reshape(B * N, -1))).reshape(B, N, F)
    X2 = rng.uniform(0.05, 1.05, (B, N, F)).astype(np.float32)
    Wt = rng.uniform(0.05, 0.5, (B, K, F)).astype(np.float32)
    Hf = rng.uniform(0.05, 0.5, (B, K, N)).astype(np.float32)
    g = rng.uniform(0.5, 1.5, (B, N)).astype(np.float32)
    mask = np.ones((B, N), np.float32)
    nsamples, burnin = 3, 2
    Zn = rng.randn(B, nsamples + burnin, N, L).astype(np.float32)
    U = rng.uniform(1e-6, 1.0, (B, nsamples + burnin, N)).astype(np.float32)
    j = mh_chain_pallas(
        jax_dec_parts(dec, L), jnp.asarray(X2), None, jnp.asarray(g),
        jnp.asarray(ypre), jnp.asarray(Z), jnp.asarray(Vs),
        jnp.zeros((B, 1), jnp.int32), mode=mode, nsamples=nsamples,
        burnin=burnin, var_RW=0.01, noise=(jnp.asarray(Zn), jnp.asarray(U)),
        WH=(jnp.asarray(Wt), jnp.asarray(Hf)),
        mask=jnp.asarray(mask) if mode == "e" else None)
    dec_w = plan_chain(_dec_parts(module_from_params(dgm).decoder, L), F,
                       L, K, N, "cpu")
    t = torch.tensor
    p = mh_chain(dec_w, t(X2), (t(Wt), t(Hf)), t(g), t(ypre), t(Z), t(Vs),
                 mode=mode, nsamples=nsamples, burnin=burnin, var_RW=0.01,
                 noise=(t(Zn), t(U)), mask=t(mask) if mode == "e" else None)
    for a, b in zip((p[0], p[1]) + p[2], (j[0], j[1]) + tuple(j[2])):
        assert_allclose(a.numpy(), np.asarray(b), **TOL)
