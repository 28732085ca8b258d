"""K1e, the extended cluster form of the chain, on the CPU: its per-layer
weight blocks, the wrapper's choice of form, and the fused engine with
decoders of unequal widths against JAX's.

K1e (`csrc/mh_chain_ext.cu`) runs the cluster form's design on clusters
of 4 or 8 CTAs with each hidden layer sliced on its own; rank r holds
output bins [r Fsl, (r+1) Fsl) and of each hidden layer d the units
[r Hsl_d, (r+1) Hsl_d) in shared memory, copied there from one block per
rank (`pack_weights(dec_w, cluster)`). These tests unpack the blocks in
numpy and hold every slice against the decoder it came from; hold the
dispatch rule (`chain_form`, a function of the shapes and the shared
memory a CTA may take) to each of its three outcomes, and the plan
(`plan_chain`) to the form and block it picks; and run
`mcem_batch_fused` with decoders of unequal widths against JAX's
`mcem_batch_fused` (its Pallas chain in interpret mode), both fed the same
decisive streams (accept uniforms of 0 or inf, so no decision can flip on
rounding) in every chain. The wrapper's CPU path is the plain version, so
the kernel itself is held against it on the card (tests/test_torch_cuda.py).
Tolerance: atol 2e-5 / rtol 2e-4, as tests/test_torch_kernel_domain.py
states it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

import guided_vae_nmf_tpu.mcem.pallas_engine as jax_pe
from guided_vae_nmf_tpu.mcem import MCEMConfig as JaxConfig
from guided_vae_nmf_tpu.models import dgm_init
from guided_vae_nmf_torch.mcem import MCEMConfig, mcem_batch_fused
from guided_vae_nmf_torch.mcem import fused_engine
from guided_vae_nmf_torch.mcem.mh_chain import (
    CLUSTER,
    EXT_CLUSTERS,
    SMEM_MAX,
    chain_form,
    cluster_smem,
    ext_cluster,
    ext_sizes,
    mh_chain,
    mh_chain_ref,
    pack_general,
    pack_weights,
    plan_chain,
    widths,
)
from guided_vae_nmf_torch.models import module_from_params

torch.set_num_threads(2)

TOL = dict(atol=2e-5, rtol=2e-4)
# the decoders of dgm_init h_dim (256, 128), (128,) * 4 and (256, 256)
DOMAIN = [(128, 256), (128,) * 4, (256, 256)]


def _dec_w(rng, F, L, ws):
    t = lambda *s: torch.tensor(rng.randn(*s).astype(np.float32))  # noqa
    return {"w1": t(L, ws[0]),
            "mid": [(t(a, b), t(b)) for a, b in zip(ws, ws[1:])],
            "wo": t(ws[-1], F), "bo": t(F)}


def _unpack(block, F, L, ws, cl):
    """A rank's block cut into (wo, bo, w1, [w, b] per later layer) at the
    padded widths, in numpy."""
    pad = lambda n: (-(-n // cl) + 3) // 4 * 4  # noqa: E731
    shapes = [(ws[-1], pad(F)), (pad(F),), (L, pad(ws[0]))]
    for a, b in zip(ws, ws[1:]):
        shapes += [(a, pad(b)), (pad(b),)]
    out, o = [], 0
    for shape in shapes:
        n = int(np.prod(shape))
        out.append(block[o:o + n].reshape(shape))
        o += n
    assert o == block.size
    return out


def _held(got, want, lo, hi):
    """The slice [lo, hi) of `want`'s last axis, then zeros."""
    n = hi - lo
    assert np.array_equal(got[..., :n], want[..., lo:hi])
    assert not got[..., n:].any()


PACK_CASES = [(513, 32, ws, cl) for ws in DOMAIN for cl in EXT_CLUSTERS] + [
    (65, 8, (24, 40), 4), (65, 8, (24, 40), 8), (130, 5, (18, 7, 30), 8)]


@pytest.mark.parametrize("F,L,ws,cl", PACK_CASES,
                         ids=[f"F{c[0]}-{'x'.join(map(str, c[2]))}-cl{c[3]}"
                              for c in PACK_CASES])
def test_pack_weights_per_layer(F, L, ws, cl):
    """Every rank's block holds exactly its slices of wo, bo, w1 and each
    later layer's weights and bias, each layer at its own slice width,
    zero-padded to rows of a multiple of 4 floats (ragged and empty last
    slices included); the block's length is what the kernel carves."""
    d = _dec_w(np.random.RandomState(F + cl), F, L, ws)
    packed = pack_weights(d, cl)
    assert packed.shape == (cl, ext_sizes(F, L, ws, 0, cl)[1])
    assert packed.is_contiguous() and packed.shape[1] % 4 == 0
    blocks = packed.numpy()
    fsl = -(-F // cl)
    for r in range(cl):
        wo, bo, w1, *mid = _unpack(blocks[r], F, L, ws, cl)
        c0, c1 = min(F, r * fsl), min(F, (r + 1) * fsl)
        _held(wo, d["wo"].numpy(), c0, c1)
        _held(bo, d["bo"].numpy(), c0, c1)
        hsl = -(-ws[0] // cl)
        _held(w1, d["w1"].numpy(), min(ws[0], r * hsl),
              min(ws[0], (r + 1) * hsl))
        for i, (w, b) in enumerate(d["mid"]):
            h = ws[i + 1]
            hsl = -(-h // cl)
            j0, j1 = min(h, r * hsl), min(h, (r + 1) * hsl)
            _held(mid[2 * i], w.numpy(), j0, j1)
            _held(mid[2 * i + 1], b.numpy(), j0, j1)


@pytest.mark.parametrize("F,L,H,depth", [(513, 32, 128, 2), (100, 7, 24, 3)])
def test_pack_weights_one_width_is_the_cluster_forms(F, L, H, depth):
    """At one hidden width and 4 CTAs the per-layer blocks are the cluster
    form's blocks, float for float: the plans of the two forms carry the
    same block."""
    d = _dec_w(np.random.RandomState(H), F, L, (H,) * depth)
    cluster = plan_chain(d, F, L, 0, 128, "cuda")
    ext = plan_chain(d, F, L, 0, 128, "cuda", form="ext")
    assert (cluster["form"], ext["form"]) == ("cluster", "ext")
    assert cluster["cluster"] == ext["cluster"] == CLUSTER
    assert torch.equal(cluster["packed"], ext["packed"])


# (F, L, widths, K, N, shared memory a CTA may take) -> the form
FORM_CASES = [
    ("shipped", 513, 32, (128, 128), 10, 384, SMEM_MAX, ("cluster", 4)),
    ("128x256", 513, 32, (128, 256), 10, 384, SMEM_MAX, ("ext", 8)),
    ("128x4", 513, 32, (128,) * 4, 10, 384, SMEM_MAX, ("ext", 4)),
    ("128x4-180KB", 513, 32, (128,) * 4, 10, 384, 180_000, ("ext", 8)),
    ("256x256", 513, 32, (256, 256), 10, 384, SMEM_MAX, ("ext", 8)),
    ("256x256-vb", 513, 32, (256, 256), 0, 384, SMEM_MAX, ("ext", 8)),
    ("24x40", 65, 8, (24, 40), 3, 128, SMEM_MAX, ("ext", 4)),
    ("F1000", 1000, 32, (128, 128), 10, 384, SMEM_MAX, ("ext", 8)),
    ("256x256-rank32", 513, 32, (256, 256), 32, 384, SMEM_MAX, ("ext", 8)),
    ("256x3", 513, 32, (256,) * 3, 10, 384, SMEM_MAX, ("general", None)),
    ("512x512", 513, 32, (512, 512), 10, 384, SMEM_MAX, ("general", None)),
    ("depth5-equal", 65, 8, (16,) * 5, 3, 128, SMEM_MAX, ("cluster", 4)),
    ("depth5", 65, 8, (16, 24) * 2 + (16,), 3, 128, SMEM_MAX,
     ("general", None)),
    ("N40", 513, 32, (128, 256), 10, 40, SMEM_MAX, ("general", None)),
    ("shipped-200KB", 513, 32, (128, 128), 10, 384, 200_000, ("ext", 4)),
    ("shipped-170KB", 513, 32, (128, 128), 10, 384, 170_000, ("ext", 8)),
    ("shipped-100KB", 513, 32, (128, 128), 10, 384, 100_000,
     ("general", None)),
]


@pytest.mark.parametrize("case", FORM_CASES, ids=[c[0] for c in FORM_CASES])
def test_chain_form(case):
    """The dispatch rule, a function of the shapes and the shared memory a
    CTA may take: the cluster form where it takes the decoder (one width,
    F <= 768, its CTA fits), else the extended form at the smallest
    cluster of 4 and 8 that fits, else the general form (K1g)."""
    _, F, L, ws, K, N, smem_max, want = case
    assert chain_form(F, L, ws, K, N, smem_max=smem_max) == want
    if want[0] == "ext":
        cl = want[1]
        nt, _, smem = ext_sizes(F, L, ws, K, cl)
        assert nt <= 320 and smem <= smem_max
        smaller = [c for c in EXT_CLUSTERS if c < cl]
        assert all(ext_sizes(F, L, ws, K, c)[2] > smem_max
                   or ext_sizes(F, L, ws, K, c)[0] > 320 for c in smaller)


def test_shared_memory_of_the_shipped_and_domain_decoders():
    """The cluster form's CTA at the shipped decoder takes the 212,512 B
    its card run reports; K1e, with X2 and Vb in registers, holds the 128 x
    4 decoder of F=513 on 4-CTA clusters and (128, 256) and (256, 256) on
    8-CTA clusters within the card's 232,448 B, and (512, 512) in none of
    4, 8 or 16."""
    assert cluster_smem(513, 32, 128, 10, 2) == 212_512
    assert [ext_sizes(513, 32, ws, 10, 8)[2] for ws in DOMAIN] == [
        180_000, 137_056, 216_864]
    assert [ext_sizes(513, 32, ws, 10, 4)[2] for ws in DOMAIN] == [
        279_200, 211_744, 336_544]
    assert all(ext_sizes(513, 32, (512, 512), 10, c)[2] > SMEM_MAX
               for c in (4, 8, 16))
    assert ext_cluster(513, 32, (512, 512), 10) is None


@pytest.mark.parametrize("ws,K,form,rows", [
    ((128, 128), 10, "cluster", 4), ((24, 40), 3, "ext", 4),
    ((128, 256), 10, "ext", 8), ((128,) * 4, 10, "ext", 4),
    ((512, 512), 10, "general", 32 * 512 + 512 * 512 + 512 * 520)])
def test_pack_for_chain_packs_the_form_that_runs(ws, K, form, rows):
    """The plan (what mcem_batch_fused makes once a call) holds the one
    block of the form the card launches at these shapes under "packed":
    the cluster forms' per-rank blocks, or the general form's one block of
    padded rows; the decoder's parts stay as they were."""
    F, L = (65, 8) if ws == (24, 40) else (513, 32)
    d = _dec_w(np.random.RandomState(7), F, L, ws)
    p = plan_chain(d, F, L, K, 128, "cuda")
    assert (p["form"], p["cluster"]) == chain_form(F, L, ws, K, 128)
    assert p["form"] == form and p["packed"].shape[0] == rows
    assert all(p[k] is d[k] for k in d)
    want = (pack_weights(d, p["cluster"]) if p["cluster"]
            else pack_general(d))
    assert torch.equal(p["packed"], want)


def test_wrapper_forms_on_the_cpu():
    """On CPU tensors every form's plan is the plain version; an unknown
    form is refused; the launch counters have K1e's keys."""
    rng = np.random.RandomState(9)
    B, F, N, L, K = 1, 65, 32, 8, 3
    d = _dec_w(rng, F, L, (24, 40))
    t = lambda *s: torch.tensor(rng.uniform(0.1, 1.0, s).astype(  # noqa
        np.float32))
    X2, Wt, H, g = t(B, N, F), t(B, K, F), t(B, K, N), t(B, N)
    ypre, Z = t(B, N, 24), t(B, N, L)
    Vs = torch.exp(torch.tanh(torch.tanh(Z @ d["w1"] + ypre)
                              @ d["mid"][0][0] + d["mid"][0][1])
                   @ d["wo"] + d["bo"])
    mask = torch.ones(B, N)
    noise = (torch.tensor(rng.randn(B, 5, N, L).astype(np.float32)),
             torch.tensor(np.where(rng.uniform(size=(B, 5, N)) < 0.5, 0.0,
                                   np.inf).astype(np.float32)))
    args = (d, X2, (Wt, H), g, ypre, Z, Vs)
    kw = dict(nsamples=3, burnin=2, noise=noise, mask=mask)
    ref = mh_chain_ref(*args, **kw)
    for form in ("auto", "cluster", "ext", "general"):
        plan = plan_chain(d, F, L, K, N, X2.device, form=form)
        assert plan["form"] == "plain" and not plan["skips"]
        got = mh_chain(plan, *args[1:], **kw)
        assert all(torch.equal(a, b) for a, b in zip(
            (got[0], got[1]) + got[2], (ref[0], ref[1]) + ref[2]))
    with pytest.raises(ValueError, match="form"):
        plan_chain(d, F, L, K, N, X2.device, form="wide")
    assert {"e_wh_ext", "wf_vb_ext", "e_vb_ext_fast",
            "wf_wh_ext_trans_mm16"} <= set(mh_chain.launches)


# the fused engine with decoders of unequal widths (dgm_init h_dim; the
# decoder mirrors it), under the same decisive streams in both packages
B, F, N, L, Y = 2, 65, 128, 8, 10
SMALL = dict(niter=2, nsamples_E_step=2, burnin_E_step=1, nsamples_WF=2,
             burnin_WF=1, nmf_rank=3, var_RW=0.01)
ENGINE_CASES = [([40, 24], True), ([40, 24], False), ([40, 24, 16], True)]


def _streams(seed):
    """Decisive (Zn, U) for the E chains and the WF chain."""
    rng = np.random.RandomState(seed)
    out = {}
    for mode, n in (("e", SMALL["nsamples_E_step"] + SMALL["burnin_E_step"]),
                    ("wf", SMALL["nsamples_WF"] + SMALL["burnin_WF"])):
        u = np.where(rng.uniform(size=(B, n, N)) < 0.5, 0.0, np.inf)
        out[mode] = (rng.randn(B, n, N, L).astype(np.float32),
                     u.astype(np.float32))
    return out


@pytest.mark.parametrize("h_dim,nmf", ENGINE_CASES,
                         ids=[f"{'x'.join(map(str, h))}-{'nmf' if n else 'vb'}"
                              for h, n in ENGINE_CASES])
def test_fused_engine_matches_jax_under_injected_streams(h_dim, nmf,
                                                         monkeypatch):
    """`mcem_batch_fused` on a decoder of unequal widths (the shapes K1e
    takes on the card) against JAX's with the NMF noise model and with a
    fixed noise variance: every chain of both runs on the same recorded
    decisive streams at var_RW = 0.01, two EM iterations from the same warm
    start; every output within TOL."""
    tree = dgm_init(jax.random.PRNGKey(11), [F, Y, L, h_dim])
    rng = np.random.RandomState(12)
    X = rng.uniform(0.05, 1.05, (B, F, N)).astype(np.float32)
    mask = (np.arange(N)[None] < np.array([[N], [N - 40]])).astype(
        np.float32)
    X = np.where(mask[:, None, :] > 0, X, 1.0).astype(np.float32)
    y = (rng.uniform(size=(B, Y, N)) > 0.5).astype(np.float32)
    K = SMALL["nmf_rank"]
    init = {"g": rng.uniform(0.5, 1.5, (B, N)).astype(np.float32),
            "Z": rng.randn(B, L, N).astype(np.float32)}
    if nmf:
        init["W"] = rng.uniform(0.05, 1, (B, F, K)).astype(np.float32)
        init["H"] = rng.uniform(0.05, 1, (B, K, N)).astype(np.float32)
    else:
        init["W"] = np.ones((B, F, 1), np.float32)
        init["H"] = np.zeros((B, 1, N), np.float32)
    Vb = rng.uniform(0.01, 0.3, (B, F, N)).astype(np.float32)
    fixed = {} if nmf else dict(update_nmf=False)
    streams = _streams(13)

    jax_chain = jax_pe.mh_chain_pallas

    def jax_injected(*a, mode="e", **kw):
        zn, u = streams[mode]
        return jax_chain(*a, mode=mode, noise=(jnp.asarray(zn),
                                               jnp.asarray(u)), **kw)

    monkeypatch.setattr(jax_pe, "mh_chain_pallas", jax_injected)
    # unjitted, so the patched chain is traced whatever ran before
    ref = jax_pe.mcem_batch_fused.__wrapped__(
        tree, jnp.asarray(X), jnp.asarray(mask), jnp.asarray(y),
        jax.random.split(jax.random.PRNGKey(14), B), JaxConfig(**SMALL),
        Vb_fixed=None if nmf else jnp.asarray(Vb),
        init={k: jnp.asarray(v) for k, v in init.items()}, **fixed)

    port_chain = fused_engine.mh_chain
    seen = []

    def port_injected(dec_w, *a, mode="e", **kw):
        seen.append(widths(dec_w))
        zn, u = streams[mode]
        return port_chain(dec_w, *a, mode=mode, noise=(torch.tensor(zn),
                                                       torch.tensor(u)),
                          **kw)

    monkeypatch.setattr(fused_engine, "mh_chain", port_injected)
    t = lambda a: torch.tensor(np.asarray(a))  # noqa: E731
    model = module_from_params(tree)
    got = mcem_batch_fused(model, t(X), t(mask), t(y),
                           torch.Generator().manual_seed(0),
                           MCEMConfig(**SMALL),
                           Vb_fixed=None if nmf else t(Vb),
                           init={k: t(v) for k, v in init.items()}, **fixed)
    ws = tuple(reversed(h_dim))
    assert seen == [ws] * (SMALL["niter"] + 1)
    assert chain_form(F, L, ws, K if nmf else 0, N)[0] == "ext"
    keys = ["WFs", "WFn", "g", "Z", "cost"] + (["W", "H"] if nmf else [])
    for k in keys:
        assert tuple(got[k].shape) == tuple(ref[k].shape), k
        assert_allclose(got[k].numpy(), np.asarray(ref[k]), err_msg=k, **TOL)
    # some proposals accepted: the streams moved the chains
    assert not np.allclose(got["Z"].numpy(), init["Z"])


@pytest.mark.parametrize("copy", ["stamped", "no_tail", "nt64", "cl16"])
def test_probe_copies_apply_to_the_kernel(copy):
    """`scripts/probe_k1e.py` builds its stamped copy and its design
    variants by replacing text of `csrc/mh_chain_ext.cu`: each replacement
    still finds its one place in the source, and each copy differs from
    it."""
    from guided_vae_nmf_torch import _build
    from guided_vae_nmf_torch.scripts import probe_k1e

    src = (_build.CSRC / "mh_chain_ext.cu").read_text()
    out = (probe_k1e.stamped(src) if copy == "stamped"
           else probe_k1e._sub(src, probe_k1e.VARIANTS[copy]))
    assert out != src
