"""K1g, the general form of the chain, on the CPU: its launch geometry as a
pure function of the shapes, the refusal edge, the dispatch of the
decoders no cluster holds, its packed weight block, and a wide decoder end
to end against JAX.

K1g (`csrc/mh_chain_general.cu`) runs one CTA a tile of 16, 8 or 4 frames:
the largest whose shared memory (the weight ring, two activation buffers
as tall as the widest even and the widest odd hidden layer, and the tile's
small state) fits the 232,448 B a CTA may take. The wrapper mirrors that
choice (`general_tile`, `general_sizes`) and checks the mirror against the
library at launch; these tests hold the mirror to the formula written out
here, at the decoders of the TPU kernel's domain that no cluster holds and
at the refusal edge. The packed block (`pack_general`: each layer's
weights with rows padded to a multiple of 4 floats) is unpacked in numpy
against the decoder it came from. End to end, a one-hidden-layer decoder
of 1200 units (the width the earlier K1g refused at F=513) runs through
JAX's `mh_chain_pallas` (the Pallas interpreter, as
tests/mcem/test_pallas.py runs it) and `mcem_batch_fused`, and through the
port's wrapper and fused engine on the CPU (the plain version), on the
same decisive streams (accept uniforms of 0 or inf, so no decision can
flip on rounding). Tolerance: atol 2e-5 / rtol 2e-4 (float32 sums in
another order), as tests/test_torch_kernel_domain.py states it. The kernel
itself is held against the plain version on the card
(tests/test_torch_cuda.py).
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
from guided_vae_nmf_tpu.models.nets import decoder_apply
from guided_vae_nmf_torch.mcem import MCEMConfig, mcem_batch_fused
from guided_vae_nmf_torch.mcem import fused_engine
from guided_vae_nmf_torch.mcem.fused_engine import _dec_parts
from guided_vae_nmf_torch.mcem.mh_chain import (
    SMEM_MAX,
    _check_general,
    chain_form,
    general_packed,
    general_plan,
    general_sizes,
    general_tile,
    mh_chain,
    mh_chain_ref,
    pack_general,
    plan_chain,
    widths,
)
from guided_vae_nmf_torch.models import module_from_params

torch.set_num_threads(2)

TOL = dict(atol=2e-5, rtol=2e-4)
# the decoders of the TPU kernel's domain that no cluster holds at F=513,
# L=32, K=10, with the frame tile and the floats of a ring stage K1g takes
DOMAIN = {(1200,): (16, 8192), (2048,): (16, 4096), (4096,): (8, 4096),
          (128, 2048): (16, 4096), (2048, 128): (16, 4096),
          (2048, 2048): (8, 4096), (512,) * 4: (16, 8192),
          (512, 512): (16, 8192), (6000,): (4, 8192),
          (4096, 4096): (4, 4096), (4096, 1024): (4, 8192)}


def _r4(n):
    return -(-n // 4) * 4


def _r8(n):
    return -(-n // 8) * 8


def _bytes(F, L, ws, K, T, S=4096):
    """The formula of `general_plan`'s docstring."""
    rows = _r4(max(ws[0::2])) + _r4(max(ws[1::2], default=0))
    return 4 * (4 * S + T * (rows + 3 * _r4(L) + _r4(K) + _r4(-(-F // 4))
                             + 7) + 16)


def _wid(ws):
    return "x".join(map(str, ws))


@pytest.mark.parametrize("ws", list(DOMAIN), ids=_wid)
def test_general_tile_follows_the_formula(ws):
    """The frame tile is the largest of 16, 8, 4 whose CTA fits, with ring
    stages of 8192 floats where they fit beside it, else 4096; its shared
    memory the formula's, its threads a consumer warp per 32 output items
    (258 at 16 frames, 129 at 8 and 4, in warps) and a producer warp; the
    dispatch sends the decoder to K1g, which takes it."""
    F, L, K = 513, 32, 10
    T, S = general_plan(F, L, ws, K)
    assert (T, S) == DOMAIN[ws] and general_tile(F, L, ws, K) == T
    fits = [(t, s) for t in (16, 8, 4) for s in (8192, 4096)
            if _bytes(F, L, ws, K, t, s) <= SMEM_MAX]
    assert (T, S) == fits[0]
    assert general_sizes(F, L, ws, K, T, S) == (
        (288 if T == 16 else 160) + 32, _bytes(F, L, ws, K, T, S))
    assert chain_form(F, L, ws, K, 384) == ("general", None)
    assert chain_form(F, L, ws, 0, 384) == ("general", None)
    _check_general(384, F, L, ws, K)


EDGES = [(513, 32, 10), (513, 32, 0), (65, 8, 2), (1025, 64, 32)]


@pytest.mark.parametrize("F,L,K", EDGES, ids=[f"F{e[0]}-L{e[1]}-K{e[2]}"
                                                for e in EDGES])
def test_general_refusal_edge(F, L, K):
    """The widest decoders K1g takes, one hidden layer of R units or two
    alternating layers of R units together (R a multiple of 4), at 4-frame
    tiles, R from the formula; 4 units more are refused with the bytes
    they need. At F=513, L=32, K=10, R = 10,180: past the widths of 4,096
    the domain asks for."""
    R = max(r for r in range(4, 20000, 4)
            if _bytes(F, L, (r,), K, 4) <= SMEM_MAX)
    if (F, L, K) == (513, 32, 10):
        assert R == 10180
    a = R // 8 * 4
    for ws in ((R,), (a, R - a), (8, R - 8, 8, 8)):
        assert general_tile(F, L, ws, K) == 4
        _check_general(64, F, L, ws, K)
    for ws in ((R + 4,), (a, R - a + 4), (R - 2, 3)):
        assert general_tile(F, L, ws, K) is None
        need = _bytes(F, L, ws, K, 4)
        assert need > SMEM_MAX
        with pytest.raises(ValueError, match=f"need {need} B of shared "
                                             "memory"):
            _check_general(64, F, L, ws, K)


@pytest.mark.parametrize("N,ws,match", [
    (40, (512, 512), "multiple of 16"), (64, (16,) * 5, "1 to 4"),
    (64, (10184,), "shared memory")], ids=["N40", "depth5", "smem"])
def test_check_general_refuses(N, ws, match):
    with pytest.raises(ValueError, match=match):
        _check_general(N, 513, 32, ws, 10)


def _dec_w(rng, F, L, ws):
    mats = [rng.randn(a, b).astype(np.float32)
            for a, b in zip((L, *ws), (*ws, F))]
    return {"w1": torch.tensor(mats[0]),
            "mid": tuple((torch.tensor(m), torch.tensor(
                rng.randn(m.shape[1]).astype(np.float32)))
                for m in mats[1:-1]),
            "wo": torch.tensor(mats[-1]),
            "bo": torch.tensor(rng.randn(F).astype(np.float32))}


PACK_CASES = [(513, 32, (512, 512)), (65, 8, (24, 40)), (130, 5, (18, 7, 30)),
              (513, 32, (1201,)), (67, 3, (5, 6, 7, 9))]


@pytest.mark.parametrize("F,L,ws", PACK_CASES,
                         ids=[f"F{c[0]}-{_wid(c[2])}" for c in PACK_CASES])
def test_pack_general_layout(F, L, ws):
    """The block holds w1, each later layer's weights and wo, layer after
    layer, each [inputs][outputs rounded up to 8] with zero padding; its
    length is what the kernel carves; every layer starts on 16 bytes; the
    decoder stays as it was; the plan carries it where the card launches
    K1g."""
    d = _dec_w(np.random.RandomState(F), F, L, ws)
    before = dict(d)
    block = pack_general(d)
    assert d.keys() == before.keys() and all(d[k] is before[k] for k in d)
    assert block.shape == (general_packed(F, L, ws),) and block.is_contiguous()
    flat = block.numpy()
    off = 0
    for w in [d["w1"], *(w for w, _ in d["mid"]), d["wo"]]:
        kin, n = w.shape
        assert off % 4 == 0
        rows = flat[off:off + kin * _r8(n)].reshape(kin, _r8(n))
        assert np.array_equal(rows[:, :n], w.numpy())
        assert not rows[:, n:].any()
        off += kin * _r8(n)
    assert off == flat.size
    if chain_form(F, L, ws, 10, 128)[0] == "general":
        plan = plan_chain(d, F, L, 10, 128, "cuda")
        assert plan["form"] == "general"
        assert torch.equal(plan["packed"], block)


# the wide decoder end to end: dgm_init h_dim (1200,) at a small F
B, F, N, L, Y = 2, 65, 128, 8, 10
H_DIM = [1200]
SMALL = dict(niter=2, nsamples_E_step=2, burnin_E_step=1, nsamples_WF=2,
             burnin_WF=1, nmf_rank=3, var_RW=0.01)


def _decisive(rng, n_steps):
    u = np.where(rng.uniform(size=(B, n_steps, N)) < 0.5, 0.0, np.inf)
    return (rng.randn(B, n_steps, N, L).astype(np.float32),
            u.astype(np.float32))


def _t(a):
    return torch.tensor(np.asarray(a))


@pytest.mark.parametrize("vb", [False, True], ids=["wh", "vb"])
@pytest.mark.parametrize("mode", ["e", "wf"])
def test_wide_decoder_chain_matches_pallas(mode, vb):
    """The chain on the (1200,) decoder: JAX's mh_chain_pallas against the
    port's wrapper on CPU tensors (the plain version K1g is held to on the
    card), E and WF, both noise forms; some proposals accepted and some
    rejected."""
    K = 3
    dgm = dgm_init(jax.random.PRNGKey(21), [F, Y, L, H_DIM])
    dec = dgm["decoder"]
    rng = np.random.RandomState(22)
    y = (rng.uniform(size=(B, N, Y)) > 0.5).astype(np.float32)
    l0 = dec["hidden"][0]
    ypre = np.asarray(jnp.einsum("bny,yh->bnh", y, l0["w"][L:]) + l0["b"])
    Z = rng.randn(B, N, L).astype(np.float32)
    Vs = np.asarray(decoder_apply(dec, np.concatenate([Z, y], -1).reshape(
        B * N, -1))).reshape(B, N, F)
    X2 = rng.uniform(0.05, 1.05, (B, N, F)).astype(np.float32)
    Wt = rng.uniform(0.05, 0.5, (B, K, F)).astype(np.float32)
    Hf = rng.uniform(0.05, 0.5, (B, K, N)).astype(np.float32)
    g = rng.uniform(0.5, 1.5, (B, N)).astype(np.float32)
    Vb = rng.uniform(0.01, 0.3, (B, N, F)).astype(np.float32)
    mask = (np.arange(N)[None] < np.array([[N], [N - 37]])).astype(
        np.float32)
    nsamples, burnin = 3, 2
    noise = _decisive(rng, nsamples + burnin)
    use_mask = mode == "e" and not vb
    Zj, Vsj, extra_j = jax_pe.mh_chain_pallas(
        jax_pe._dec_parts(dec, L), jnp.asarray(X2),
        jnp.asarray(Vb) if vb else None, jnp.asarray(g), jnp.asarray(ypre),
        jnp.asarray(Z), jnp.asarray(Vs), jnp.zeros((B, 1), jnp.int32),
        mode=mode, nsamples=nsamples, burnin=burnin, var_RW=0.01,
        noise=tuple(jnp.asarray(a) for a in noise),
        WH=None if vb else (jnp.asarray(Wt), jnp.asarray(Hf)),
        mask=jnp.asarray(mask) if use_mask else None)
    dec_w = _dec_parts(module_from_params(dgm).decoder, L)
    ws = widths(dec_w)
    assert ws == (1200,)
    assert chain_form(513, 32, ws, 0 if vb else 10, 384)[0] == "general"
    assert general_tile(513, 32, ws, 10) == 16
    plan = plan_chain(dec_w, F, L, 0 if vb else K, N, "cpu",
                      form="general")
    got = mh_chain(plan, _t(X2), None if vb else (_t(Wt), _t(Hf)), _t(g),
                   _t(ypre), _t(Z), _t(Vs), mode=mode, nsamples=nsamples,
                   burnin=burnin, var_RW=0.01, noise=tuple(map(_t, noise)),
                   mask=_t(mask) if use_mask else None,
                   Vb=_t(Vb) if vb else None)
    for a, b in zip((got[0], got[1]) + got[2], (Zj, Vsj) + tuple(extra_j)):
        assert tuple(a.shape) == tuple(np.shape(b))
        assert_allclose(a.numpy(), np.asarray(b), **TOL)
    ref = mh_chain_ref(dec_w, _t(X2), None if vb else (_t(Wt), _t(Hf)),
                       _t(g), _t(ypre), _t(Z), _t(Vs), mode=mode,
                       nsamples=nsamples, burnin=burnin, var_RW=0.01,
                       noise=tuple(map(_t, noise)),
                       mask=_t(mask) if use_mask else None,
                       Vb=_t(Vb) if vb else None)
    assert all(torch.equal(a, b) for a, b in zip(
        (got[0], got[1]) + got[2], (ref[0], ref[1]) + ref[2]))
    moved = np.any(got[0].numpy() != Z, axis=-1)
    assert 0 < moved.mean() < 1


@pytest.mark.parametrize("nmf", [True, False], ids=["nmf", "vb"])
def test_wide_decoder_fused_engine_matches_jax(nmf, monkeypatch):
    """`mcem_batch_fused` on the (1200,) M2 against JAX's, with the NMF
    noise model and with a fixed noise variance: every chain of both on
    the same recorded decisive streams at var_RW = 0.01, two EM iterations
    from the same warm start; every output within TOL."""
    tree = dgm_init(jax.random.PRNGKey(23), [F, Y, L, H_DIM])
    rng = np.random.RandomState(24)
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
    streams = {m: _decisive(rng, SMALL[f"nsamples_{s}"] + SMALL[f"burnin_{s}"])
               for m, s in (("e", "E_step"), ("wf", "WF"))}

    jax_chain = jax_pe.mh_chain_pallas

    def jax_injected(*a, mode="e", **kw):
        zn, u = streams[mode]
        return jax_chain(*a, mode=mode, noise=(jnp.asarray(zn),
                                               jnp.asarray(u)), **kw)

    monkeypatch.setattr(jax_pe, "mh_chain_pallas", jax_injected)
    # unjitted, so the patched chain is traced whatever ran before
    ref = jax_pe.mcem_batch_fused.__wrapped__(
        tree, jnp.asarray(X), jnp.asarray(mask), jnp.asarray(y),
        jax.random.split(jax.random.PRNGKey(25), B), JaxConfig(**SMALL),
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
    model = module_from_params(tree)
    got = mcem_batch_fused(model, _t(X), _t(mask), _t(y),
                           torch.Generator().manual_seed(0),
                           MCEMConfig(**SMALL),
                           Vb_fixed=None if nmf else _t(Vb),
                           init={k: _t(v) for k, v in init.items()}, **fixed)
    assert seen == [(1200,)] * (SMALL["niter"] + 1)
    keys = ["WFs", "WFn", "g", "Z", "cost"] + (["W", "H"] if nmf else [])
    for k in keys:
        assert tuple(got[k].shape) == tuple(ref[k].shape), k
        assert_allclose(got[k].numpy(), np.asarray(ref[k]), err_msg=k, **TOL)
    assert not np.allclose(got["Z"].numpy(), init["Z"])


@pytest.mark.parametrize("copy", ["stamped", "slot4k", "stages3", "cols8"])
def test_probe_copies_apply_to_the_kernel(copy):
    """`scripts/probe_k1g.py` builds its stamped copy and its design
    variants by replacing text of `csrc/mh_chain_general.cu`: each
    replacement still finds its one place in the source, and each copy
    differs from it."""
    from guided_vae_nmf_torch import _build
    from guided_vae_nmf_torch.scripts import probe_k1g

    src = (_build.CSRC / "mh_chain_general.cu").read_text()
    out = (probe_k1g.stamped(src) if copy == "stamped"
           else probe_k1g._sub(src, probe_k1g.VARIANTS[copy][0]))
    assert out != src
