"""The chain's live flags and its plan on the CPU: `mh_chain.live_pairs`
against a pair-by-pair reading of the mask, the plan's skip flag, the
wrapper's check of the flags, and `mcem_batch_fused` planning the decoder
once and handing the same plan and flags to every chain call, with the
plain path's results the same as with every pair marked live (the CPU
path computes every frame) and the same on bare parts as on a plan. The
card's use of the flags is tested in `tests/test_torch_cuda.py`."""

import math
from unittest import mock

import numpy as np
import pytest
import torch

from guided_vae_nmf_torch.mcem import MCEMConfig, fused_engine, mh_chain
from guided_vae_nmf_torch.mcem.mh_chain import (
    PAIR, live_pairs, plan_chain)
from guided_vae_nmf_torch.models import dgm_init

torch.set_num_threads(2)


def _prefix(lengths, N):
    return (np.arange(N)[None] < np.array(lengths)[:, None]).astype(
        np.float32)


def _frames(N, spans):
    m = np.zeros((1, N), np.float32)
    for a, b in spans:
        m[0, a:b] = 1.0
    return m


MASKS = {
    **{f"prefix_{n}": (lambda n=n: _prefix([n], 128))
       for n in (0, 1, 31, 32, 33, 127, 128)},
    "row_masked_out": lambda: _prefix([128, 0], 128),
    "odd_tiles_32": lambda: _prefix([32], 48),
    "odd_tiles_33": lambda: _prefix([33], 48),
    "odd_tiles_48": lambda: _prefix([48], 48),
    "dead_between_live": lambda: _frames(128, [(0, 5), (64, 128)]),
    "dead_at_the_front": lambda: _frames(128, [(100, 101)]),
    "all_ones": lambda: np.ones((3, 96), np.float32),
    "soft_weights": lambda: np.where(_prefix([40], 64) > 0, 0.25, 0.0),
}


@pytest.mark.parametrize("case", sorted(MASKS))
def test_live_pairs(case):
    """live[b, p] = any(mask[b, 32 p : 32 p + 32] > 0), one flag a pair of
    16-frame tiles; with an odd tile count (N=48) pair 1 is tile 2 alone."""
    mask = MASKS[case]()
    B, N = mask.shape
    want = [[bool((mask[b, PAIR * p: PAIR * (p + 1)] > 0).any())
             for p in range(math.ceil(N / PAIR))] for b in range(B)]
    got = live_pairs(torch.tensor(mask))
    assert got.dtype == torch.bool and got.is_contiguous()
    assert got.tolist() == want
    if case == "all_ones":
        assert bool(got.all())
    if case.startswith("odd_tiles"):
        assert got.shape == (1, 2)
        assert got[0, 1].item() == (case != "odd_tiles_32")


# (device, F, L, hidden widths, K, N) -> whether the chain skips dead
# pairs: the cluster form on the card (NMF and Vb forms), not K1e (unequal
# or wide layers), K1g or the CPU; None where the card takes no form (N
# off the 16-frame tile)
SKIPS = {
    "cluster_nmf": (("cuda", 513, 32, (128, 128), 10, 384), True),
    "cluster_vb": (("cuda", 513, 32, (128, 128), 0, 512), True),
    "cpu": (("cpu", 513, 32, (128, 128), 10, 384), False),
    "ext_unequal": (("cuda", 513, 32, (256, 128), 10, 384), False),
    "general_wide": (("cuda", 513, 32, (2048,), 10, 384), False),
    "general_ragged_n": (("cuda", 513, 32, (128, 128), 10, 385), None),
}


def _decoder(F, L, ws):
    return {"w1": torch.zeros(L, ws[0]),
            "mid": tuple((torch.zeros(a, b), torch.zeros(b))
                         for a, b in zip(ws, ws[1:])),
            "wo": torch.zeros(ws[-1], F), "bo": torch.zeros(F)}


@pytest.mark.parametrize("case", sorted(SKIPS))
def test_skips_dead_pairs(case):
    """Only the cluster form skips dead pairs: the plan's flag follows its
    choice of form (a function of the shapes) and the device type, so CPU
    tensors planned for "cuda" show the card's; where no form takes the
    shapes the plan is refused."""
    (device, F, L, ws, K, N), want = SKIPS[case]
    dec_w = _decoder(F, L, ws)
    if want is None:
        with pytest.raises(ValueError, match="multiple of"):
            plan_chain(dec_w, F, L, K, N, device)
        return
    plan = plan_chain(dec_w, F, L, K, N, device)
    assert plan["skips"] is want
    assert (plan["form"] == "cluster") is want
    assert (plan["form"] == "plain") is (device == "cpu")


def _chain_args(B=2, N=64, F=9, L=3, H=5):
    g = torch.Generator().manual_seed(0)
    dec_w = {"w1": torch.randn(L, H, generator=g), "mid": (),
             "wo": torch.randn(H, F, generator=g) * 0.1,
             "bo": torch.zeros(F)}
    X2 = torch.rand(B, N, F, generator=g) + 0.1
    Z = torch.randn(B, N, L, generator=g)
    ypre = torch.zeros(B, N, H)
    Vs = torch.exp(torch.tanh(Z @ dec_w["w1"]) @ dec_w["wo"])
    return (dec_w, X2, None, torch.ones(B, N), ypre, Z, Vs), torch.rand(
        B, N, F, generator=g) + 0.1


@pytest.mark.parametrize("bad", ["dtype", "shape", "strided"])
def test_mh_chain_refuses_bad_live_flags(bad):
    args, Vb = _chain_args()
    live = torch.ones(2, 2, dtype=torch.bool)
    live = {"dtype": live.float(), "shape": live[:, :1],
            "strided": torch.ones(2, 4, dtype=torch.bool)[:, ::2]}[bad]
    with pytest.raises(ValueError, match="live"):
        mh_chain(*args, mode="wf", Vb=Vb, nsamples=2, burnin=1, live=live)


def test_mh_chain_cpu_path_computes_every_frame():
    """On the CPU the flags change nothing: the plain version runs every
    frame, dead pairs included."""
    args, Vb = _chain_args()
    live = torch.tensor([[True, False], [False, False]])
    kw = dict(mode="wf", Vb=Vb, nsamples=2, burnin=1, seed=4)
    got = mh_chain(*args, live=live, **kw)
    want = mh_chain(*args, **kw)
    for a, b in zip((got[0], got[1]) + got[2], (want[0], want[1]) + want[2]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("noise_model", ["nmf", "spp"])
def test_fused_engine_passes_live_flags_to_every_chain(noise_model):
    """`mcem_batch_fused` on the CPU derives the live flags once from the
    mask and passes them to every E chain and to the WF chain; its results
    equal bit for bit those of the same call with every pair marked live."""
    B, F, N, L, H, K = 2, 17, 80, 4, 8, 2
    model = dgm_init(torch.Generator().manual_seed(1), [F, 3, L, [H, H]])
    rng = np.random.RandomState(2)
    mask = torch.tensor(_prefix([80, 30], N))
    X = torch.where(mask[:, None, :] > 0, torch.tensor(rng.uniform(
        0.05, 1.05, (B, F, N)).astype(np.float32)), 1.0)
    y = torch.tensor((rng.uniform(size=(B, 3, N)) > 0.5).astype(np.float32))
    cfg = MCEMConfig(niter=2, nsamples_E_step=2, burnin_E_step=1,
                     nsamples_WF=2, burnin_WF=1, nmf_rank=K)
    kw = {}
    if noise_model == "spp":
        kw = dict(update_nmf=False, Vb_fixed=torch.tensor(rng.uniform(
            0.01, 0.3, (B, F, N)).astype(np.float32)))
    seen = []

    def run(flags):
        real = fused_engine.mh_chain

        def chain(*a, **k):
            seen.append((k.get("mode"), k.get("live")))
            if flags is not None:
                k["live"] = flags(k["live"])
            return real(*a, **k)

        with mock.patch.object(fused_engine, "mh_chain", chain):
            return fused_engine.mcem_batch_fused(
                model, X, mask, y, torch.Generator().manual_seed(3), cfg,
                **kw)

    got = run(None)
    want = run(torch.ones_like)
    live = live_pairs(mask)
    assert live.tolist() == [[True] * 3, [True, False, False]]
    assert [m for m, _ in seen] == (["e"] * cfg.niter + ["wf"]) * 2
    assert all(f is not None and torch.equal(f, live) for _, f in seen)
    assert sorted(got) == sorted(want)
    for k in got:
        assert torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("noise_model", ["nmf", "spp"])
def test_fused_engine_plans_once_for_every_chain(noise_model):
    """`mcem_batch_fused` plans the decoder once a call, for the chains'
    shapes, and hands that one plan to every E chain and to the WF
    chain."""
    B, F, N, L, H, K = 2, 17, 80, 4, 8, 2
    model = dgm_init(torch.Generator().manual_seed(1), [F, 3, L, [H, H]])
    rng = np.random.RandomState(2)
    X = torch.tensor(rng.uniform(0.05, 1.05, (B, F, N)).astype(np.float32))
    y = torch.tensor((rng.uniform(size=(B, 3, N)) > 0.5).astype(np.float32))
    cfg = MCEMConfig(niter=3, nsamples_E_step=2, burnin_E_step=1,
                     nsamples_WF=2, burnin_WF=1, nmf_rank=K)
    kw = {}
    if noise_model == "spp":
        kw = dict(update_nmf=False, Vb_fixed=torch.tensor(rng.uniform(
            0.01, 0.3, (B, F, N)).astype(np.float32)))
    plans, seen = [], []
    real_plan, real_chain = fused_engine.plan_chain, fused_engine.mh_chain

    def plan(*a, **k):
        plans.append((a[1:], k, real_plan(*a, **k)))
        return plans[-1][-1]

    def chain(dec_w, *a, **k):
        seen.append((k.get("mode"), dec_w))
        return real_chain(dec_w, *a, **k)

    with mock.patch.object(fused_engine, "plan_chain", plan), \
            mock.patch.object(fused_engine, "mh_chain", chain):
        fused_engine.mcem_batch_fused(
            model, X, torch.ones(B, N), y, torch.Generator().manual_seed(3),
            cfg, **kw)
    (args, k, planned), = plans
    assert args == (F, L, K if noise_model == "nmf" else 0, N,
                    torch.device("cpu"), torch.float32) and not k
    assert planned["form"] == "plain" and planned["packed"] is None
    assert [m for m, _ in seen] == ["e"] * cfg.niter + ["wf"]
    assert all(d is planned for _, d in seen)


@pytest.mark.parametrize("matmul_dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "mm16"])
@pytest.mark.parametrize("form", ["wh", "vb"])
def test_mh_chain_bare_parts_equal_planned_parts(form, matmul_dtype):
    """`mh_chain` on the decoder's bare parts plans them itself: its
    results equal bit for bit those on a plan made for the launch, in the
    WH and Vb forms, E and WF modes, with float32 and bfloat16 products."""
    args, Vb = _chain_args()
    dec_w, X2, _, g, ypre, Z, Vs = args
    B, N, F = X2.shape
    K = 3 if form == "wh" else 0
    gen = torch.Generator().manual_seed(5)
    WH = None
    if form == "wh":
        WH = (torch.rand(B, K, F, generator=gen) + 0.1,
              torch.rand(B, K, N, generator=gen) + 0.1)
        Vb = None
    plan = plan_chain(dec_w, F, Z.shape[-1], K, N, X2.device, matmul_dtype)
    for mode in ("e", "wf"):
        kw = dict(mode=mode, Vb=Vb, nsamples=2, burnin=1, seed=6,
                  mask=torch.ones(B, N), matmul_dtype=matmul_dtype)
        got = mh_chain(dec_w, X2, WH, g, ypre, Z, Vs, **kw)
        want = mh_chain(plan, X2, WH, g, ypre, Z, Vs, **kw)
        for a, b in zip((got[0], got[1]) + got[2],
                        (want[0], want[1]) + want[2]):
            assert torch.equal(a, b)


def test_mh_chain_refuses_a_plan_for_another_launch():
    """A plan is for one launch's shapes, device type and product type: the
    chain refuses one made for another rank, N or `matmul_dtype` (its
    weights would be rounded or not as that launch needs)."""
    args, Vb = _chain_args()
    dec_w, X2, _, g, ypre, Z, Vs = args
    B, N, F = X2.shape
    L = Z.shape[-1]
    kw = dict(mode="wf", Vb=Vb, nsamples=2, burnin=1)
    for bad in (plan_chain(dec_w, F, L, 3, N, "cpu"),
                plan_chain(dec_w, F, L, 0, 2 * N, "cpu"),
                plan_chain(dec_w, F, L, 0, N, "cuda"),
                plan_chain(dec_w, F, L, 0, N, "cpu", torch.bfloat16)):
        with pytest.raises(ValueError, match="planned for"):
            mh_chain(bad, *args[1:], **kw)
