"""The CUDA kernels against their plain PyTorch versions, on the card, in
both forms: with the NMF factors (WH=, K1a / K2a) and with a given noise
variance (Vb=, K1b / K2b), in exact math and with the fast-mode options
(K1c / K2c: bfloat16 sample dumps, approximate reciprocal, bit-arithmetic
exp / log), and the chain with bfloat16 decoder products (K1d, at its own
tolerance, K1D_TOL below); the fused engine, PEEM and the PEEM -> MCEM
hybrid on the card against the CPU run; and the parts that launch no
kernel of their own, on the card against the CPU: the oracle labels, the
eager MCEM engine under injected streams and the Wiener-DNN forward; and
streaming on the card: a stream's output against how its pushes are
split, a stream against the CPU, pool lanes against dedicated streams,
and the HTTP stream route; and the evaluation protocol: the batched
SI-SDR on the card against numpy, the `gvnmf-torch enhance` command on
the card against `enhance_to_audio` with its launch counts, and the
metric pool started from a process that holds a CUDA context; and
training: one step of each family on the card against the CPU (z = mu),
`fit` on the card leaving `load_model`'s modules frozen, and a card's
`resume_state.npz` resumed on the CPU; and the multi-device layer on a
virtual mesh of two shards on the card (`make_mesh(devices=[cuda] * 2)`):
fused shards equal to their rows' runs with per-shard launch counts, the
eager engine's batch equal to the unsharded one, frame-sharded MCEM at
var_RW = 0 against single-device `mcem_run`, and a data-parallel epoch
against the single-device one.

Every test here needs an NVIDIA GPU and skips without one. The file
imports neither JAX nor the JAX package, so it also runs on a GPU machine
without JAX:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

Tolerance: atol 2e-5 / rtol 2e-4 (float32; the kernels sum in another
order than PyTorch, and the fast kernels' approximate reciprocal is within
1 ulp of the plain version's exact one). Chains run on accept/reject noise
whose decisions cannot flip on rounding (see `decisive_noise`).
"""

import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

from guided_vae_nmf_torch import launch_counts, reset_launch_counts
from guided_vae_nmf_torch.mcem import (
    MCEMConfig,
    mcem_batch_fused,
    mh_chain,
    mh_chain_ref,
    nmf_sums,
    nmf_sums_ref,
)
from guided_vae_nmf_torch.mcem.fused_engine import _dec_parts
from guided_vae_nmf_torch.mcem.mh_chain import philox_streams
from guided_vae_nmf_torch.models import module_from_params

TOL = dict(atol=2e-5, rtol=2e-4)
SMALL = dict(B=2, F=65, N=128, L=8, H=16, K=3, Y=10)
FULL = dict(B=2, F=513, N=256, L=32, H=128, K=10, Y=513)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _linear(rng, n_in, n_out):
    return {"w": (rng.randn(n_in, n_out) * np.sqrt(2.0 / (n_in + n_out)))
            .astype(np.float32),
            "b": (0.1 * rng.randn(n_out)).astype(np.float32)}


def random_dgm(rng, F, Y, L, H, depth=2):
    """A seeded M2 parameter tree: encoder (F+Y) -> H^depth -> (mu, logvar)
    of L, decoder (L+Y) -> H^depth -> F."""
    def stack(n_in):
        return [_linear(rng, n_in, H)] + [_linear(rng, H, H)
                                          for _ in range(depth - 1)]

    return {
        "encoder": {"hidden": stack(F + Y), "mu": _linear(rng, H, L),
                    "log_var": _linear(rng, H, L)},
        "decoder": {"hidden": stack(L + Y), "out": _linear(rng, H, F)},
        "y_dim": Y,
    }


def chain_case(device, seed, B, F, N, L, H, K, Y, depth=2):
    """Chain inputs on `device`: decoder parts, X2, (Wt, H), Vb, g, ypre,
    Z, Vs = decode(Z), mask."""
    rng = np.random.RandomState(seed)
    model = module_from_params(random_dgm(rng, F, Y, L, H, depth),
                               device=device)
    dec_w = _dec_parts(model.decoder, L)
    t = lambda a: torch.tensor(a, device=device)  # noqa: E731
    y = t((rng.uniform(size=(B, N, Y)) > 0.5).astype(np.float32))
    l0 = model.decoder.hidden[0]
    ypre = (y @ l0.w[L:] + l0.b).contiguous()
    Z = t(rng.randn(B, N, L).astype(np.float32))
    Vs = model.decoder(torch.cat([Z, y], dim=-1)).contiguous()
    mask = t((np.arange(N)[None] < N - 37 * np.arange(B)[:, None]).astype(
        np.float32))
    return dict(
        dec_w=dec_w, X2=t(rng.uniform(0.05, 1.05, (B, N, F)).astype(
            np.float32)),
        WH=(t(rng.uniform(0.05, 0.5, (B, K, F)).astype(np.float32)),
            t(rng.uniform(0.05, 0.5, (B, K, N)).astype(np.float32))),
        g=t(rng.uniform(0.5, 1.5, (B, N)).astype(np.float32)),
        ypre=ypre, Z=Z, Vs=Vs, mask=mask,
        Vb=t(rng.uniform(0.01, 0.3, (B, N, F)).astype(np.float32)))


def decisive_noise(device, seed, B, N, L, n_steps):
    """Proposal normals, and accept uniforms of 0 (log u = -inf: always
    accept) or inf (always reject), so no decision can flip on the
    rounding differences between the kernel and the plain version."""
    rng = np.random.RandomState(seed)
    zn = rng.randn(B, n_steps, N, L).astype(np.float32)
    u = np.where(rng.uniform(size=(B, n_steps, N)) < 0.5, 0.0, np.inf)
    return (torch.tensor(zn, device=device),
            torch.tensor(u.astype(np.float32), device=device))


def run_chain(fn, c, mode, nsamples, burnin, var_rw, vb=False, **kw):
    return fn(c["dec_w"], c["X2"], None if vb else c["WH"], c["g"],
              c["ypre"], c["Z"], c["Vs"], mode=mode, nsamples=nsamples,
              burnin=burnin, var_RW=var_rw,
              mask=c["mask"] if mode == "e" and not vb else None,
              Vb=c["Vb"] if vb else None, **kw)


def _close(got, ref):
    assert_allclose(got.float().cpu().numpy(), ref.float().cpu().numpy(),
                    **TOL)


def nonzero(counts):
    """The launch counts without the variants that did not launch."""
    return {k: {v: n for v, n in d.items() if n} for k, d in counts.items()}


FAST = {"fast": dict(samples_dtype=torch.bfloat16, approx_recip=True),
        "trans": dict(samples_dtype=torch.bfloat16, approx_recip=True,
                      approx_trans=True)}


@pytest.mark.cuda
@pytest.mark.parametrize("shape", ["small", "full"])
@pytest.mark.parametrize("mode", ["e", "wf"])
def test_chain_kernel_matches_plain(cuda, mode, shape):
    dims = SMALL if shape == "small" else FULL
    c = chain_case(cuda, 1, **dims)
    nsamples, burnin = 4, 3
    noise = decisive_noise(cuda, 2, dims["B"], dims["N"], dims["L"],
                           nsamples + burnin)
    ref = run_chain(mh_chain_ref, c, mode, nsamples, burnin, 0.01,
                    noise=noise)
    got = run_chain(mh_chain, c, mode, nsamples, burnin, 0.01, noise=noise)
    torch.cuda.synchronize()
    _close(got[0], ref[0])
    _close(got[1], ref[1])
    for a, b in zip(got[2], ref[2]):
        _close(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("depth,L,F,K", [(1, 7, 100, 1), (3, 5, 257, 4),
                                         (2, 32, 768, 16)])
def test_chain_kernel_other_shapes(cuda, depth, L, F, K):
    """Decoder depths 1 and 3, latent widths that are not multiples of 4,
    ragged bin counts, and the largest F and K the kernels take."""
    dims = dict(B=2, F=F, N=32, L=L, H=24, K=K, Y=3)
    c = chain_case(cuda, 9, depth=depth, **dims)
    noise = decisive_noise(cuda, 10, 2, 32, L, 6)
    for mode in ("e", "wf"):
        ref = run_chain(mh_chain_ref, c, mode, 3, 3, 0.01, noise=noise)
        got = run_chain(mh_chain, c, mode, 3, 3, 0.01, noise=noise)
        for a, b in zip((got[0], got[1]) + got[2], (ref[0], ref[1]) + ref[2]):
            _close(a, b)
    samples = torch.rand((2, 3, 32, F), device=cuda) + 0.01
    for mode in ("h", "g"):
        args = (samples, c["WH"], c["g"], c["X2"])
        for a, b in zip(nmf_sums(*args, mode=mode),
                        nmf_sums_ref(*args, mode=mode)):
            _close(a, b)


@pytest.mark.cuda
def test_kernel_wrappers_reject_bad_input(cuda):
    c = chain_case(cuda, 11, **SMALL)
    with pytest.raises(ValueError):           # N not a multiple of 16
        mh_chain(c["dec_w"], c["X2"][:, :120].contiguous(),
                 (c["WH"][0], c["WH"][1][:, :, :120].contiguous()),
                 c["g"][:, :120].contiguous(),
                 c["ypre"][:, :120].contiguous(),
                 c["Z"][:, :120].contiguous(),
                 c["Vs"][:, :120].contiguous(), mode="wf")
    with pytest.raises(ValueError):           # not contiguous
        strided = c["X2"].transpose(1, 2).contiguous().transpose(1, 2)
        mh_chain(c["dec_w"], strided, c["WH"], c["g"], c["ypre"], c["Z"],
                 c["Vs"], mode="wf")
    with pytest.raises(ValueError):           # rank above the kernel's 16
        wt = torch.rand((2, 17, 65), device=cuda)
        h = torch.rand((2, 17, 128), device=cuda)
        nmf_sums(torch.rand((2, 2, 128, 65), device=cuda), (wt, h), c["g"],
                 c["X2"])


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["e", "wf"])
def test_chain_kernel_var0_matches_plain(cuda, mode):
    c = chain_case(cuda, 3, **FULL)
    ref = run_chain(mh_chain_ref, c, mode, 3, 2, 0.0,
                    generator=torch.Generator(device=cuda).manual_seed(0))
    got = run_chain(mh_chain, c, mode, 3, 2, 0.0, seed=7)
    for a, b in zip((got[0], got[1]) + got[2], (ref[0], ref[1]) + ref[2]):
        _close(a, b)


@pytest.mark.cuda
def test_chain_philox_stream(cuda):
    """In-kernel Philox: reproducible per seed, standard normal proposals,
    and exactly the streams `philox_streams` reports."""
    dims = FULL
    c = chain_case(cuda, 4, **dims)
    nsamples, burnin = 10, 30
    a = run_chain(mh_chain, c, "e", nsamples, burnin, 0.01, seed=11)
    b = run_chain(mh_chain, c, "e", nsamples, burnin, 0.01, seed=11)
    d = run_chain(mh_chain, c, "e", nsamples, burnin, 0.01, seed=12)
    assert torch.equal(a[0], b[0]) and torch.equal(a[2][0], b[2][0])
    assert not torch.equal(a[0], d[0])
    samples = a[2][0]
    moved = torch.any(samples[:, 1:] != samples[:, :-1], dim=-1)
    assert 0.0 < moved.float().mean().item() < 1.0
    zn, u = philox_streams(11, dims["B"], dims["N"], dims["L"],
                           nsamples + burnin, cuda)
    assert abs(zn.mean().item()) < 0.01 and abs(zn.var().item() - 1) < 0.01
    assert 0.0 < u.min().item() and u.max().item() < 1.0
    assert abs(u.mean().item() - 0.5) < 0.01
    inj = run_chain(mh_chain, c, "e", nsamples, burnin, 0.01, noise=(zn, u))
    assert torch.equal(a[0], inj[0])
    assert all(torch.equal(x, y) for x, y in zip(a[2], inj[2]))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", ["small", "full"])
@pytest.mark.parametrize("mode", ["h", "g"])
def test_sums_kernel_matches_plain(cuda, mode, shape):
    dims = SMALL if shape == "small" else FULL
    c = chain_case(cuda, 5, **dims)
    rng = np.random.RandomState(6)
    samples = torch.tensor(rng.uniform(
        0.01, 2.0, (dims["B"], 10, dims["N"], dims["F"])).astype(np.float32),
        device=cuda)
    args = (samples, c["WH"], c["g"], c["X2"])
    for a, b in zip(nmf_sums(*args, mode=mode),
                    nmf_sums_ref(*args, mode=mode)):
        _close(a, b)


@pytest.mark.cuda
def test_fused_engine_var0_matches_cpu(cuda):
    """At var_RW = 0 the chains are deterministic, so the fused engine on the
    card (kernels) and on the CPU (plain versions) agree; the launch
    counts show one E chain and two sums passes per EM iteration plus the
    WF chain."""
    dims = SMALL
    rng = np.random.RandomState(8)
    tree = random_dgm(rng, dims["F"], dims["Y"], dims["L"], dims["H"])
    B, F, N = dims["B"], dims["F"], dims["N"]
    X = rng.uniform(0.05, 1.05, (B, F, N)).astype(np.float32)
    y = (rng.uniform(size=(B, dims["Y"], N)) > 0.5).astype(np.float32)
    mask = np.ones((B, N), np.float32)
    init = {"W": rng.uniform(0.05, 1, (B, F, dims["K"])).astype(np.float32),
            "H": rng.uniform(0.05, 1, (B, dims["K"], N)).astype(np.float32)}
    cfg = MCEMConfig(niter=3, nsamples_E_step=2, burnin_E_step=1,
                     nsamples_WF=2, burnin_WF=1, var_RW=0.0,
                     nmf_rank=dims["K"])
    outs = {}
    for dev in ("cpu", cuda):
        t = lambda a: torch.tensor(a, device=dev)  # noqa: E731
        reset_launch_counts()
        outs[str(dev)] = mcem_batch_fused(
            module_from_params(tree, device=dev), t(X), t(mask), t(y),
            torch.Generator(device=dev).manual_seed(0), cfg,
            init={k: t(v) for k, v in init.items()})
    assert nonzero(launch_counts()) == {
        "mh_chain": {"e_wh": 3, "wf_wh": 1},
        "nmf_sums": {"h_wh": 3, "g_wh": 3}}
    for k in ("WFs", "WFn", "W", "H", "g", "Z", "cost"):
        assert_allclose(outs["cuda"][k].cpu().numpy(),
                        outs["cpu"][k].numpy(), rtol=1e-3, atol=1e-5,
                        err_msg=k)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", ["small", "full"])
@pytest.mark.parametrize("mode", ["e", "wf"])
def test_chain_vb_kernel_matches_plain(cuda, mode, shape):
    """K1b under decisive injected noise and at var_RW = 0; E-mode returns
    (samples, s1, s2)."""
    dims = SMALL if shape == "small" else FULL
    c = chain_case(cuda, 12, **dims)
    nsamples, burnin = 4, 3
    noise = decisive_noise(cuda, 13, dims["B"], dims["N"], dims["L"],
                           nsamples + burnin)
    runs = [(dict(noise=noise), dict(noise=noise), 0.01),
            (dict(seed=7), dict(generator=torch.Generator(
                device=cuda).manual_seed(0)), 0.0)]
    for kw, kw_ref, var_rw in runs:
        reset_launch_counts()
        got = run_chain(mh_chain, c, mode, nsamples, burnin, var_rw,
                        vb=True, **kw)
        assert launch_counts()["mh_chain"][f"{mode}_vb"] == 1
        ref = run_chain(mh_chain_ref, c, mode, nsamples, burnin, var_rw,
                        vb=True, **kw_ref)
        torch.cuda.synchronize()
        assert len(got[2]) == (3 if mode == "e" else 2)
        if mode == "e":
            assert got[2][1].shape == c["X2"].shape == got[2][2].shape
        for a, b in zip((got[0], got[1]) + got[2],
                        (ref[0], ref[1]) + ref[2]):
            _close(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", ["small", "full"])
@pytest.mark.parametrize("mode", ["h", "g"])
def test_sums_vb_kernel_matches_plain(cuda, mode, shape):
    dims = SMALL if shape == "small" else FULL
    c = chain_case(cuda, 14, **dims)
    rng = np.random.RandomState(15)
    samples = torch.tensor(rng.uniform(
        0.01, 2.0, (dims["B"], 10, dims["N"], dims["F"])).astype(np.float32),
        device=cuda)
    args = (samples, None, c["g"], c["X2"])
    reset_launch_counts()
    got = nmf_sums(*args, mode=mode, Vb=c["Vb"])
    assert launch_counts()["nmf_sums"][f"{mode}_vb"] == 1
    ref = nmf_sums_ref(*args, mode=mode, Vb=c["Vb"])
    want = c["X2"].shape if mode == "h" else c["g"].shape
    for a, b in zip(got, ref):
        assert a.shape == want
        _close(a, b)


@pytest.mark.cuda
def test_vb_wrappers_reject_bad_input(cuda):
    c = chain_case(cuda, 16, **SMALL)
    bad = {"shape": c["Vb"][:, :, :-1].contiguous(),
           "dtype": c["Vb"].double(),
           "strides": c["Vb"].transpose(1, 2).contiguous().transpose(1, 2)}
    samples = torch.rand((2, 2, 128, 65), device=cuda) + 0.01
    for name, vb in bad.items():
        with pytest.raises((ValueError, TypeError)):
            mh_chain(c["dec_w"], c["X2"], None, c["g"], c["ypre"], c["Z"],
                     c["Vs"], mode="wf", Vb=vb)
        with pytest.raises(ValueError):
            nmf_sums(samples, None, c["g"], c["X2"], mode="h", Vb=vb)
    with pytest.raises(ValueError, match="exactly one"):
        mh_chain(c["dec_w"], c["X2"], c["WH"], c["g"], c["ypre"], c["Z"],
                 c["Vs"], mode="wf", Vb=c["Vb"])
    with pytest.raises(ValueError, match="exactly one"):
        nmf_sums(samples, c["WH"], c["g"], c["X2"], mode="g", Vb=c["Vb"])


@pytest.mark.cuda
@pytest.mark.parametrize("bands", [1, 2])
def test_fixed_noise_engine_var0_matches_cpu(cuda, bands):
    """The spp fused engine (update_nmf=False, noise gain on) at var_RW = 0
    on the card equals the CPU run; per EM iteration one K1b E chain, one
    K2b 'h' and one K2b 'g' pass, plus the K1b WF chain."""
    dims = SMALL
    rng = np.random.RandomState(17)
    tree = random_dgm(rng, dims["F"], dims["Y"], dims["L"], dims["H"])
    B, F, N = dims["B"], dims["F"], dims["N"]
    X = rng.uniform(0.05, 1.05, (B, F, N)).astype(np.float32)
    X[:, :, 30:33] *= 50.0
    y = (rng.uniform(size=(B, dims["Y"], N)) > 0.5).astype(np.float32)
    mask = np.ones((B, N), np.float32)
    Vb = (rng.uniform(size=(B, F, N)) * 0.2 + 0.05).astype(np.float32)
    cfg = MCEMConfig(niter=3, nsamples_E_step=2, burnin_E_step=1,
                     nsamples_WF=2, burnin_WF=1, var_RW=0.0,
                     noise_gain=True, noise_gain_bands=bands)
    outs = {}
    for dev in ("cpu", cuda):
        t = lambda a: torch.tensor(a, device=dev)  # noqa: E731
        reset_launch_counts()
        outs[str(dev)] = mcem_batch_fused(
            module_from_params(tree, device=dev), t(X), t(mask), t(y),
            torch.Generator(device=dev).manual_seed(0), cfg,
            update_nmf=False, Vb_fixed=t(Vb))
    assert nonzero(launch_counts()) == {
        "mh_chain": {"e_vb": 3, "wf_vb": 1},
        "nmf_sums": {"h_vb": 3, "g_vb": 3}}
    for k in ("WFs", "WFn", "b", "g", "Z", "cost"):
        assert_allclose(outs["cuda"][k].cpu().numpy(),
                        outs["cpu"][k].numpy(), rtol=1e-3, atol=1e-5,
                        err_msg=k)


@pytest.mark.cuda
@pytest.mark.parametrize("level", sorted(FAST))
@pytest.mark.parametrize("form", ["wh", "vb"])
@pytest.mark.parametrize("mode", ["e", "wf"])
def test_fast_chain_kernel_matches_plain(cuda, mode, form, level):
    """K1c under decisive injected noise: the bfloat16 dumps equal the plain
    version's (the same float32 Vs, rounded to nearest even), the float32
    outputs agree at TOL; one launch under the level's counter key."""
    c = chain_case(cuda, 18, **SMALL)
    vb = form == "vb"
    noise = decisive_noise(cuda, 19, SMALL["B"], SMALL["N"], SMALL["L"], 7)
    reset_launch_counts()
    got = run_chain(mh_chain, c, mode, 4, 3, 0.01, vb=vb, noise=noise,
                    **FAST[level])
    assert nonzero(launch_counts()) == {
        "mh_chain": {f"{mode}_{form}_{level}": 1}, "nmf_sums": {}}
    ref = run_chain(mh_chain_ref, c, mode, 4, 3, 0.01, vb=vb, noise=noise,
                    **FAST[level])
    torch.cuda.synchronize()
    if mode == "e":
        assert got[2][0].dtype == torch.bfloat16
        assert torch.equal(got[2][0], ref[2][0])
    for a, b in zip((got[0], got[1]) + got[2], (ref[0], ref[1]) + ref[2]):
        _close(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["wh", "vb"])
@pytest.mark.parametrize("mode", ["h", "g"])
def test_fast_sums_kernel_matches_plain(cuda, mode, form):
    """K2c: the sums over bfloat16 samples with the approximate reciprocal."""
    c = chain_case(cuda, 20, **SMALL)
    rng = np.random.RandomState(21)
    samples = torch.tensor(rng.uniform(0.01, 2.0, (2, 10, 128, 65)).astype(
        np.float32), device=cuda).to(torch.bfloat16)
    kw = dict(Vb=c["Vb"]) if form == "vb" else {}
    wh = None if form == "vb" else c["WH"]
    reset_launch_counts()
    got = nmf_sums(samples, wh, c["g"], c["X2"], mode=mode,
                   approx_recip=True, **kw)
    assert nonzero(launch_counts()) == {
        "mh_chain": {}, "nmf_sums": {f"{mode}_{form}_fast": 1}}
    ref = nmf_sums_ref(samples, wh, c["g"], c["X2"], mode=mode, **kw)
    for a, b in zip(got, ref):
        _close(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("level", sorted(FAST))
def test_fast_engine_var0_matches_cpu(cuda, level):
    """The fused engine in fast mode (no cost pass) on the card against the
    CPU run at var_RW = 0: only fast launches, in the NMF form."""
    dims = SMALL
    rng = np.random.RandomState(22)
    tree = random_dgm(rng, dims["F"], dims["Y"], dims["L"], dims["H"])
    B, F, N = dims["B"], dims["F"], dims["N"]
    X = rng.uniform(0.05, 1.05, (B, F, N)).astype(np.float32)
    y = (rng.uniform(size=(B, dims["Y"], N)) > 0.5).astype(np.float32)
    mask = np.ones((B, N), np.float32)
    init = {"W": rng.uniform(0.05, 1, (B, F, dims["K"])).astype(np.float32),
            "H": rng.uniform(0.05, 1, (B, dims["K"], N)).astype(np.float32)}
    cfg = MCEMConfig(niter=3, nsamples_E_step=2, burnin_E_step=1,
                     nsamples_WF=2, burnin_WF=1, var_RW=0.0,
                     nmf_rank=dims["K"])
    outs = {}
    for dev in ("cpu", cuda):
        t = lambda a: torch.tensor(a, device=dev)  # noqa: E731
        reset_launch_counts()
        outs[str(dev)] = mcem_batch_fused(
            module_from_params(tree, device=dev), t(X), t(mask), t(y),
            torch.Generator(device=dev).manual_seed(0), cfg,
            init={k: t(v) for k, v in init.items()}, compute_cost=False,
            **FAST[level])
    assert nonzero(launch_counts()) == {
        "mh_chain": {f"e_wh_{level}": 3, f"wf_wh_{level}": 1},
        "nmf_sums": {"h_wh_fast": 3, "g_wh_fast": 3}}
    for k in ("WFs", "WFn", "W", "H", "g", "Z"):
        assert_allclose(outs["cuda"][k].cpu().numpy(),
                        outs["cpu"][k].numpy(), rtol=2e-3, atol=1e-5,
                        err_msg=k)


# K1d (matmul_dtype=torch.bfloat16): the kernel and the plain version sum
# the same exact products of bfloat16 operands in another order. Where the
# order moves a hidden output (or an E-mode sample dump) across a bfloat16
# rounding boundary, that value moves by one bfloat16 ulp (at most 2^-7 of
# it). So every element is held at atol 2e-5 / rtol 2e-2, and at most 1 %
# of them may lie past TOL; a kernel that skipped the rounding would put
# most of Vs past TOL (checked against the float32-product kernel).
K1D_TOL = dict(atol=2e-5, rtol=2e-2)


def _close_k1d(got, ref):
    g, r = got.float().cpu().numpy(), ref.float().cpu().numpy()
    assert_allclose(g, r, **K1D_TOL)
    assert _past_tol(g, r) <= 0.01


def _past_tol(g, r):
    return float(np.mean(np.abs(g - r) > TOL["atol"] + TOL["rtol"]
                         * np.abs(r)))


@pytest.mark.cuda
@pytest.mark.parametrize("level", ["exact", "fast", "trans"])
@pytest.mark.parametrize("form", ["wh", "vb"])
@pytest.mark.parametrize("mode", ["e", "wf"])
def test_bf16mm_chain_kernel_matches_plain(cuda, mode, form, level):
    """K1d at full width under decisive injected noise: one launch under
    the level's key with "_mm16", Z equal to the plain version's, the rest
    at K1D_TOL; the float32-product kernel's Vs differs."""
    dims = FULL
    c = chain_case(cuda, 24, **dims)
    vb = form == "vb"
    opts = FAST.get(level, {})
    noise = decisive_noise(cuda, 25, dims["B"], dims["N"], dims["L"], 7)
    reset_launch_counts()
    got = run_chain(mh_chain, c, mode, 4, 3, 0.01, vb=vb, noise=noise,
                    matmul_dtype=torch.bfloat16, **opts)
    lv = "" if level == "exact" else f"_{level}"
    assert nonzero(launch_counts()) == {
        "mh_chain": {f"{mode}_{form}{lv}_mm16": 1}, "nmf_sums": {}}
    ref = run_chain(mh_chain_ref, c, mode, 4, 3, 0.01, vb=vb, noise=noise,
                    matmul_dtype=torch.bfloat16, **opts)
    f32 = run_chain(mh_chain, c, mode, 4, 3, 0.01, vb=vb, noise=noise,
                    **opts)
    torch.cuda.synchronize()
    assert torch.equal(got[0], ref[0])
    for a, b in zip((got[1],) + got[2], (ref[1],) + ref[2]):
        _close_k1d(a, b)
    assert _past_tol(f32[1].cpu().numpy(), ref[1].cpu().numpy()) > 0.5


@pytest.mark.cuda
def test_bf16mm_engine_var0_matches_cpu(cuda):
    """The fused engine with the harness's fast_bf16mm options on the card
    against the CPU run at var_RW = 0: every chain launches K1d."""
    dims = SMALL
    rng = np.random.RandomState(26)
    tree = random_dgm(rng, dims["F"], dims["Y"], dims["L"], dims["H"])
    B, F, N = dims["B"], dims["F"], dims["N"]
    X = rng.uniform(0.05, 1.05, (B, F, N)).astype(np.float32)
    y = (rng.uniform(size=(B, dims["Y"], N)) > 0.5).astype(np.float32)
    mask = np.ones((B, N), np.float32)
    init = {"W": rng.uniform(0.05, 1, (B, F, dims["K"])).astype(np.float32),
            "H": rng.uniform(0.05, 1, (B, dims["K"], N)).astype(np.float32)}
    cfg = MCEMConfig(niter=3, nsamples_E_step=2, burnin_E_step=1,
                     nsamples_WF=2, burnin_WF=1, var_RW=0.0,
                     nmf_rank=dims["K"])
    outs = {}
    for dev in ("cpu", cuda):
        t = lambda a: torch.tensor(a, device=dev)  # noqa: E731
        reset_launch_counts()
        outs[str(dev)] = mcem_batch_fused(
            module_from_params(tree, device=dev), t(X), t(mask), t(y),
            torch.Generator(device=dev).manual_seed(0), cfg,
            init={k: t(v) for k, v in init.items()}, compute_cost=False,
            matmul_dtype=torch.bfloat16, **FAST["fast"])
    assert nonzero(launch_counts()) == {
        "mh_chain": {"e_wh_fast_mm16": 3, "wf_wh_fast_mm16": 1},
        "nmf_sums": {"h_wh_fast": 3, "g_wh_fast": 3}}
    for k in ("WFs", "WFn", "W", "H", "g", "Z"):
        assert_allclose(outs["cuda"][k].cpu().numpy(),
                        outs["cpu"][k].numpy(), rtol=2e-3, atol=1e-5,
                        err_msg=k)


@pytest.mark.cuda
@pytest.mark.parametrize("fixed", [False, True])
def test_peem_and_hybrid_var0_match_cpu(cuda, fixed):
    """PEEM (no kernel launch; its products on cuBLAS in float32) and the
    PEEM -> MCEM hybrid at var_RW = 0 on the card against the CPU run, from
    the same seed: PEEM's init is a function of the seed on every device.
    rtol 1e-3: 8 PEEM iterations and 2 MCEM iterations of float32 sums in
    other orders."""
    from guided_vae_nmf_torch.mcem import (
        PEEMConfig, peem_m2_batch, peem_mcem_m2_batch)

    dims = SMALL
    rng = np.random.RandomState(27)
    tree = random_dgm(rng, dims["F"], dims["Y"], dims["L"], dims["H"])
    B, F, N = dims["B"], dims["F"], dims["N"]
    X = rng.uniform(0.05, 1.05, (B, F, N)).astype(np.float32)
    y = (rng.uniform(size=(B, dims["Y"], N)) > 0.5).astype(np.float32)
    mask = np.ones((B, N), np.float32)
    Vb = (rng.uniform(size=(B, F, N)) * 0.2 + 0.05).astype(np.float32)
    pcfg = PEEMConfig(niter=8, e_steps=3, nmf_rank=dims["K"])
    mcfg = MCEMConfig(niter=2, nsamples_E_step=2, burnin_E_step=1,
                      nsamples_WF=2, burnin_WF=1, var_RW=0.0,
                      nmf_rank=dims["K"])
    peem, hyb = {}, {}
    for dev in ("cpu", cuda):
        t = lambda a: torch.tensor(a, device=dev)  # noqa: E731
        args = (module_from_params(tree, device=dev), t(X), t(mask), t(y),
                torch.Generator(device=dev).manual_seed(3))
        kw = dict(update_nmf=not fixed, Vb_fixed=t(Vb) if fixed else None)
        reset_launch_counts()
        peem[str(dev)] = peem_m2_batch(*args, pcfg, **kw)
        assert nonzero(launch_counts()) == {"mh_chain": {}, "nmf_sums": {}}
        hyb[str(dev)] = peem_mcem_m2_batch(*args, pcfg, mcfg, **kw)
    form = "vb" if fixed else "wh"
    sums = {"g_vb": 2} if fixed else {"h_wh": 2, "g_wh": 2}
    assert nonzero(launch_counts()) == {
        "mh_chain": {f"e_{form}": 2, f"wf_{form}": 1}, "nmf_sums": sums}
    for out in (peem, hyb):
        for k in ("WFs", "WFn", "W", "H", "g", "Z", "cost"):
            assert_allclose(out["cuda"][k].cpu().numpy(),
                            out["cpu"][k].numpy(), rtol=1e-3, atol=1e-5,
                            err_msg=k)


# The chain kernel on thread-block clusters: each of the CLUSTER CTAs of a
# cluster holds a column slice of the decoder (ceil(F / 4) bins and
# ceil(H / 4) hidden units, the last ones ragged) for two 16-frame tiles of
# one utterance; an odd tile count makes the last cluster of an utterance
# compute its one tile twice and write it once.


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["wh", "vb"])
def test_chain_batch_matches_each_utterance(cuda, form):
    """A chain over B=4 returns, per utterance, bit for bit what the chain
    over that utterance alone returns: no result depends on the tiling or
    on the other clusters. N=48 (three tiles) takes the repeated-tile
    path. The option kernel runs on injected decisive noise (sliced per
    utterance); the exact kernel at var_RW = 0, where the Philox stream
    (keyed on the utterance index) changes no output."""
    dims = dict(B=4, F=513, N=48, L=32, H=128, K=10, Y=20)
    c = chain_case(cuda, 30, **dims)
    vb = form == "vb"
    noise = decisive_noise(cuda, 31, 4, 48, 32, 7)

    def one(b):
        cb = {k: v[b:b + 1].contiguous() if torch.is_tensor(v) else v
              for k, v in c.items() if k != "WH"}
        cb["WH"] = tuple(x[b:b + 1].contiguous() for x in c["WH"])
        return cb

    for mode in ("e", "wf"):
        runs = [(dict(noise=noise), 0.01,
                 lambda b: dict(noise=tuple(x[b:b + 1].contiguous()
                                            for x in noise))),
                (dict(seed=5), 0.0, lambda b: dict(seed=5))]
        for kw, var_rw, kw_b in runs:
            got = run_chain(mh_chain, c, mode, 4, 3, var_rw, vb=vb, **kw)
            outs = (got[0], got[1]) + got[2]
            for b in range(4):
                alone = run_chain(mh_chain, one(b), mode, 4, 3, var_rw,
                                  vb=vb, **kw_b(b))
                for x, y in zip(outs, (alone[0], alone[1]) + alone[2]):
                    assert torch.equal(x[b:b + 1], y), (mode, var_rw, b)


@pytest.mark.cuda
@pytest.mark.parametrize("H", [16, 24, 128])
@pytest.mark.parametrize("F", [65, 129, 130, 513])
def test_chain_kernel_ragged_cluster_split(cuda, F, H):
    """F and H whose split over the cluster's 4 CTAs is ragged (F=129 and
    513 leave one extra bin on the first CTA, F=65 and 130 ragged last
    slices; H=24 gives 6 units a CTA, not a multiple of 4), E and WF, both
    forms, against the plain version under decisive injected noise; N=48
    repeats a tile."""
    dims = dict(B=2, F=F, N=48, L=8, H=H, K=3, Y=10)
    c = chain_case(cuda, F + H, **dims)
    noise = decisive_noise(cuda, 32, 2, 48, 8, 7)
    for vb in (False, True):
        for mode in ("e", "wf"):
            ref = run_chain(mh_chain_ref, c, mode, 4, 3, 0.01, vb=vb,
                            noise=noise)
            got = run_chain(mh_chain, c, mode, 4, 3, 0.01, vb=vb,
                            noise=noise)
            for a, b in zip((got[0], got[1]) + got[2],
                            (ref[0], ref[1]) + ref[2]):
                _close(a, b)


@pytest.mark.cuda
def test_chain_launch_geometry(cuda):
    """The launch the wrapper reports: 4-CTA clusters, 288 threads and
    under 227 KB of shared memory a CTA at the shipped decoder's widths,
    at least one resident cluster; shapes whose slices do not fit raise
    with the reason."""
    from guided_vae_nmf_torch.mcem.mh_chain import launch_geometry

    geo = launch_geometry(513, 32, 128, 10, 2, cuda)
    assert geo["cluster"] == 4 and geo["frames"] == 16
    assert geo["threads"] == 288 and geo["smem_bytes"] <= 232448
    assert geo["max_active_clusters"] >= 1 and geo["registers"] > 0
    c = chain_case(cuda, 33, B=1, F=768, N=16, L=32, H=128, K=2, Y=3)
    with pytest.raises(ValueError, match="shared memory"):
        run_chain(mh_chain, c, "wf", 2, 1, 0.01)


# K2 as a streaming pass: each CTA walks an even share of the B N frames in
# tiles of a few frames of one utterance, two bins of each frame
# a consumer thread; the samples, Vb and X2 rows of a tile arrive by bulk
# copies of their enclosing 16-byte granules, so any N, F and storage
# offset stream the same way. Every sum has one order that depends on F
# and K only.

SUMS_LEVELS = {"f32": (torch.float32, False), "f32_rcp": (torch.float32, True),
               "bf16": (torch.bfloat16, False),
               "bf16_rcp": (torch.bfloat16, True)}


def sums_case(device, seed, B, R, N, F, K):
    rng = np.random.RandomState(seed)
    t = lambda a: torch.tensor(a.astype(np.float32), device=device)  # noqa
    return dict(samples=t(rng.uniform(0.01, 2.0, (B, R, N, F))),
                X2=t(rng.uniform(0.05, 1.05, (B, N, F))),
                WH=(t(rng.uniform(0.05, 0.5, (B, K, F))),
                    t(rng.uniform(0.05, 0.5, (B, K, N)))),
                g=t(rng.uniform(0.5, 1.5, (B, N))),
                Vb=t(rng.uniform(0.01, 0.3, (B, N, F))))


def run_all_sums(fn, c, samples, **kw):
    """Both modes in both forms: {(mode, form): (o1, o2)}."""
    out = {}
    for mode in ("h", "g"):
        out[mode, "wh"] = fn(samples, c["WH"], c["g"], c["X2"], mode=mode,
                             **kw)
        out[mode, "vb"] = fn(samples, None, c["g"], c["X2"], mode=mode,
                             Vb=c["Vb"], **kw)
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("N", [16, 40, 384])
@pytest.mark.parametrize("F", [65, 129, 130, 513])
def test_sums_kernel_ragged_shapes(cuda, F, N):
    """Every K2 variant against the plain version at ragged F (the bins of
    the last consumer warp run past F; a tile of F=513 or 65 bins is no
    multiple of 16 bytes), N that is no multiple of the tile, (R, K) in
    (1, 16), (2, 1) and (10, 10), float32 and bfloat16 samples, with and
    without the approximate reciprocal."""
    for R, K in ((1, 16), (2, 1), (10, 10)):
        c = sums_case(cuda, F + N + R, 2, R, N, F, K)
        for level, (dtype, rcp) in SUMS_LEVELS.items():
            samples = c["samples"].to(dtype)
            got = run_all_sums(nmf_sums, c, samples, approx_recip=rcp)
            ref = run_all_sums(nmf_sums_ref, c, samples)
            for key in got:
                for a, b in zip(got[key], ref[key]):
                    assert a.shape == b.shape, (key, R, K, level)
                    _close(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("level", sorted(SUMS_LEVELS))
def test_sums_batch_matches_each_utterance(cuda, level):
    """A B=4 pass returns, per utterance, bit for bit what the pass over
    that utterance alone returns, though the tiles and the CTAs' shares of
    the frames differ (N=38 at F=513: tiles of 4 frames, ragged); and two
    launches on the same inputs are equal."""
    dtype, rcp = SUMS_LEVELS[level]
    c = sums_case(cuda, 40, 4, 10, 38, 513, 10)
    samples = c["samples"].to(dtype)
    got = run_all_sums(nmf_sums, c, samples, approx_recip=rcp)
    again = run_all_sums(nmf_sums, c, samples, approx_recip=rcp)
    for key in got:
        assert all(torch.equal(a, b) for a, b in zip(got[key], again[key]))
    for b in range(4):
        one = {k: v[b:b + 1].contiguous() for k, v in c.items() if k != "WH"}
        one["WH"] = tuple(x[b:b + 1].contiguous() for x in c["WH"])
        alone = run_all_sums(nmf_sums, one, samples[b:b + 1].contiguous(),
                             approx_recip=rcp)
        for key in got:
            for x, y in zip(got[key], alone[key]):
                assert torch.equal(x[b:b + 1], y), (key, b)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_sums_kernel_offset_and_strided_views(cuda, dtype):
    """Contiguous views at storage offsets that break 16-byte alignment
    (samples, X2 and Vb) are taken and give the plain version's result; a
    non-contiguous view is refused with a ValueError."""
    B, R, N, F, K = 2, 3, 40, 129, 4
    c = sums_case(cuda, 41, B, R, N, F, K)

    def shifted(t, by):
        flat = torch.empty(t.numel() + by, dtype=t.dtype, device=cuda)
        view = flat[by:].view(t.shape)
        view.copy_(t)
        return view

    samples = shifted(c["samples"].to(dtype), 3)
    c2 = dict(c, X2=shifted(c["X2"], 1), Vb=shifted(c["Vb"], 2))
    assert samples.storage_offset() == 3 and samples.is_contiguous()
    got = run_all_sums(nmf_sums, c2, samples)
    ref = run_all_sums(nmf_sums_ref, c, c["samples"].to(dtype))
    for key in got:
        for a, b in zip(got[key], ref[key]):
            _close(a, b)
    strided = samples.transpose(2, 3).contiguous().transpose(2, 3)
    with pytest.raises(ValueError, match="contiguous"):
        nmf_sums(strided, c["WH"], c["g"], c["X2"], mode="g")


@pytest.mark.cuda
def test_sums_exact_reciprocal_is_correctly_rounded(cuda):
    """The exact kernels' 1/Vx (rcp.approx and one Newton step) is 1.0 / Vx
    bit for bit: 'h' with Vb at R=1, g=1 and Vb=0 gives s1 = 1/Vx and
    s2 = (1/Vx)^2 of one term each, here over every float32 significand
    (the all-ones ones included) at exponents from 2^-33, just over the
    1e-10 floor, to 2^59, where (1/Vx)^2 is still normal."""
    sig = torch.arange(1 << 23, dtype=torch.int32, device=cuda)
    vx = torch.cat([(((e + 127) << 23) | sig).view(torch.float32)
                    for e in (-33, -1, 0, 1, 24, 59)])
    F = 512
    N = vx.numel() // F
    samples = vx.view(1, 1, N, F)
    g = torch.ones(1, N, device=cuda)
    Vb = torch.zeros(1, N, F, device=cuda)
    got = nmf_sums(samples, None, g, mode="h", Vb=Vb)
    ref = nmf_sums_ref(samples, None, g, mode="h", Vb=Vb)
    assert torch.equal(got[0], 1.0 / vx.view(1, N, F))
    for a, b in zip(got, ref):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_sums_launch_geometry(cuda):
    """The launch the wrapper reports at the paths' shapes: at least one
    CTA on every SM at B=4, N=384 (F=513, K=10, R=10), 320 threads (9
    consumer warps of two bins a thread, and a producer warp), tiles of 4
    frames (one frame at F=FMAX), under 227 KB of shared memory; F past
    FMAX and K past KMAX raise with the reason."""
    from guided_vae_nmf_torch.mcem.nmf_sums import (
        FMAX, KMAX, launch_geometry)

    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    for mode in ("h", "g"):
        for vb in (False, True):
            for bf16 in (False, True):
                geo = launch_geometry(4, 10, 384, 513, 10, mode, vb, bf16,
                                      device=cuda)
                assert geo["sms"] == sms and geo["ctas"] >= sms
                assert geo["threads"] == 320 and geo["frames"] == 4
                assert 0 < geo["smem_bytes"] <= 232448
                assert geo["ctas_per_sm"] >= 1 and geo["registers"] > 0
                assert geo["ctas"] <= geo["ctas_per_sm"] * sms
    geo = launch_geometry(4, 10, 384, FMAX, 10, device=cuda)
    assert geo["frames"] == 1 and geo["threads"] == 1024
    c = sums_case(cuda, 42, 1, 2, 16, FMAX + 1, 2)
    with pytest.raises(ValueError, match=f"F={FMAX + 1}"):
        nmf_sums(c["samples"], c["WH"], c["g"], c["X2"], mode="h")
    c = sums_case(cuda, 43, 1, 2, 16, 65, KMAX + 1)
    with pytest.raises(ValueError, match=f"NMF rank {KMAX + 1}"):
        nmf_sums(c["samples"], c["WH"], c["g"], c["X2"], mode="h")


# Paths that launch no kernel of their own (PyTorch operations on the
# card): the oracle labels, the eager engine and the Wiener-DNN forward.


def _speech_power(rng, B, F, N):
    """(B, F, N) speech-like power: harmonic stacks with a gliding f0 and a
    syllable-rate gate, over a little noise."""
    f = np.arange(F)[None, :, None]
    n = np.arange(N)[None, None, :]
    f0 = rng.uniform(6, 12, (B, 1, 1)) * (1 + 0.1 * np.sin(n / 40.0))
    dist = np.abs(f / f0 - np.round(f / f0))
    p = np.exp(-(dist / 0.08) ** 2) * np.exp(-f / 150.0)
    p *= (np.sin(n / 7.0 + rng.uniform(0, 6, (B, 1, 1))) > -0.3)
    p = p * 1e3 + rng.exponential(size=(B, F, N)) * 1e-2
    return p.astype(np.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("N", [384, 2048])
def test_oracle_labels_match_cpu(cuda, N):
    """The Lorenz-quantile IBM and VAD on the card against the CPU: the
    sort path at N=384 and the bisection at N=2048 (513 N >= 2^20); equal
    but for at most one crossing element a row."""
    from guided_vae_nmf_torch.dsp import (
        clean_speech_IBM_torch, clean_speech_VAD_torch)

    p = _speech_power(np.random.RandomState(N), 3, 513, N)
    p[2] = 0.0                                  # no element below 98 %
    for fn in (clean_speech_IBM_torch, clean_speech_VAD_torch):
        got = fn(torch.tensor(p, device=cuda)).cpu().numpy()
        ref = fn(torch.tensor(p)).numpy()
        assert got.shape == ref.shape
        diff = (got != ref).reshape(3, -1).sum(axis=1)
        assert np.all(diff <= 1), (fn.__name__, diff)
        assert 0 < ref[0].mean() < 1 and not ref[2].any()


@pytest.mark.cuda
@pytest.mark.parametrize("noise_model", ["nmf", "spp", "hybrid"])
def test_eager_engine_matches_cpu(cuda, noise_model):
    """mcem_run on the card against the CPU, from one init_nmf, under
    injected streams whose accept decisions cannot flip; no K1 / K2
    launch. Full width: F=513, L=32, H=128."""
    from guided_vae_nmf_torch.mcem.engine import mcem_run

    dims = dict(FULL, N=128)
    B, F, N, K = dims["B"], dims["F"], dims["N"], dims["K"]
    rng = np.random.RandomState(41)
    tree = random_dgm(rng, F, dims["Y"], dims["L"], dims["H"])
    X = rng.uniform(0.05, 1.05, (B, F, N)).astype(np.float32)
    y = (rng.uniform(size=(B, dims["Y"], N)) > 0.5).astype(np.float32)
    mask = np.ones((B, N), np.float32)
    mask[1, N - 30:] = 0.0
    Vb = (rng.uniform(size=(B, F, N)) * 0.2 + 0.05).astype(np.float32)
    update_nmf = noise_model != "spp"
    Kr = K if update_nmf else 1
    W0 = rng.uniform(0.05, 1, (B, F, Kr)).astype(np.float32)
    H0 = rng.uniform(0.05, 1, (B, Kr, N)).astype(np.float32)
    if not update_nmf:
        W0, H0 = np.ones_like(W0), np.zeros_like(H0)
    g0 = np.ones((B, N), np.float32)
    cfg = MCEMConfig(niter=3, nsamples_E_step=2, burnin_E_step=1,
                     nsamples_WF=2, burnin_WF=1, nmf_rank=K)
    outs = {}
    for dev in ("cpu", cuda):
        t = lambda a: torch.tensor(a, device=dev)  # noqa: E731
        zE, uE = decisive_noise(dev, 42, B * 3, N, dims["L"], 3)
        zW, uW = decisive_noise(dev, 43, B, N, dims["L"], 3)
        noise = (zE.reshape(B, 3, 3, N, -1).transpose(-1, -2),
                 uE.reshape(B, 3, 3, N), zW.transpose(-1, -2), uW)
        reset_launch_counts()
        outs[str(dev)] = mcem_run(
            module_from_params(tree, device=dev), t(X), t(mask), t(y),
            [1, 2], cfg, update_nmf=update_nmf,
            Vb_fixed=None if noise_model == "nmf" else t(Vb),
            init_nmf=(t(W0), t(H0), t(g0)), noise=noise)
        assert nonzero(launch_counts()) == {"mh_chain": {}, "nmf_sums": {}}
    for k in ("WFs", "WFn", "W", "H", "g", "Z", "cost"):
        assert_allclose(outs["cuda"][k].cpu().numpy(),
                        outs["cpu"][k].numpy(), rtol=1e-3, atol=1e-5,
                        err_msg=k)


@pytest.mark.cuda
def test_wiener_forward_matches_cpu(cuda):
    """The shipped Wiener-DNN checkpoint on the card against the CPU:
    PCM16 within 2 LSB, masks within 1e-3."""
    import os

    from guided_vae_nmf_torch.pipeline import _wiener_waveform
    from guided_vae_nmf_torch.train import load_model, load_norm_stats

    wdir = os.path.join(os.path.dirname(__file__), "..", "artifacts",
                        "pretrained", "wiener")
    mean, std = load_norm_stats(wdir)
    rng = np.random.RandomState(44)
    n_pad = 256
    x = (rng.randn(3, (n_pad - 1) * 256 + 1024) * 3000).astype(np.int16)
    mask = np.ones((3, n_pad), np.float32)
    mask[1, 200:] = 0.0
    outs = {}
    for dev in ("cpu", cuda):
        model = load_model(wdir, kind="classifier", device=dev)
        outs[str(dev)] = [a.cpu().numpy() for a in _wiener_waveform(
            model, x, mean, std, mask)]
    (s_g, m_g), (s_c, m_c) = outs["cuda"], outs["cpu"]
    assert np.abs(s_g.astype(np.int32) - s_c).max() <= 2
    assert_allclose(m_g.astype(np.float32), m_c.astype(np.float32),
                    atol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("noise_model", ["nmf", "spp"])
def test_eager_engine_row_alone_equals_batched(cuda, noise_model):
    """The eager engine's rows on the card, bit for bit: a row run alone at
    its own padded length equals the row in a batch of three padded
    further (float64 EM; the replay property of engine='xla' serving)."""
    from guided_vae_nmf_torch.mcem.engine import mcem_run

    rng = np.random.RandomState(45)
    B, F, N, Y = 3, FULL["F"], 256, FULL["Y"]
    tree = random_dgm(rng, F, Y, FULL["L"], FULL["H"])
    model = module_from_params(tree, device=cuda)
    t = lambda a: torch.tensor(a, device=cuda)  # noqa: E731
    mask = np.zeros((B, N), np.float32)
    mask[:, :100] = 1.0
    X = np.where(mask[:, None] > 0,
                 rng.exponential(size=(B, F, N)), 1.0).astype(np.float32)
    y = (rng.uniform(size=(B, Y, N)) > 0.5).astype(np.float32)
    Vb = rng.uniform(0.05, 0.3, (B, F, N)).astype(np.float32)
    kw = {} if noise_model == "nmf" else dict(update_nmf=False)
    cfg = MCEMConfig(niter=5, var_RW=0.01, nmf_rank=FULL["K"])
    both = mcem_run(model, t(X), t(mask), t(y), [7, 8, 9], cfg,
                    Vb_fixed=None if kw == {} else t(Vb), **kw)
    one = mcem_run(model, t(X[:1, :, :128]), t(mask[:1, :128]),
                   t(y[:1, :, :128]), [7], cfg,
                   Vb_fixed=None if kw == {} else t(Vb[:1, :, :128]), **kw)
    for k in ("WFs", "WFn", "H", "g", "Z"):
        assert torch.equal(one[k][0, ..., :100], both[k][0, ..., :100]), k


# ---------------------------------------------------------------------------
# Streaming (no kernel of its own: plain PyTorch on the card)
# ---------------------------------------------------------------------------


def _stream_signal(seed, n):
    rng = np.random.RandomState(seed)
    t = np.arange(n) / 16000
    s = 0.1 * np.sin(2 * np.pi * np.cumsum(
        130 + 20 * np.sin(2 * np.pi * 0.9 * t)) / 16000)
    s *= np.clip(np.sin(2 * np.pi * 1.5 * t + seed), 0, None)
    return (s + 0.03 * rng.randn(n)).astype(np.float32)


def _stream_m2(device, seed=46):
    rng = np.random.RandomState(seed)
    return module_from_params(random_dgm(rng, FULL["F"], FULL["Y"],
                                         FULL["L"], FULL["H"]),
                              device=device)


def _pushed(enh, pieces):
    return np.concatenate([enh.push(p) for p in pieces] + [enh.flush()])


def _pieces(x, sizes):
    cuts = np.cumsum([0] + [sizes[i % len(sizes)]
                            for i in range(len(x) // min(sizes) + 1)])
    return [x[a:b] for a, b in zip(cuts, cuts[1:]) if a < len(x)]


@pytest.mark.cuda
def test_stream_output_independent_of_push_split(cuda):
    """An M2 stream on the card (full width, timo labels, per-frame noise
    gain, chunk 4) gives the same output however its pushes are split: in
    this configuration every frame's block EM is its own (no residual
    floor, no adaptive budget), so tick boundaries change nothing, and at
    4 frames a chunk the overlap-add sums in frame order."""
    from guided_vae_nmf_torch.streaming import StreamingM2Enhancer

    m2 = _stream_m2(cuda)
    kw = dict(label_mode="timo", noise_gain=True, soft_guidance=True,
              chunk_frames=4, device=cuda)
    x = _stream_signal(1, 24000)
    whole = _pushed(StreamingM2Enhancer(m2, **kw), [x])
    for sizes in ([313, 2048, 999], [100], [4096]):
        got = _pushed(StreamingM2Enhancer(m2, **kw), _pieces(x, sizes))
        assert len(got) == len(x)
        assert_allclose(got, whole, **TOL, err_msg=str(sizes))


@pytest.mark.cuda
def test_stream_card_matches_cpu(cuda):
    """The real-noise stream settings (soft guidance: no label edge; no
    adaptive budget) on the card against the CPU: PCM16 within 2 LSB."""
    from guided_vae_nmf_torch.streaming import StreamingM2Enhancer

    x = _stream_signal(2, 20000)
    pieces = _pieces(x, [1500, 3100, 700])
    card, host = (np.round(_pushed(StreamingM2Enhancer(
        _stream_m2(dev), label_mode="timo", soft_guidance=True,
        residual_tracking=True, noise_gain=True, device=dev), pieces)
        * 32768.0) for dev in (cuda, "cpu"))
    assert np.abs(card - host).max() <= 2


@pytest.mark.cuda
def test_stream_pool_lanes_match_dedicated_streams(cuda):
    """Each lane of a pool on the card (soft guidance, residual floor,
    noise gain) against a dedicated stream pushed the same pieces, within
    atol 2e-5 / rtol 1e-4; the pool launches no K1 / K2 kernel."""
    from guided_vae_nmf_torch.streaming import (
        MultiStreamM2Enhancer, StreamingM2Enhancer)

    m2 = _stream_m2(cuda)
    kw = dict(label_mode="timo", soft_guidance=True, residual_tracking=True,
              noise_gain=True, device=cuda)
    xs = [_stream_signal(10 + i, n) for i, n in enumerate((16000, 22000,
                                                          9000))]
    pieces = [_pieces(x, [900 + 700 * i, 3300]) for i, x in enumerate(xs)]
    singles = [_pushed(StreamingM2Enhancer(m2, **kw), ps) for ps in pieces]
    reset_launch_counts()
    pool = MultiStreamM2Enhancer(m2, max_streams=4, **kw)
    sids = [pool.open() for _ in xs]
    outs = {sid: [] for sid in sids}
    for r in range(max(len(ps) for ps in pieces)):
        for sid, ps in zip(sids, pieces):
            if r < len(ps):
                pool.feed(sid, ps[r])
        for sid, arr in pool.step().items():
            outs[sid].append(arr)
        for sid, ps in zip(sids, pieces):
            if r == len(ps) - 1:
                outs[sid].append(pool.flush(sid))
    for i, sid in enumerate(sids):
        got = np.concatenate(outs[sid])
        assert len(got) == len(xs[i])
        assert_allclose(got, singles[i], atol=2e-5, rtol=1e-4,
                        err_msg=f"lane {i}")
    counts = launch_counts()
    assert not any(n for v in counts.values() for n in v.values()), counts


@pytest.mark.cuda
def test_http_stream_route_on_the_card(cuda):
    """POST /v1/enhance_stream with a stream factory on the card: 200,
    X-Chunk-Frames, every sample back, within 1 LSB of the enhancer called
    directly on the card; /stats counts the stream."""
    import http.client
    import json

    from guided_vae_nmf_torch.http_serving import EnhancementHTTPServer
    from guided_vae_nmf_torch.models import VAE
    from guided_vae_nmf_torch.serving import EnhancementService, ServeConfig
    from guided_vae_nmf_torch.streaming import StreamingM2Enhancer

    m2 = _stream_m2(cuda)
    kw = dict(label_mode="timo", chunk_frames=8, keep_masks=False,
              device=cuda)
    svc = EnhancementService(
        VAE([513, 8, [16]]).eval(), cfg=MCEMConfig(niter=1), device="cpu",
        serve=ServeConfig(label_mode="none", noise_model="nmf"))
    srv = EnhancementHTTPServer(
        svc, port=0,
        stream_factory=lambda: StreamingM2Enhancer(m2, **kw)).start()
    x = _stream_signal(3, 21000)
    body = np.round(x * 32768.0).astype("<i2").tobytes()
    try:
        conn = http.client.HTTPConnection("127.0.0.1", srv.port, timeout=300)
        conn.request("POST", "/v1/enhance_stream",
                     body=iter([body[a:a + 5001]
                                for a in range(0, len(body), 5001)]),
                     headers={"Transfer-Encoding": "chunked"},
                     encode_chunked=True)
        resp = conn.getresponse()
        assert resp.status == 200
        assert resp.headers["X-Chunk-Frames"] == "8"
        got = np.frombuffer(resp.read(), "<i2").astype(np.int32)
        conn.close()
        conn = http.client.HTTPConnection("127.0.0.1", srv.port, timeout=60)
        conn.request("GET", "/stats")
        streams = json.loads(conn.getresponse().read())["streams"]
        conn.close()
    finally:
        srv.close_all()
    xq = np.frombuffer(body, "<i2").astype(np.float32) / 32768.0
    enh = StreamingM2Enhancer(m2, **kw)
    want = np.round(np.concatenate([enh.push(xq), enh.flush()]) * 32768.0)
    assert len(got) == len(x)
    assert np.abs(got - np.clip(want, -32768, 32767)).max() <= 1
    assert streams["done"] == 1 and streams["active"] == 0


# ---------------------------------------------------------------------------
# the evaluation protocol
# ---------------------------------------------------------------------------

def _speech_like(seed, seconds, snr_db=5.0, fs=16000):
    rng = np.random.RandomState(seed)
    n = int(seconds * fs)
    t = np.arange(n) / fs
    f0 = rng.uniform(100, 200) * (1 + 0.1 * np.sin(2 * np.pi * 0.4 * t))
    phase = 2 * np.pi * np.cumsum(f0) / fs
    s = sum(np.sin(k * phase) / k for k in range(1, 20))
    s *= 0.5 - 0.5 * np.cos(2 * np.pi * rng.uniform(3, 5) * t)
    noise = np.convolve(rng.randn(n), np.ones(4) / 4, mode="same")
    noise *= np.sqrt(np.mean(s**2) / np.mean(noise**2) / 10 ** (snr_db / 10))
    scale = 0.5 / np.max(np.abs(s + noise))
    return s * scale, noise * scale


@pytest.mark.cuda
def test_energy_ratios_on_the_card_match_numpy(cuda):
    from guided_vae_nmf_torch.metrics import energy_ratios, energy_ratios_torch

    rows = [_speech_like(40 + i, sec) for i, sec in enumerate((1.1, 2.3,
                                                               3.0))]
    T = max(len(s) for s, _ in rows)
    for dtype, tol in ((torch.float32, 1e-3), (torch.float64, 1e-9)):
        b = torch.zeros(3, len(rows), T, dtype=dtype)
        for i, (s, n) in enumerate(rows):
            sh = s + 0.25 * n + 0.2 * np.tanh(3 * s)
            for j, a in enumerate((sh, s, n)):
                b[j, i, :len(s)] = torch.from_numpy(a)
        got = energy_ratios_torch(*(a.to(cuda) for a in b))
        for i, (s, n) in enumerate(rows):
            ref = energy_ratios(*(b[j, i, :len(s)].double().numpy()
                                  for j in range(3)))
            for g, r in zip(got, ref):
                assert g.device.type == "cuda" and g.dtype == dtype
                assert abs(float(g[i]) - r) < tol


@pytest.mark.cuda
def test_cli_enhance_on_the_card(cuda, tmp_path):
    import os

    from guided_vae_nmf_torch import cli
    from guided_vae_nmf_torch.data import read_wav, read_wav_int16, write_wav
    from guided_vae_nmf_torch.dsp import stft
    from guided_vae_nmf_torch.pipeline import enhance_to_audio, make_labels
    from guided_vae_nmf_torch.train import load_model, load_norm_stats

    art = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "artifacts", "pretrained")
    m2_dir, cdir = (os.path.join(art, d) for d in ("M2_ibm",
                                                   "classifier_ibm"))
    src = tmp_path / "in"
    src.mkdir()
    for i, sec in enumerate((1.3, 2.2)):
        s, n = _speech_like(50 + i, sec)
        write_wav(str(src / f"u{i}.wav"), s + n, 16000)
    reset_launch_counts()
    assert cli.main(["enhance", str(src), str(tmp_path / "out") + "/",
                     "--model", m2_dir, "--classifier", cdir,
                     "--seed", "7"]) == 0
    counts = launch_counts()
    m2 = load_model(m2_dir, kind="dgm", device=cuda)
    cls = load_model(cdir, kind="classifier", device=cuda)
    mean, std = load_norm_stats(cdir)
    xs = [read_wav(str(src / f"u{i}.wav"))[0].astype(np.float32)
          for i in range(2)]
    X = [stft(x) for x in xs]
    ys = [make_labels("dnn", np.abs(Xi) ** 2, classifier=cls, mean=mean,
                      std=std)[1] for Xi in X]
    s_list, _ = enhance_to_audio(
        m2, X, [len(x) for x in xs], ys=ys,
        generator=torch.Generator(device=cuda).manual_seed(7), device=cuda)
    for i, s in enumerate(s_list):
        write_wav(str(tmp_path / f"ref{i}.wav"), s, 16000)
        got = read_wav_int16(str(tmp_path / "out" / f"u{i}_enhanced.wav"))
        ref = read_wav_int16(str(tmp_path / f"ref{i}.wav"))
        assert torch.equal(torch.from_numpy(got[0]),
                           torch.from_numpy(ref[0]))
    assert (counts["mh_chain"]["e_wh"], counts["mh_chain"]["wf_wh"],
            counts["nmf_sums"]["h_wh"], counts["nmf_sums"]["g_wh"]) == (
        100, 1, 100, 100)


@pytest.mark.cuda
def test_metric_pool_from_a_process_with_a_cuda_context(cuda, tmp_path):
    import os

    from guided_vae_nmf_torch.data import write_dataset, write_wav
    from guided_vae_nmf_torch.metrics import runner

    torch.ones(1, device=cuda).sum().item()      # this process holds one
    assert torch.cuda.is_initialized()
    rel = os.path.join("CSR-1-WSJ-0", "WAV", "wsj0", "si_et_05", "440")
    raw, proc = tmp_path / "raw", tmp_path / "processed"
    for i in range(2):
        s, n = _speech_like(60 + i, 1.2)
        for d in (raw, proc):
            (d / rel).mkdir(parents=True, exist_ok=True)
        write_wav(str(raw / rel / f"u{i}.wav"), s, 16000)
        for tag, sig in (("s", s), ("n", n), ("x", s + n)):
            write_wav(str(proc / rel / f"u{i}_{tag}.wav"), sig, 16000)
    write_dataset([0.0, 0.0], str(proc), "test", "snr_db")
    keys, rows, _, _ = runner.run_metrics(str(raw) + "/", str(proc) + "/",
                                          mixture_floor=True, max_workers=2)
    assert len(rows) == 2 and all(np.all(np.isfinite(r)) for r in rows)
    with runner.metrics_pool(1) as ex:
        assert ex.submit(os.getenv, "CUDA_VISIBLE_DEVICES").result() == ""
        assert ex.submit(torch.cuda.device_count).result() == 0
        assert ex.submit(torch.cuda.is_initialized).result() is False


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

TRAIN_DIMS = {"m1": [513, 32, [128, 128]], "m2": [513, 513, 32, [128, 128]],
              "classifier": [513, [128, 128], 513],
              "wiener": [513, [128] * 5, 513]}


def _train_batch(family, n=128, seed=0):
    """Well-scaled frames: gamma power for M1 / M2, standardized frames
    for the classifier and the Wiener DNN."""
    rng = np.random.RandomState(seed)
    x = rng.gamma(0.7, 1.0, (n, 513)).astype(np.float32)
    if family in ("classifier", "wiener"):
        x = ((x - 0.7) / 0.84).astype(np.float32)
    y = (rng.rand(n, 513) > 0.7).astype(np.float32)
    if family == "wiener":
        y = rng.uniform(0, 1, (n, 513)).astype(np.float32)
    return x, (None if family == "m1" else y)


def _init(family, seed=0):
    from guided_vae_nmf_torch import models

    g = torch.Generator().manual_seed(seed)
    if family == "m1":
        return models.vae_init(g, TRAIN_DIMS[family])
    if family == "m2":
        return models.dgm_init(g, TRAIN_DIMS[family])
    return models.classifier_init(g, TRAIN_DIMS[family])


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["m1", "m2", "classifier", "wiener"])
def test_train_step_card_matches_cpu(cuda, family):
    """One Adam step at full width with z = mu (TF32 off): the loss within
    rtol 1e-5 and every gradient within rtol 1e-4 (atol 1e-5 of its
    largest element) of the CPU's; the weights after the step within 2 lr
    (Adam's first step moves a weight by lr g / (|g| + eps): about lr
    whatever |g| is, so a gradient at rounding level may move it the other
    way), with at most 0.1 % of them more than 1e-6 apart."""
    import copy

    from guided_vae_nmf_torch.train import trainer as tt

    x, y = _train_batch(family)
    out = {}
    for tag, dev in (("cpu", torch.device("cpu")), ("card", cuda)):
        m = copy.deepcopy(_init(family)).to(dev)
        leaves = tt._trainable(m)
        for _, t in leaves:
            t.requires_grad_(True)
        opt = tt.make_optimizer(tt.TrainConfig(), [t for _, t in leaves])
        batch = (torch.from_numpy(x).to(dev),
                 None if y is None else torch.from_numpy(y).to(dev))
        loss, _ = tt.LOSSES[family](m, batch, None, 1e-8)
        opt.zero_grad()
        loss.backward()
        grads = {k: t.grad.cpu().numpy().copy() for k, t in leaves}
        opt.step()
        out[tag] = (float(loss.detach()), grads,
                    {k: t.detach().cpu().numpy() for k, t in leaves})
    (lc, gc, pc), (lg, gg, pg) = out["cpu"], out["card"]
    assert np.isfinite(lg)
    assert_allclose(lg, lc, rtol=1e-5)
    for k in gc:
        scale = float(np.abs(gc[k]).max())
        assert_allclose(gg[k], gc[k], rtol=1e-4, atol=1e-5 * scale,
                        err_msg=k)
    diff = np.concatenate([np.abs(pg[k] - pc[k]).ravel() for k in pc])
    lr = tt.TrainConfig().learning_rate
    assert diff.max() <= 2 * lr, diff.max()
    assert np.mean(diff > 1e-6) <= 1e-3, (int(np.sum(diff > 1e-6)),
                                          diff.size, diff.max())


@pytest.mark.cuda
def test_fit_on_the_card_leaves_load_model_frozen(cuda, tmp_path):
    import os

    from guided_vae_nmf_torch.train import TrainConfig, fit, load_model

    art = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "artifacts", "pretrained")
    m2 = load_model(os.path.join(art, "M2_ibm"), kind="dgm", device=cuda)
    before = {k: v.clone() for k, v in m2.state_dict().items()}
    x, y = _train_batch("m2", n=256)
    trained, hist = fit(m2, "m2", (x, y), (x[:128], y[:128]),
                        TrainConfig(end_epoch=1), str(tmp_path), "M2",
                        device=cuda)
    assert np.isfinite(hist[0]["train"])
    for k, v in m2.state_dict().items():
        assert not v.requires_grad and torch.equal(v, before[k]), k
    for mod in (m2, trained):
        assert not any(p.requires_grad for p in mod.parameters())
        assert mod.encoder.hidden[0].w.cpu().numpy().shape == (1026, 128)
    assert trained.encoder.hidden[0].w.is_cuda


@pytest.mark.cuda
def test_card_resume_state_resumes_on_the_cpu(cuda, tmp_path):
    """2 epochs on the card, the 3rd resumed on the CPU, against 3 epochs
    resumed on the card: epoch-3 losses within rtol 1e-4, weights within
    atol 1e-5."""
    import shutil

    from guided_vae_nmf_torch.train import TrainConfig, fit

    x, y = _train_batch("classifier", n=640, seed=1)
    va = (x[:256], y[:256])
    first = str(tmp_path / "card")
    fit(_init("classifier"), "classifier", (x, y), va,
        TrainConfig(end_epoch=2), first, "C", device=cuda)
    second = str(tmp_path / "cpu")
    shutil.copytree(first, second)
    got, h_cpu = fit(_init("classifier"), "classifier", (x, y), va,
                     TrainConfig(end_epoch=3), second, "C", resume=True,
                     device="cpu")
    ref, h_card = fit(_init("classifier"), "classifier", (x, y), va,
                      TrainConfig(end_epoch=3), first, "C", resume=True,
                      device=cuda)
    assert [h["epoch"] for h in h_cpu] == [h["epoch"] for h in h_card] == [3]
    assert_allclose([h_cpu[0]["train"], h_cpu[0]["valid"]],
                    [h_card[0]["train"], h_card[0]["valid"]], rtol=1e-4)
    for (k, a), b in zip(got.state_dict().items(),
                         ref.state_dict().values()):
        assert_allclose(a.numpy(), b.cpu().numpy(), rtol=0, atol=1e-5,
                        err_msg=k)


# -- reference .pt import, the warm-up and device_time_ms on the card --------

def _shipped(name):
    import os

    return os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "artifacts", "pretrained", name)


@pytest.mark.cuda
def test_pt_models_equal_the_npz_ones_on_the_card(cuda, tmp_path):
    """`.pt` state dicts in the reference naming (M2 by `export_vae`, the
    classifier by hand) load on the card to the `.ckpt.npz` modules, and a
    1 s utterance enhances to the same PCM with either pair."""
    from guided_vae_nmf_torch.dsp import pad_signal_for_stft
    from guided_vae_nmf_torch.models import export_vae
    from guided_vae_nmf_torch.pipeline import enhance_waveform
    from guided_vae_nmf_torch.train import load_model, load_norm_stats

    m2 = load_model(_shipped("M2_ibm"), kind="dgm", device=cuda)
    cls = load_model(_shipped("classifier_ibm"), kind="classifier",
                     device=cuda)
    torch.save({k: torch.from_numpy(v) for k, v in export_vae(m2).items()},
               tmp_path / "m2.pt")
    sd = {}
    for i, layer in enumerate(cls.hidden):
        sd[f"hidden.{i}.weight"] = layer.w.detach().T.cpu()
        sd[f"hidden.{i}.bias"] = layer.b.detach().cpu()
    sd["output_layer.weight"] = cls.out.w.detach().T.cpu()
    sd["output_layer.bias"] = cls.out.b.detach().cpu()
    torch.save(sd, tmp_path / "cls.pt")
    m2_pt = load_model(str(tmp_path / "m2.pt"), kind="dgm", device=cuda)
    cls_pt = load_model(str(tmp_path / "cls.pt"), kind="classifier",
                        device=cuda)
    for a, b in ((m2, m2_pt), (cls, cls_pt)):
        sa, sb = a.state_dict(), b.state_dict()
        assert sorted(sa) == sorted(sb)
        assert all(sb[k].device.type == cuda.type and torch.equal(sa[k], sb[k])
                   for k in sa)
    mean, std = load_norm_stats(_shipped("classifier_ibm"))
    s, n = _speech_like(70, 1.0)
    xp, nf = pad_signal_for_stft(np.round((s + n) * 32767).astype(np.int16))
    x_b = np.zeros((1, (128 - 1) * 256 + 1024), np.int16)
    x_b[0, :min(len(xp), x_b.shape[1])] = xp[:x_b.shape[1]]
    mask = (np.arange(128)[None] < nf).astype(np.float32)
    cfg = MCEMConfig(niter=5)
    outs = [enhance_waveform(m, x_b, mask, cfg, classifier=c, mean=mean,
                             std=std, label_mode="dnn", device=cuda,
                             generator=torch.Generator(
                                 device=cuda).manual_seed(3))[0]
            for m, c in ((m2, cls), (m2_pt, cls_pt))]
    assert torch.equal(outs[0], outs[1])


@pytest.mark.cuda
def test_device_warmup_runs_and_refuses_a_bad_index(cuda):
    from guided_vae_nmf_torch.utils import device_warmup

    assert device_warmup(cuda) is None
    assert device_warmup("cuda:0") is None
    with pytest.raises(RuntimeError):
        device_warmup(f"cuda:{torch.cuda.device_count()}")


@pytest.mark.cuda
def test_device_time_ms_sees_k1_launches(cuda):
    from guided_vae_nmf_torch.ops import device_time_ms

    c = chain_case(cuda, 12, **SMALL)
    noise = decisive_noise(cuda, 13, SMALL["B"], SMALL["N"], SMALL["L"], 5)

    def two_chains():
        return [run_chain(mh_chain, c, mode, 3, 2, 0.01, noise=noise)
                for mode in ("e", "wf")]

    total, table = device_time_ms(two_chains)
    k1 = [(ms, n) for ms, n, name in table if "mh_chain_kernel" in name]
    assert sum(n for _, n in k1) == 2
    assert 0 < sum(ms for ms, _ in k1) <= total <= sum(r[0] for r in table)


# ---------------------------------------------------------------------------
# Multi-device: a virtual mesh of two shards on the one card
# ---------------------------------------------------------------------------


def _virtual_mesh(cuda, n=2):
    from guided_vae_nmf_torch.parallel import make_mesh

    return make_mesh(devices=[cuda] * n)


@pytest.mark.cuda
def test_virtual_mesh_fused_shards_equal_their_rows(cuda):
    """Each shard of `sharded_mcem_fused` (its own thread and stream) is
    the fused engine on its rows with its first row's generator, bit for
    bit, and launched K1 / K2 once an E chain and sums pass in its own
    thread (`mesh.shard_launches`)."""
    from guided_vae_nmf_torch.parallel import sharded_mcem_fused

    dims = SMALL
    rng = np.random.RandomState(31)
    model = module_from_params(random_dgm(rng, dims["F"], dims["Y"],
                                          dims["L"], dims["H"]), device=cuda)
    B, F, N = 4, dims["F"], dims["N"]
    t = lambda a: torch.tensor(a, device=cuda)  # noqa: E731
    X = t(rng.uniform(0.05, 1.05, (B, F, N)).astype(np.float32))
    y = t((rng.uniform(size=(B, dims["Y"], N)) > 0.5).astype(np.float32))
    mask = torch.ones((B, N), device=cuda)
    cfg = MCEMConfig(niter=3, nsamples_E_step=2, burnin_E_step=1,
                     nsamples_WF=2, burnin_WF=1, nmf_rank=dims["K"])
    seeds = [5, 6, 7, 8]
    mesh = _virtual_mesh(cuda)
    reset_launch_counts()
    out = sharded_mcem_fused(mesh, model, X, mask, y, seeds, cfg)
    per = {"mh_chain": {"e_wh": 3, "wf_wh": 1},
           "nmf_sums": {"h_wh": 3, "g_wh": 3}}
    assert mesh.shard_launches == [per, per]
    for lo in (0, 2):
        s = slice(lo, lo + 2)
        ref = mcem_batch_fused(model, X[s], mask[s], y[s],
                               torch.Generator(device=cuda).manual_seed(
                                   seeds[lo]), cfg)
        for k in ("WFs", "WFn", "W", "H", "g", "Z"):
            assert torch.equal(out[k][s], ref[k]), k


@pytest.mark.cuda
def test_virtual_mesh_eager_equals_unsharded(cuda):
    """The eager engine's rows are their own (float64 EM): the batch split
    over two shard threads equals the unsharded batch bit for bit."""
    from guided_vae_nmf_torch.mcem.engine import mcem_m2_batch
    from guided_vae_nmf_torch.parallel import sharded_mcem_m2

    dims = SMALL
    rng = np.random.RandomState(32)
    model = module_from_params(random_dgm(rng, dims["F"], dims["Y"],
                                          dims["L"], dims["H"]), device=cuda)
    B, F, N = 5, dims["F"], 48
    t = lambda a: torch.tensor(a, device=cuda)  # noqa: E731
    X = t(rng.uniform(0.05, 1.05, (B, F, N)).astype(np.float32))
    y = t((rng.uniform(size=(B, dims["Y"], N)) > 0.5).astype(np.float32))
    mask = torch.ones((B, N), device=cuda)
    cfg = MCEMConfig(niter=3, nsamples_E_step=2, burnin_E_step=2,
                     nsamples_WF=2, burnin_WF=2, nmf_rank=3)
    seeds = list(range(10, 10 + B))
    ref = mcem_m2_batch(model, X, mask, y, seeds, cfg)
    out = sharded_mcem_m2(_virtual_mesh(cuda), model, X, mask, y, seeds, cfg)
    for k in ref:
        assert torch.equal(out[k], ref[k]), k


@pytest.mark.cuda
def test_virtual_mesh_frame_sharded_var0(cuda):
    """One recording's frames over two shards (their W / cost sums in the
    in-process group) against single-device mcem_run at var_RW = 0."""
    from guided_vae_nmf_torch.mcem.engine import mcem_run
    from guided_vae_nmf_torch.parallel import frame_sharded_mcem

    dims = SMALL
    rng = np.random.RandomState(33)
    model = module_from_params(random_dgm(rng, dims["F"], dims["Y"],
                                          dims["L"], dims["H"]), device=cuda)
    F, N = dims["F"], 256
    X = torch.tensor(rng.uniform(0.05, 1.05, (F, N)).astype(np.float32),
                     device=cuda)
    y = torch.tensor((rng.uniform(size=(dims["Y"], N)) > 0.5)
                     .astype(np.float32), device=cuda)
    mask = torch.ones(N, device=cuda)
    cfg = MCEMConfig(niter=4, nsamples_E_step=2, burnin_E_step=2,
                     nsamples_WF=2, burnin_WF=2, nmf_rank=3, var_RW=0.0)
    out = frame_sharded_mcem(_virtual_mesh(cuda), model, X, mask, y, 9, cfg)
    ref = mcem_run(model, X[None], mask[None], y[None], [9], cfg)
    for k in ("WFs", "WFn", "g", "W", "H", "cost"):
        assert_allclose(out[k].cpu().numpy(), ref[k][0].cpu().numpy(),
                        rtol=2e-4, atol=1e-6, err_msg=k)


@pytest.mark.cuda
def test_data_parallel_step_on_the_card(cuda, tmp_path):
    """An M2 epoch on a virtual mesh of one shard equals the single-device
    epoch bit for bit, on two within 1e-5 (the order of the gradient
    sums)."""
    from guided_vae_nmf_torch.train import TrainConfig, train_m2

    rng = np.random.RandomState(34)
    X = (rng.rand(512, 65) * 2).astype(np.float32)
    Y = (rng.rand(512, 10) > 0.5).astype(np.float32)
    cfg = TrainConfig(batch_size=128, end_epoch=1)
    dims = (65, 10, 8, (32,))
    base, _ = train_m2((X, Y), (X[:128], Y[:128]), dims=dims, cfg=cfg,
                       model_dir=str(tmp_path / "a"), device=cuda)
    want = dict(base.named_parameters())
    for n in (1, 2):
        dp, _ = train_m2((X, Y), (X[:128], Y[:128]), dims=dims, cfg=cfg,
                         model_dir=str(tmp_path / f"m{n}"),
                         mesh=_virtual_mesh(cuda, n))
        for k, p in dp.named_parameters():
            if n == 1:
                assert torch.equal(p, want[k]), k
            else:
                assert_allclose(p.cpu().numpy(), want[k].cpu().numpy(),
                                atol=1e-5, err_msg=k)


# the long recording's frames: bench_long's 30 minutes bucketed as the
# sweep buckets them (pipeline.bucket_frames)
LONG_N = (30 * 60 * 16000 // 256 + 1 + 127) // 128 * 128


def _close_on_card(got, ref, what):
    """TOL, checked on the card (the arrays are GBs on the host)."""
    got, ref = got.float(), ref.float()
    bad = (got - ref).abs() > TOL["atol"] + TOL["rtol"] * ref.abs()
    n = int(bad.sum())
    assert n == 0, (f"{what}: {n} of {bad.numel()} elements past {TOL}, "
                    f"max abs err {float((got - ref).abs().max())}")


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["e", "wf"])
def test_long_recording_chain_and_sums_match_plain(cuda, mode):
    """K1c and K2c as bench_long runs them (fast mode, NMF factors) at
    the 30-minute recording's bucketed N = 112,512 frames in one launch,
    against their plain versions on the card: every global offset of
    both kernels is formed in 64 bits (the bfloat16 sample buffer alone is
    10 x 112,512 x 513 x 2 B = 1.15 GB). Then the 'h' and 'g' sums over
    the chain's own dump."""
    assert LONG_N == 112512
    c = chain_case(cuda, 51, B=1, F=513, N=LONG_N, L=32, H=128, K=10,
                   Y=513)
    nsamples, burnin = 10, 2
    noise = decisive_noise(cuda, 52, 1, LONG_N, 32, nsamples + burnin)
    kw = dict(FAST["fast"], noise=noise)
    ref = run_chain(mh_chain_ref, c, mode, nsamples, burnin, 0.01, **kw)
    got = run_chain(mh_chain, c, mode, nsamples, burnin, 0.01, **kw)
    torch.cuda.synchronize()
    _close_on_card(got[0], ref[0], "Z")
    _close_on_card(got[1], ref[1], "Vs")
    for i, (a, b) in enumerate(zip(got[2], ref[2])):
        assert a.shape == b.shape and a.dtype == b.dtype
        _close_on_card(a, b, f"out[{i}]")
    if mode == "wf":
        return
    samples = got[2][0]
    assert samples.shape == (1, nsamples, LONG_N, 513)
    for smode in ("h", "g"):
        args = (samples, c["WH"], c["g"], c["X2"])
        for i, (a, b) in enumerate(zip(
                nmf_sums(*args, mode=smode, approx_recip=True),
                nmf_sums_ref(*args, mode=smode))):
            _close_on_card(a, b, f"{smode}[{i}]")


@pytest.mark.cuda
def test_bench_long_runs_repeat_on_the_card(cuda, tmp_path):
    """bench_long at 2 minutes (7,501 frames, bucketed to 7,552): the warm
    run's wavs equal the cold run's byte for byte (K1's contract makes a
    run deterministic), each run 100 / 1 / 100 / 100 K1c / K2c launches."""
    import os

    from chip_smoke import speech_like_mixtures, write_eval_root
    from guided_vae_nmf_torch.scripts import bench_long

    write_eval_root(speech_like_mixtures(3, (2.0, 3.0)), str(tmp_path))
    work = str(tmp_path / "work")
    reset_launch_counts()
    row = bench_long.main(["--minutes", "2", "--work", work, "--data_root",
                           str(tmp_path)])
    assert row["frames"] == 7501 and row["backend"] == "cuda"
    assert nonzero(launch_counts()) == {
        "mh_chain": {"e_wh_fast": 200, "wf_wh_fast": 2},
        "nmf_sums": {"h_wh_fast": 200, "g_wh_fast": 200}}
    base = os.path.splitext(bench_long.REL)[0]
    for tag in ("_s_est.wav", "_n_est.wav"):
        with open(os.path.join(work, "est", base + tag), "rb") as a, \
                open(os.path.join(work, "est2", base + tag), "rb") as b:
            assert a.read() == b.read(), tag
