"""The port's dynamic-batching service (guided_vae_nmf_torch/serving.py) on
the CPU, mirroring tests/test_serving.py: the submit / enhance contract,
length bucketing and coalescing under the wait window, concurrent
producers, close, bad input, backpressure and configuration checks, fast
and spp2 serving, and one request through the port's service and the JAX
package's (fused engine, Pallas interpreter) at var_RW=0 with the 'spp'
noise model, where neither draws anything at random: within 2 PCM16 LSB
(float32 STFT / ISTFT of two FFT libraries, then rounding)."""

import dataclasses
import sys
import threading

import jax
import numpy as np
import pytest
import torch

import guided_vae_nmf_torch.serving as serving
from guided_vae_nmf_tpu.mcem import MCEMConfig as JaxConfig
from guided_vae_nmf_tpu.models import classifier_init, dgm_init, vae_init
from guided_vae_nmf_tpu.serving import EnhancementService as JaxService
from guided_vae_nmf_tpu.serving import ServeConfig as JaxServeConfig
from guided_vae_nmf_torch.mcem import MCEMConfig
from guided_vae_nmf_torch.models import module_from_params
from guided_vae_nmf_torch.serving import (
    EnhancementService,
    QueueFullError,
    ServeConfig,
)

torch.set_num_threads(2)

F, L, H = 513, 8, 16
SMALL = dict(niter=2, nsamples_E_step=2, burnin_E_step=1, nsamples_WF=2,
             burnin_WF=1, nmf_rank=2)
CFG = MCEMConfig(**SMALL)
SV = ServeConfig(label_mode="none", noise_model="nmf", max_wait_ms=50.0)


@pytest.fixture(scope="module")
def m1():
    return module_from_params(vae_init(jax.random.PRNGKey(0), [F, L, [H]]))


def _service(model, serve=SV, cfg=CFG):
    return EnhancementService(model, cfg=cfg, serve=serve, device="cpu")


def _wav(seed, seconds):
    r = np.random.RandomState(seed)
    return (0.1 * r.randn(int(16000 * seconds))).astype(np.float32)


def _consistent(x, out):
    assert out["s"].shape == x.shape and out["s"].dtype == np.float32
    assert np.all(np.isfinite(out["s"]))
    # the Wiener gains partition the mixture: s + n = x up to PCM16 rounding
    np.testing.assert_allclose(out["s"] + out["n"], x, atol=3.0 / 32768.0)


def test_submit_roundtrip_and_mixture_consistency(m1):
    with _service(m1) as svc:
        xs = [_wav(1, 0.4), _wav(2, 0.9), _wav(3, 0.6)]
        futs = [svc.submit(x) for x in xs]
        for x, f in zip(xs, futs):
            _consistent(x, f.result(timeout=300))
        st = svc.stats()
        assert st["requests"] == 3 and st["batches"] >= 1
        assert 0 < st["p50_s"] <= st["p95_s"] <= st["max_s"]


def test_bucketing_splits_length_groups(m1):
    """0.3 s and 8 s (buckets 128 and 512: 75 % waste) run apart."""
    with _service(m1, dataclasses.replace(SV, max_wait_ms=1000.0)) as svc:
        f1, f2 = svc.submit(_wav(4, 0.3)), svc.submit(_wav(5, 8.0))
        o1, o2 = f1.result(timeout=600), f2.result(timeout=600)
        assert o1["batch_size"] == 1 and o2["batch_size"] == 1
        assert svc.stats()["batches"] == 2


def test_coalescing_merges_adjacent_buckets(m1):
    """1.9 s and 3.9 s (buckets 128 and 256: 50 % waste) merge into one
    batch under max_pad_waste=0.5 and split with coalescing off."""
    slow = dataclasses.replace(SV, max_wait_ms=1000.0)
    with _service(m1, slow) as svc:
        f1, f2 = svc.submit(_wav(4, 1.9)), svc.submit(_wav(5, 3.9))
        o1, o2 = f1.result(timeout=600), f2.result(timeout=600)
        assert o1["batch_size"] == 2 and o2["batch_size"] == 2
        assert svc.stats()["batches"] == 1
        assert o1["s"].shape == (int(16000 * 1.9),)
        assert np.all(np.isfinite(o1["s"]))
    with _service(m1, dataclasses.replace(slow, max_pad_waste=0.0)) as svc:
        f1, f2 = svc.submit(_wav(4, 1.9)), svc.submit(_wav(5, 3.9))
        f1.result(timeout=600), f2.result(timeout=600)
        assert svc.stats()["batches"] == 2


def test_plan_groups_respects_max_batch(m1):
    with _service(m1, dataclasses.replace(SV, max_batch=2,
                                          batch_lattice=(1, 2))) as svc:
        reqs = [serving._Request(x=np.zeros(1), n_frames=n)
                for n in (100, 200, 250, 90)]
        plans = svc._plan_groups(reqs)
    assert [n for n, _ in plans] == [256, 128]
    assert [[r.n_frames for r in rs] for _, rs in plans] == [[200, 250],
                                                             [100, 90]]


def test_concurrent_producers(m1):
    """More producer threads than cores, with a short switch interval: every
    request resolves and the request counter loses no update."""
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        with _service(m1) as svc:
            outs = {}

            def client(i):
                outs[i] = svc.enhance(_wav(10 + i, 0.3))

            ts = [threading.Thread(target=client, args=(i,))
                  for i in range(12)]
            for t in ts:
                t.start()
            for t in ts:
                t.join(300)
            assert not any(t.is_alive() for t in ts)
            assert len(outs) == 12
            assert all(np.all(np.isfinite(o["s"])) for o in outs.values())
            st = svc.stats()
            assert st["requests"] == 12
            assert st["mean_batch"] > 1            # requests shared batches
    finally:
        sys.setswitchinterval(old)


def test_close_rejects_new_submits(m1):
    svc = _service(m1)
    svc.submit(_wav(20, 0.3)).result(timeout=300)
    svc.close()
    svc.close()                              # idempotent
    with pytest.raises(RuntimeError, match="closed"):
        svc.submit(_wav(21, 0.3))
    assert not svc._worker.is_alive() and not svc._fetcher.is_alive()


def test_bad_input_rejected(m1):
    with _service(m1) as svc:
        for bad in (np.zeros((2, 100), np.float32), np.zeros(0, np.float32)):
            with pytest.raises(ValueError):
                svc.submit(bad)
        nan = np.zeros(1000, np.float32)
        nan[3] = np.nan
        with pytest.raises(ValueError):
            svc.submit(nan)


def test_queue_backpressure(m1):
    tight = dataclasses.replace(SV, max_wait_ms=2000.0, max_queue=2)
    with _service(m1, tight) as svc:
        futs, raised = [], False
        # the collector may take the first requests before the flood lands
        for i in range(20):
            try:
                futs.append(svc.submit(_wav(i, 0.3)))
            except QueueFullError:
                raised = True
                break
        assert raised, "max_queue=2 never tripped over 20 rapid submits"
        for f in futs:
            assert np.all(np.isfinite(f.result(timeout=300)["s"]))


@pytest.mark.parametrize("bad,exc", [
    (dict(max_batch=32), ValueError),            # > lattice max (16)
    (dict(batch_lattice=(4, 2, 1)), ValueError),  # not increasing
    (dict(batch_lattice=()), ValueError),        # empty lattice
    (dict(noise_model="ssp"), ValueError),       # typo'd noise model
    (dict(fast="1"), ValueError),                # no such fast level
    (dict(label_mode="oracle"), ValueError),     # needs clean speech
    (dict(bucket_multiple=100), ValueError),     # not a multiple of 16
    (dict(engine="eager"), ValueError),
])
def test_serveconfig_rejected_at_init(m1, bad, exc):
    with pytest.raises(exc):
        _service(m1, dataclasses.replace(SV, **bad))


def test_mesh_and_missing_classifier_rejected(m1):
    from guided_vae_nmf_torch.parallel import make_mesh

    # the largest lattice entry (8) must divide by the mesh's data axis
    with pytest.raises(ValueError, match="mesh"):
        EnhancementService(m1, cfg=CFG, serve=SV,
                           mesh=make_mesh(devices=["cpu"] * 3))
    with pytest.raises(TypeError, match="Mesh"):
        EnhancementService(m1, cfg=CFG, serve=SV, mesh=object(),
                           device="cpu")
    with pytest.raises(ValueError, match="classifier"):
        _service(m1, dataclasses.replace(SV, label_mode="dnn"))


def test_service_needs_a_gpu_unless_told(m1, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        EnhancementService(m1, cfg=CFG, serve=SV)


@pytest.mark.parametrize("fast", [True, "trans"])
def test_fast_serving(m1, fast):
    """fast mode rides the serving config; the Wiener partition holds."""
    with _service(m1, dataclasses.replace(SV, fast=fast,
                                          noise_model="spp")) as svc:
        x = _wav(30, 0.7)
        _consistent(x, svc.enhance(x))


def test_spp2_noise_gain_serving(m1):
    """spp2 with the noise gain: finite, mixture-consistent, and different
    from single-pass spp; the gain with 'nmf' is refused at construction."""
    cfg = dataclasses.replace(CFG, noise_gain=True)
    x = _wav(11, 0.5)
    outs = {}
    for nm in ("spp2", "spp"):
        with _service(m1, dataclasses.replace(SV, noise_model=nm),
                      cfg) as svc:
            outs[nm] = svc.enhance(x)
        _consistent(x, outs[nm])
    assert not np.array_equal(outs["spp2"]["s"], outs["spp"]["s"])
    with pytest.raises(ValueError, match="noise_gain"):
        _service(m1, SV, cfg)


def test_warmup_runs_the_lattice_and_resets(m1):
    with _service(m1) as svc:
        assert svc.warmup(buckets=(128,), batch_sizes=(1, 2)) > 0
        assert svc.stats()["requests"] == 3 and svc.stats()["batches"] == 2
        svc.reset_stats()
        assert svc.stats() == {"requests": 0, "batches": 0}


def test_service_matches_jax_service():
    """One request through both services (dnn labels, 'spp', var_RW=0)."""
    tree = dgm_init(jax.random.PRNGKey(0), [F, F, L, [H, H]])
    cls = classifier_init(jax.random.PRNGKey(1), [F, [H, H], F])
    small = dict(SMALL, var_RW=0.0)
    x = np.sin(2 * np.pi * 180 * np.arange(14000) / 16000) * 0.3
    x = (x + 0.05 * np.random.RandomState(3).randn(len(x))).astype(
        np.float32)
    with JaxService(tree, classifier_params=cls, cfg=JaxConfig(**small),
                    serve=JaxServeConfig(engine="fused",
                                         noise_model="spp")) as svc:
        ref = svc.enhance(x)
    with EnhancementService(module_from_params(tree),
                            classifier=module_from_params(cls),
                            cfg=MCEMConfig(**small), serve=ServeConfig(),
                            device="cpu") as svc:
        got = svc.enhance(x)
    assert got["batch_size"] == ref["batch_size"] == 1
    assert np.abs(got["s"] - x).max() > 0.01      # it really enhanced
    for k in ("s", "n"):
        diff = np.abs(np.round(got[k] * 32768) - np.round(ref[k] * 32768))
        assert diff.max() <= 2, (k, diff.max())


def _serve_xla(model, xs, wait_ms):
    """Submit `xs` in order to a fresh eager-engine service (so the first
    request's id, and seed, is 1 every time); returns their results."""
    serve = dataclasses.replace(SV, engine="xla", max_wait_ms=wait_ms)
    cfg = dataclasses.replace(CFG, var_RW=0.01)
    with _service(model, serve, cfg) as svc:
        futs = [svc.submit(x) for x in xs]
        return [f.result(timeout=300) for f in futs]


def test_xla_engine_replays_alone_and_cobatched(m1):
    """ServeConfig(engine='xla'): a request served alone and co-batched
    with two others (one of them in the next length bucket, so the batch
    pads further) gives PCM within 1 LSB, since each row draws from its
    own seed; the noise track is the device's, s + n = x within 3 LSB."""
    x = _wav(21, 0.7)
    alone = _serve_xla(m1, [x], 50.0)[0]
    mixed = _serve_xla(m1, [x, _wav(22, 1.9), _wav(23, 0.5)], 2000.0)
    assert alone["batch_size"] == 1 and mixed[0]["batch_size"] == 3
    assert np.abs(alone["s"] - mixed[0]["s"]).max() * 32768 <= 1.0
    _consistent(x, alone)
    # served second, x has another seed: the draws matter at var_RW=0.01
    other = _serve_xla(m1, [_wav(24, 0.3), x], 2000.0)[1]
    assert np.abs(other["s"] - alone["s"]).max() * 32768 > 1.0
