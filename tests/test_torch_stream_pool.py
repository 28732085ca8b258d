"""The port's multi-stream pool (`MultiStreamM2Enhancer`), its thread-safe
driver (`StreamPoolDriver`, `PooledStreamSession`) on the CPU: each pooled
stream against a dedicated `StreamingM2Enhancer` and against the JAX
package's pool fed the same samples, and every property that the JAX
package's tests/test_streaming.py pins for its pool (slot lifecycle,
co-drain, empty flush, resident-row views, bounded-memory trim, the
driver's concurrency, fail-fast, slot release on a failed flush, churn).

Tolerance: atol 2e-5 / rtol 1e-4 (the JAX package's own for pool against
single: the batched products may round differently at other lane counts)."""

import functools
import threading

import jax
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

import guided_vae_nmf_tpu.streaming as J
from guided_vae_nmf_tpu.models import classifier_init, dgm_init
from guided_vae_nmf_torch.models import module_from_params
from guided_vae_nmf_torch.streaming import (
    MultiStreamM2Enhancer,
    PooledStreamSession,
    StreamingM2Enhancer,
    StreamPoolDriver,
)

torch.set_num_threads(2)

TOL = dict(atol=2e-5, rtol=1e-4)
KW = dict(label_mode="timo", chunk_frames=4, context_frames=12,
          block_iters=2, e_steps=2)


@functools.lru_cache(maxsize=None)
def _dgm():
    return dgm_init(jax.random.PRNGKey(0), [513, 513, 8, [32]])


@functools.lru_cache(maxsize=None)
def _m2():
    return module_from_params(_dgm())


def _signal(seed, n):
    rng = np.random.RandomState(seed)
    t = np.arange(n) / 16000
    s = 0.1 * np.sin(2 * np.pi * np.cumsum(
        120 + (20 + 10 * seed) * np.sin(2 * np.pi * 0.9 * t)) / 16000)
    s *= np.clip(np.sin(2 * np.pi * 1.5 * t + seed), 0, None)
    return (s + 0.03 * rng.randn(n)).astype(np.float32)


def _pool(max_streams, **kw):
    return MultiStreamM2Enhancer(_m2(), max_streams=max_streams,
                                 device="cpu", **dict(KW, **kw))


def _single(x, step, **kw):
    enh = StreamingM2Enhancer(_m2(), device="cpu", **dict(KW, **kw))
    parts = [enh.push(x[lo:lo + step]) for lo in range(0, len(x), step)]
    parts.append(enh.flush())
    return np.concatenate(parts)


def _interleaved(pool, sigs, seed):
    """Feed every live stream a ragged piece a round, step, flush and
    close the streams as they run out; returns each stream's output."""
    sids = [pool.open() for _ in sigs]
    outs = {sid: [] for sid in sids}
    pos = [0] * len(sigs)
    rng = np.random.RandomState(seed)
    live = set(range(len(sigs)))
    while live:
        for i in sorted(live):
            n = int(rng.randint(1500, 5000))
            pool.feed(sids[i], sigs[i][pos[i]:pos[i] + n])
            pos[i] += n
        for sid, arr in pool.step().items():
            outs[sid].append(arr)
        for i in sorted(live):
            if pos[i] >= len(sigs[i]):
                outs[sids[i]].append(pool.flush(sids[i]))
                pool.close(sids[i])
                live.discard(i)
    return [np.concatenate(outs[sid]) for sid in sids]


@pytest.mark.parametrize("soft", [True, False])
def test_pool_matches_dedicated_streams_and_jax_pool(soft):
    sigs = [_signal(s, n) for s, n in ((1, 16000), (2, 24000), (3, 11000))]
    singles = [_single(x, 4000, soft_guidance=soft) for x in sigs]
    got = _interleaved(_pool(4, soft_guidance=soft), sigs, seed=7)
    want = _interleaved(J.MultiStreamM2Enhancer(
        _dgm(), max_streams=4, soft_guidance=soft, **KW), sigs, seed=7)
    for i, x in enumerate(sigs):
        assert len(got[i]) == len(x)
        assert_allclose(got[i], singles[i], **TOL, err_msg=f"stream {i}")
        assert_allclose(got[i], want[i], **TOL, err_msg=f"JAX, stream {i}")


def test_pool_dnn_labels_match_dedicated():
    cls = classifier_init(jax.random.PRNGKey(3), [513, [16], 513])
    kw = dict(label_mode="dnn", classifier=module_from_params(cls),
              mean=np.full((513,), 0.01, np.float32),
              std=np.full((513,), 0.02, np.float32), soft_guidance=True)
    sigs = [_signal(s, n) for s, n in ((4, 12000), (5, 16000))]
    singles = [_single(x, len(x), **kw) for x in sigs]
    pool = _pool(2, **kw)
    sids = [pool.open() for _ in sigs]
    outs = {sid: [] for sid in sids}
    for lo in range(0, 16000, 4000):
        for sid, x in zip(sids, sigs):
            pool.feed(sid, x[lo:lo + 4000])
        for sid, arr in pool.step().items():
            outs[sid].append(arr)
    for sid in sids:
        outs[sid].append(pool.flush(sid))
        pool.close(sid)
    for i, x in enumerate(sigs):
        got = np.concatenate(outs[sids[i]])
        assert len(got) == len(x)
        assert_allclose(got, singles[i], **TOL, err_msg=f"dnn stream {i}")


def test_state_views_read_resident_rows():
    pool = _pool(2)
    sid = pool.open()
    pool.feed(sid, _signal(9, 8000))
    pool.step()
    enh = pool._slot(sid)
    assert enh._ctx_valid.sum() > 0              # warm context visible
    assert enh._dstate["n_ctx"].item() == 0      # the slot's own is unused
    pool.flush(sid)
    pool.close(sid)
    sid2 = pool.open()                           # recycled row is fresh
    assert pool._slot(sid2)._ctx_valid.sum() == 0
    pool.close(sid2)


def test_slot_lifecycle():
    pool = _pool(2)
    a, b = pool.open(), pool.open()
    with pytest.raises(RuntimeError, match="full"):
        pool.open()
    x = _signal(0, 9000)
    pool.feed(a, x)
    out_a = [v for k, v in pool.step().items() if k == a]
    assert out_a and out_a[0].size > 0
    tail = pool.flush(a)
    assert np.concatenate(out_a + [tail]).shape == (len(x),)
    with pytest.raises(RuntimeError, match="twice"):
        pool.flush(a)
    with pytest.raises(RuntimeError, match="after flush"):
        pool.feed(a, x[:100])
    pool.close(a)
    with pytest.raises(KeyError):
        pool.feed(a, x[:100])                    # closed sid
    c = pool.open()                              # recycled slot
    assert c != a
    pool.feed(c, x[:5000])
    pool.step()
    assert pool.masks(c).shape[0] == 513
    pool.close(b)
    pool.close(c)


def test_flush_codrains_into_buffers_and_empty_flush():
    pool = _pool(2)
    a, b = pool.open(), pool.open()
    xa, xb = _signal(5, 7000), _signal(6, 15000)
    pool.feed(a, xa)
    pool.feed(b, xb[:12000])
    assert pool.flush(a).shape == (len(xa),)     # co-drains b's chunks
    pool.feed(b, xb[12000:])
    got_b = [pool.step().get(b, np.zeros(0, np.float32)), pool.flush(b)]
    assert np.concatenate(got_b).shape == (len(xb),)
    pool.close(a)
    pool.close(b)
    c = pool.open()
    assert pool.flush(c).size == 0               # flush without push
    pool.close(c)


def test_bounded_memory_trim_matches_untrimmed_single():
    x = _signal(12, 6 * 16000)
    single = StreamingM2Enhancer(_m2(), device="cpu", **KW)
    single.TRIM_CHUNK = 1 << 62
    want = np.concatenate([single.push(x), single.flush()])
    pool = _pool(2)
    sid = pool.open()
    s = pool._slot(sid)
    s.TRIM_CHUNK = 8192
    outs = []
    for lo in range(0, len(x), 4000):
        pool.feed(sid, x[lo:lo + 4000])
        outs.extend(pool.step().values())
    assert len(s._pad) < 8192 + 3 * 4096 + 4000
    assert s._raw.size < 8192 + 3 * 4096 + 4000
    outs.append(pool.flush(sid))
    pool.close(sid)
    got = np.concatenate(outs)
    assert len(got) == len(x)
    assert_allclose(got, want, **TOL)


def test_pool_refusals():
    from guided_vae_nmf_torch.parallel import make_mesh

    with pytest.raises(ValueError, match="multiple of the mesh"):
        MultiStreamM2Enhancer(_m2(), max_streams=3,
                              mesh=make_mesh(devices=["cpu"] * 2), **KW)
    with pytest.raises(TypeError, match="Mesh"):
        MultiStreamM2Enhancer(_m2(), mesh=object(), device="cpu", **KW)
    with pytest.raises(ValueError, match="max_streams"):
        _pool(0)
    with pytest.raises(ValueError, match="lookahead"):
        _pool(2, lookahead=True)
    with pytest.raises(ValueError, match="adaptive_iters"):
        _pool(2, adaptive_iters=3)               # the stream's own checks


def test_driver_concurrent_sessions_and_abort():
    sigs = [_signal(10 + i, 9000 + 2000 * i) for i in range(3)]
    singles = [_single(x, 2500) for x in sigs]
    driver = StreamPoolDriver(_pool(3), tick_ms=2.0)
    results, errors = {}, []

    def client(i):
        try:
            sess = PooledStreamSession(driver)
            try:
                x = sigs[i]
                parts = [sess.push(x[lo:lo + 2500])
                         for lo in range(0, len(x), 2500)]
                parts.append(sess.flush())
                results[i] = np.concatenate([p for p in parts if p.size])
            finally:
                sess.close()
        except Exception as e:          # reported below
            errors.append(repr(e))

    threads = [threading.Thread(target=client, args=(i,)) for i in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not errors and sorted(results) == [0, 1, 2]
    for i in range(3):
        assert len(results[i]) == len(sigs[i])
        assert_allclose(results[i], singles[i], **TOL,
                        err_msg=f"pooled stream {i}")

    a, b, c = (PooledStreamSession(driver) for _ in range(3))
    with pytest.raises(RuntimeError, match="full"):
        PooledStreamSession(driver)              # max_streams=3
    a.push(sigs[0][:3000])
    a.close()                                    # abort without flush
    d = PooledStreamSession(driver)              # slot recycled
    for s in (d, b, c):
        s.close()
    driver.shutdown()


def test_driver_fail_fast(monkeypatch):
    pool = _pool(2)
    driver = StreamPoolDriver(pool, tick_ms=1.0)
    sid = driver.open()

    def boom():
        raise ValueError("device exploded")

    monkeypatch.setattr(pool, "step", boom)
    with pytest.raises(RuntimeError, match="ticker died"):
        driver.push(sid, _signal(0, 8000))
    with pytest.raises(RuntimeError):            # stays failed
        driver.push(sid, np.zeros(100, np.float32))
    driver.shutdown()


def test_driver_failed_flush_releases_slot(monkeypatch):
    pool = _pool(1)
    driver = StreamPoolDriver(pool, tick_ms=1.0)
    sid = driver.open()
    driver.push(sid, _signal(1, 4000))
    real_flush = pool.flush

    def failing_flush(s):
        raise ValueError("flush failed")

    monkeypatch.setattr(pool, "flush", failing_flush)
    with pytest.raises(ValueError, match="flush failed"):
        driver.flush(sid)
    monkeypatch.setattr(pool, "flush", real_flush)
    sid2 = driver.open()                         # the slot came back
    driver.abort(sid2)
    driver.abort(sid2)                           # twice is harmless
    driver.shutdown()
    with pytest.raises(RuntimeError, match="shut down"):
        driver.push(sid2, np.zeros(10, np.float32))


def test_driver_churn_keeps_the_long_stream_exact():
    """Waves of short-lived sessions, half of them aborted, cycle through
    recycled slots while a long-lived session streams: the long stream
    equals a dedicated enhancer and every wave completes."""
    x_long = _signal(20, 30000)
    want = _single(x_long, 1500)
    driver = StreamPoolDriver(_pool(3), tick_ms=1.0)
    done, got, errors = [], {}, []

    def long_client():
        sess = PooledStreamSession(driver)
        try:
            parts = [sess.push(x_long[lo:lo + 1500])
                     for lo in range(0, len(x_long), 1500)]
            parts.append(sess.flush())
            got["long"] = np.concatenate([p for p in parts if p.size])
        finally:
            sess.close()

    def churn_client(seed):
        rng = np.random.RandomState(seed)
        try:
            for it in range(6):
                sess = PooledStreamSession(driver)
                try:
                    sess.push(_signal(100 + seed * 31 + it, 2500))
                    if rng.rand() >= 0.5:
                        sess.flush()
                    done.append(1)
                finally:
                    sess.close()
        except Exception as e:          # reported below
            errors.append(repr(e))

    threads = [threading.Thread(target=long_client)] + [
        threading.Thread(target=churn_client, args=(s,)) for s in (1, 2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in threads) and not errors
    assert len(done) == 12
    assert len(got["long"]) == len(x_long)
    assert_allclose(got["long"], want, **TOL)
    driver.shutdown()
