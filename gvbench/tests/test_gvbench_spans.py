"""The readers of the program's spans (`metrics/*_ms.sweep.py`,
`valid_frames.sweep.py`, `harness/spans.py`) on a hand-built registry and
hand-built trace events: each gives the value worked out by hand, and none
reads anything when the registry's batches are not the profiled ones or
the program has no registry."""

import sys
from types import SimpleNamespace

import pytest
import tiny  # noqa: F401  (puts the checkout on sys.path)

from gvbench.harness import spans
from gvbench.harness.layout import Layout
from guided_vae_nmf_torch.ops import profiling

READERS = ("cost_ms.sweep", "m_step_ms.sweep", "front_ms.sweep",
           "back_ms.sweep", "program_idle_ms.sweep", "valid_frames.sweep")


def _rec(i, name, parent, device_ms, **counts):
    return {"id": i, "name": name, "parent": parent, "batch": 0,
            "thread": 1, "t0": 0.0, "t1": 1.0, "host_ms": 1000.0,
            "device_ms": device_ms, "self_ms": device_ms, "counts": counts}


def _registry():
    """Two batches: (rows 2, n_pad 128, 200 valid frames) and (rows 1,
    n_pad 256, 160 valid frames); niter 2 in the first, 1 in the
    second."""
    recs = []
    for b, (rows, n_pad, valid, niter) in enumerate(
            [(2, 128, 200, 2), (1, 256, 160, 1)]):
        base = 100 * b
        recs.append(_rec(base, "gvnmf.batch", None, 50.0, rows=rows,
                         n_pad=n_pad, valid_frames=valid))
        recs.append(_rec(base + 1, "gvnmf.front", base, 1.5 + b))
        recs.append(_rec(base + 2, "gvnmf.labels", base, 0.25))
        recs.append(_rec(base + 3, "gvnmf.engine", base, 40.0, niter=niter))
        recs.append(_rec(base + 4, "gvnmf.engine.init", base + 3, 2.0))
        for it in range(niter):
            k = base + 5 + 3 * it
            recs.append(_rec(k, "gvnmf.em.e_chain", base + 3, 10.0))
            recs.append(_rec(k + 1, "gvnmf.em.m_step", base + 3, 3.0 + it))
            recs.append(_rec(k + 2, "gvnmf.em.cost", base + 3, 1.0 + b))
        recs.append(_rec(base + 50, "gvnmf.wf_chain", base + 3, 5.0))
        recs.append(_rec(base + 51, "gvnmf.back", base, 4.0 + 2 * b))
    return recs


# device intervals (us): busy 0-100, 150-300, 400-500, 520-900; gaps
# 100-150, 300-400, 500-520
DEV = [("k", 0.0, 60.0), ("k", 50.0, 100.0), ("k", 150.0, 300.0),
       ("m", 400.0, 500.0), ("k", 520.0, 700.0), ("k", 650.0, 900.0)]
# host spans: gvnmf.* over 120-140 and 280-350 (two overlapping), 510-515;
# others never count
HOST = [("gvnmf.batch", 280.0, 330.0), ("gvnmf.engine.init", 290.0, 350.0),
        ("gvnmf.front", 120.0, 140.0), ("gvnmf.back", 510.0, 515.0),
        ("aten::copy_", 100.0, 150.0), ("cudaMemcpyAsync", 300.0, 400.0)]
# idle under program spans: 120-140 (20) + 300-350 (50) + 510-515 (5)
IDLE_US = 75.0


@pytest.fixture
def registry(monkeypatch):
    recs = _registry()
    monkeypatch.setattr(profiling, "span_records", lambda: recs)
    return recs


def _ctx(n_batches=2):
    return SimpleNamespace(
        profile=SimpleNamespace(dev=list(DEV), host=list(HOST)),
        n_batches=n_batches, window_s=1.0, busy_s=0.0008)


def _read(name, ctx):
    return Layout().reader(name)(ctx)


def test_readers_by_hand(registry):
    ctx = _ctx()
    # per batch, summed over the two batches and halved
    assert _read("cost_ms.sweep", ctx) == pytest.approx(
        (1.0 + 1.0 + 2.0) / 2)
    assert _read("m_step_ms.sweep", ctx) == pytest.approx(
        (3.0 + 4.0 + 3.0) / 2)
    assert _read("front_ms.sweep", ctx) == pytest.approx(
        ((1.5 + 0.25 + 2.0) + (2.5 + 0.25 + 2.0)) / 2)
    assert _read("back_ms.sweep", ctx) == pytest.approx((4.0 + 6.0) / 2)
    assert _read("program_idle_ms.sweep", ctx) == pytest.approx(
        IDLE_US / 1e3 / 2)
    assert _read("valid_frames.sweep", ctx) == pytest.approx(
        100.0 * (200 + 160) / (2 * 128 + 1 * 256))


def test_interval_arithmetic():
    assert spans.merged([(5, 6), (0, 2), (1, 3)]) == [[0, 3], [5, 6]]
    assert spans.gaps([(0, 2), (1, 3), (5, 6), (8, 9)]) == [(3, 5), (6, 8)]
    assert spans.overlap([(0, 10)], [(2, 3), (9, 12)]) == 2.0
    assert spans.overlap([(0, 1), (4, 6)], [(0.5, 5)]) == 1.5
    assert spans.overlap([], [(0, 1)]) == 0.0


@pytest.mark.parametrize("name", READERS)
@pytest.mark.parametrize("n_batches", [1, 3])
def test_none_when_batches_differ(registry, name, n_batches):
    assert _read(name, _ctx(n_batches)) is None


@pytest.mark.parametrize("name", READERS)
def test_none_without_a_profile(registry, name):
    ctx = _ctx()
    ctx.profile = None
    assert _read(name, ctx) is None


@pytest.mark.parametrize("name", READERS)
def test_none_without_the_registry(monkeypatch, name):
    # a program without `span_records` (the import fails)
    fake = SimpleNamespace()
    monkeypatch.setitem(sys.modules, "guided_vae_nmf_torch.ops.profiling",
                        fake)
    assert _read(name, _ctx()) is None


@pytest.mark.parametrize("name", READERS[:4])
def test_none_without_device_times(monkeypatch, name):
    recs = [dict(r, device_ms=None) for r in _registry()]
    monkeypatch.setattr(profiling, "span_records", lambda: recs)
    assert _read(name, _ctx()) is None
