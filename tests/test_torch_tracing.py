"""The port's spans (`ops.profiling.span` and its registry) on the CPU:
off, a span is one check and records nothing; under `torch.profiler` the
batch path's spans nest as the pipeline runs them, carry their counts and
land in the Chrome trace as `user_annotation` events; outputs do not
change with spans on; threads keep their own parents and batches;
`StageTimer`'s stages are spans; self time is a span's time less its
children's."""

import json
import sys
import threading
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from guided_vae_nmf_torch import ops, pipeline
from guided_vae_nmf_torch.mcem import MCEMConfig
from guided_vae_nmf_torch.ops import profiling
from guided_vae_nmf_torch.train.checkpoints import (load_model,
                                                    load_norm_stats)

torch.set_num_threads(2)

ART = "artifacts/pretrained"
NITER = 3
CFG = MCEMConfig(niter=NITER, nsamples_E_step=2, burnin_E_step=2,
                 nsamples_WF=2, burnin_WF=3)
ENGINE_KIDS = (["gvnmf.engine.init"]
               + ["gvnmf.em.e_chain", "gvnmf.em.m_step", "gvnmf.em.cost"]
               * NITER + ["gvnmf.wf_chain"])


@pytest.fixture(autouse=True)
def empty_registry(monkeypatch):
    # emptied before a test's patches of the event pools are undone
    profiling.reset_spans()
    yield
    profiling.reset_spans()


@pytest.fixture(scope="module")
def m2():
    model = load_model(f"{ART}/M2_ibm", kind="dgm", device="cpu")
    cls = load_model(f"{ART}/classifier_ibm", kind="classifier",
                     device="cpu")
    mean, std = load_norm_stats(f"{ART}/classifier_ibm")
    return model, cls, mean, std


def _batch(frames=(12, 7), n_pad=16, seed=0):
    """Two int16 rows padded to `n_pad` frames and their frame mask."""
    rng = np.random.default_rng(seed)
    L = (n_pad - 1) * 256 + 1024
    x = np.zeros((len(frames), L), np.int16)
    mask = np.zeros((len(frames), n_pad), np.float32)
    for j, nf in enumerate(frames):
        n = (nf - 1) * 256 + 1024
        x[j, :n] = rng.integers(-3000, 3000, n)
        mask[j, :nf] = 1.0
    return x, mask


def _enhance(m2, x, mask):
    model, cls, mean, std = m2
    return pipeline.enhance_waveform(
        model, x, mask, CFG, classifier=cls, mean=mean, std=std,
        label_mode="dnn", generator=torch.Generator().manual_seed(5),
        return_noise=False, device="cpu")


def _profiled(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, prof


def test_span_off_records_nothing_and_skips_record_function(monkeypatch):
    def boom(name):
        raise AssertionError(f"record_function entered for {name}")

    monkeypatch.setattr(torch.profiler, "record_function", boom)
    assert not profiling.profiler_on()
    cm = ops.span("gvnmf.front", rows=lambda: pytest.fail("counted"))
    assert cm is ops.span("gvnmf.back")       # one shared no-op
    with cm:
        with ops.span("gvnmf.batch", "cpu", rows=2):
            pass
    assert ops.span_records() == []


def test_span_on_enters_record_function(monkeypatch):
    names = []
    real = torch.profiler.record_function

    def spy(name):
        names.append(name)
        return real(name)

    monkeypatch.setattr(torch.profiler, "record_function", spy)
    _profiled(lambda: ops.span("gvnmf.front").__enter__().__exit__(
        None, None, None))
    assert names == ["gvnmf.front"]
    assert [r["name"] for r in ops.span_records()] == ["gvnmf.front"]


def test_batch_path_spans_nest(m2, tmp_path):
    x, mask = _batch()
    _, prof = _profiled(lambda: _enhance(m2, x, mask))
    recs = ops.span_records()
    by_id = {r["id"]: r for r in recs}

    def parent(r):
        return by_id[r["parent"]]["name"] if r["parent"] is not None else None

    batch = [r for r in recs if r["name"] == "gvnmf.batch"]
    assert len(batch) == 1 and batch[0]["parent"] is None
    assert {r["batch"] for r in recs} == {batch[0]["batch"]}
    top = [r["name"] for r in recs if parent(r) == "gvnmf.batch"]
    assert top == ["gvnmf.front", "gvnmf.labels", "gvnmf.engine",
                   "gvnmf.back"]
    engine = next(r for r in recs if r["name"] == "gvnmf.engine")
    assert engine["counts"] == {"niter": NITER}
    assert [r["name"] for r in recs if parent(r) == "gvnmf.engine"] == (
        ENGINE_KIDS)
    assert all(r["device_ms"] is None for r in recs)     # no card here
    assert all(r["t0"] <= r["t1"] for r in recs)

    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    seen = [e["name"] for e in events if e.get("cat") == "user_annotation"
            and e.get("name", "").startswith("gvnmf.")]
    assert sorted(seen) == sorted(r["name"] for r in recs)


def test_outputs_bit_identical_with_spans_on(m2):
    x, mask = _batch()
    off = _enhance(m2, x, mask)
    on, _ = _profiled(lambda: _enhance(m2, x, mask))
    assert len(ops.span_records()) == 4 + len(ENGINE_KIDS) + 1
    for a, b in zip(off, on):
        if a is None:
            assert b is None
        else:
            assert torch.equal(a, b)


@pytest.mark.parametrize("kind", ["numpy", "tensor"])
def test_batch_counts_from_the_mask(m2, kind):
    x, mask = _batch(frames=(16, 9), n_pad=16)
    m = torch.from_numpy(mask) if kind == "tensor" else mask
    _profiled(lambda: _enhance(m2, x, m))
    batch, = [r for r in ops.span_records() if r["name"] == "gvnmf.batch"]
    assert batch["counts"] == {"rows": 2, "n_pad": 16, "valid_frames": 25}
    assert all(type(v) is int for v in batch["counts"].values())


@pytest.mark.parametrize("skips", [False, True])
@pytest.mark.parametrize("frames,n_pad,live", [((16, 9), 16, 2),
                                                ((70, 20), 80, 4),
                                                ((64, 64), 64, 4)])
def test_wf_chain_counts_live_pairs(m2, monkeypatch, frames, n_pad, live,
                                    skips):
    """`gvnmf.wf_chain` counts the chains' 32-frame tile pairs
    (`k1_pairs`, rows x ceil(n_pad / 32)) and those the chains ran
    (`k1_live_pairs`): where the form skips dead pairs (the cluster form
    on the card, here by the plan's skip flag patched) those that hold a
    valid frame, a device count resolved when read; elsewhere (the CPU's
    plain version, K1e, K1g) every pair."""
    from guided_vae_nmf_torch.mcem import fused_engine

    real = fused_engine.plan_chain
    monkeypatch.setattr(fused_engine, "plan_chain",
                        lambda *a, **k: dict(real(*a, **k), skips=skips))
    x, mask = _batch(frames=frames, n_pad=n_pad)
    _profiled(lambda: _enhance(m2, x, mask))
    wf, = [r for r in ops.span_records() if r["name"] == "gvnmf.wf_chain"]
    pairs = 2 * -(-n_pad // 32)
    assert wf["counts"] == {"k1_pairs": pairs,
                            "k1_live_pairs": live if skips else pairs}
    assert all(type(v) is int for v in wf["counts"].values())


def test_tensor_counts_resolve_when_read():
    count = torch.tensor(7)
    _profiled(lambda: ops.span("gvnmf.batch", frames=count).__enter__()
              .__exit__(None, None, None))
    rec, = ops.span_records()
    assert rec["counts"] == {"frames": 7}
    assert type(rec["counts"]["frames"]) is int


def test_threads_keep_their_own_spans():
    both_open = threading.Barrier(2)
    ident = {}

    def work(tag):
        ident[tag] = threading.get_ident()
        with ops.span("gvnmf.batch", rows=tag):
            both_open.wait()           # the two batches are open at once
            for _ in range(tag):
                with ops.span("gvnmf.em.e_chain"):
                    pass

    def run():
        threads = [threading.Thread(target=work, args=(t,)) for t in (2, 3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()

    _profiled(run)
    recs = ops.span_records()
    batches = {r["counts"]["rows"]: r for r in recs
               if r["name"] == "gvnmf.batch"}
    assert sorted(batches) == [2, 3] and len(recs) == 2 + 2 + 3
    assert batches[2]["batch"] != batches[3]["batch"]
    for tag, b in batches.items():
        kids = [r for r in recs if r["parent"] == b["id"]]
        assert len(kids) == tag
        assert b["thread"] == ident[tag]
        assert {r["thread"] for r in kids} == {ident[tag]}
        assert {r["batch"] for r in kids} == {b["batch"]}


def test_many_threads_lose_no_record():
    n_threads, per = 12, 150
    old = sys.getswitchinterval()

    def work():
        with ops.span("gvnmf.batch"):
            for _ in range(per):
                with ops.span("gvnmf.em.m_step"):
                    pass

    def run():
        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)

    sys.setswitchinterval(1e-6)
    try:
        _profiled(run)
    finally:
        sys.setswitchinterval(old)
    recs = ops.span_records()
    assert len(recs) == n_threads * (per + 1)
    assert len({r["id"] for r in recs}) == len(recs)
    batches = [r for r in recs if r["name"] == "gvnmf.batch"]
    assert len({r["batch"] for r in batches}) == n_threads
    for b in batches:
        kids = [r for r in recs if r["parent"] == b["id"]]
        assert len(kids) == per
        assert {(r["batch"], r["thread"]) for r in kids} == {
            (b["batch"], b["thread"])}


def test_span_survives_the_profiler_stopping():
    prof = profile(activities=[ProfilerActivity.CPU])
    prof.start()
    with ops.span("gvnmf.batch", rows=1):
        with ops.span("gvnmf.front"):
            prof.stop()
        with ops.span("gvnmf.back"):           # opened with it off
            pass
    names = [r["name"] for r in ops.span_records()]
    assert names == ["gvnmf.batch", "gvnmf.front"]
    assert not profiling.profiler_on()


def test_stage_timer_stages_are_spans():
    t = ops.StageTimer()

    def run():
        with t.stage("dispatch"):
            with ops.span("gvnmf.front"):
                pass
        with t.stage("d2h_fetch"):
            pass

    _profiled(run)
    recs = ops.span_records()
    assert [r["name"] for r in recs] == ["dispatch", "gvnmf.front",
                                         "d2h_fetch"]
    assert recs[1]["parent"] == recs[0]["id"]
    assert dict(t.counts) == {"dispatch": 1, "d2h_fetch": 1}
    t.totals.update({"dispatch": 1.25, "d2h_fetch": 12.5})
    assert t.report().splitlines() == [
        "STAGE                      TOTAL(s)    CALLS",
        "d2h_fetch                    12.500        1",
        "dispatch                      1.250        1"]


def test_self_time_is_less_the_children(monkeypatch):
    clock = iter([0.0, 1.0, 1.5, 4.0, 4.25, 10.0])
    monkeypatch.setattr(profiling, "time",
                        SimpleNamespace(perf_counter=lambda: next(clock)))

    def run():
        with ops.span("gvnmf.engine"):          # 0 .. 10
            with ops.span("gvnmf.em.e_chain"):  # 1 .. 1.5
                pass
            with ops.span("gvnmf.em.m_step"):   # 4 .. 4.25
                pass

    _profiled(run)
    eng, chain, step = ops.span_records()
    assert eng["host_ms"] == 10000.0
    assert eng["self_ms"] == 10000.0 - 500.0 - 250.0
    assert (chain["self_ms"], step["self_ms"]) == (500.0, 250.0)


class _FakeEvent:
    """A CUDA timing event on a fake clock: each record is 1 ms later, and
    the card has finished everything recorded."""
    made = 0
    clock = 0.0

    def __init__(self, enable_timing=False):
        type(self).made += 1

    def record(self, stream=None):
        type(self).clock += 1.0
        self.t = type(self).clock

    def query(self):
        return True

    def synchronize(self):
        pass

    def elapsed_time(self, end):
        return end.t - self.t


def test_device_spans_time_and_reuse_events(monkeypatch):
    monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev: None)
    monkeypatch.setattr(_FakeEvent, "made", 0)
    monkeypatch.setattr(profiling, "_events", {})    # pools of this test
    monkeypatch.setattr(profiling, "_free", {})

    def run():
        with ops.span("gvnmf.engine", "cuda:0"):   # events at 1 .. 6
            with ops.span("gvnmf.em.e_chain"):     # 2 .. 3
                pass
            with ops.span("gvnmf.em.m_step"):      # 4 .. 5
                pass

    _profiled(run)
    eng, chain, step = ops.span_records()
    assert (eng["device_ms"], chain["device_ms"], step["device_ms"]) == (
        5.0, 1.0, 1.0)
    assert eng["self_ms"] == 3.0 and chain["self_ms"] == 1.0
    # a finished span's events are read and reused as soon as the pool
    # runs dry: three events serve the whole nest
    assert _FakeEvent.made == 3
    for _ in range(3):
        _profiled(run)
    assert _FakeEvent.made == 3 and len(ops.span_records()) == 12
    ops.reset_spans()
    _profiled(run)
    assert [r["device_ms"] for r in ops.span_records()] == [5.0, 1.0, 1.0]
    assert _FakeEvent.made == 3


def test_pending_events_are_not_reused(monkeypatch):
    class Pending(_FakeEvent):
        done = False              # whether the card got there

        def query(self):
            return type(self).done

    monkeypatch.setattr(torch.cuda, "Event", Pending)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev: None)
    monkeypatch.setattr(Pending, "made", 0)
    monkeypatch.setattr(profiling, "_events", {})
    monkeypatch.setattr(profiling, "_free", {})
    monkeypatch.setattr(profiling, "READ_AT_ONCE", 3)

    def run(n=4):
        for _ in range(n):
            with ops.span("gvnmf.em.cost", "cuda:0"):
                pass

    _profiled(run)
    assert Pending.made == 8 and len(profiling._unread) == 4
    # once the card is done, a dry pool reads READ_AT_ONCE records a time
    Pending.done = True
    _profiled(lambda: run(1))
    assert Pending.made == 8 and len(profiling._unread) == 1 + 1
    assert [r["device_ms"] for r in ops.span_records()] == [1.0] * 5
    Pending.done = False
    _profiled(run)                 # span_records read them all: reused
    assert Pending.made == 8
    ops.reset_spans()              # gives the unread ones back
    assert sorted(profiling._free[0]) == list(range(8))


def test_reset_empties_the_registry():
    _profiled(lambda: ops.span("gvnmf.front").__enter__().__exit__(
        None, None, None))
    assert len(ops.span_records()) == 1
    ops.reset_spans()
    assert ops.span_records() == []


def test_stage_and_shared_timer_are_gone():
    assert not hasattr(ops, "stage")
    assert not hasattr(profiling, "_GLOBAL")
