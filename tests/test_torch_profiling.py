"""The port's profiling hooks (`ops/profiling.py`) and `utils.py` against
the JAX package's, on the CPU: `StageTimer`'s report is the same text for
the same stages, `device_time_ms` raises where the trace holds no device
event, `profile_trace` writes a Chrome trace, the device-time union counts
overlapping intervals once, `count_parameters` and `get_key` give JAX's
values, and `device_warmup` does nothing on the CPU. The spans are
`test_torch_tracing.py`'s."""

import glob
import json
import os

import pytest
import torch

from guided_vae_nmf_torch import ops, utils
from guided_vae_nmf_torch.ops import profiling
from guided_vae_nmf_torch.train import load_model
from guided_vae_nmf_tpu import utils as j_utils
from guided_vae_nmf_tpu.ops import profiling as j_profiling
from guided_vae_nmf_tpu.train.checkpoints import load_model as j_load_model

torch.set_num_threads(2)

ART = "artifacts/pretrained"


def test_stage_timer_report_matches_jax():
    timers = [ops.StageTimer(), j_profiling.StageTimer()]
    for t in timers:
        with t.stage("dispatch"):
            pass
        with t.stage("dispatch"):
            pass
        with t.stage("d2h_fetch"):
            pass
        assert dict(t.counts) == {"dispatch": 2, "d2h_fetch": 1}
        # the same totals, so the reports compare line by line
        t.totals.update({"dispatch": 1.25, "d2h_fetch": 12.5,
                         "writer_drain": 0.0005})
        t.counts["writer_drain"] = 3
    got, want = (t.report() for t in timers)
    assert got == want
    assert got.splitlines()[1].startswith("d2h_fetch")


def test_device_time_ms_raises_without_device_events():
    calls = []
    with pytest.raises(RuntimeError, match="no device event"):
        ops.device_time_ms(lambda: calls.append(torch.ones(64).sum()))
    assert len(calls) == 2          # a warm call, then the profiled one


def test_profile_trace_writes_a_chrome_trace(tmp_path):
    with ops.profile_trace(str(tmp_path)):
        (torch.ones(256) * 3).sum()
    files = glob.glob(os.path.join(tmp_path, "*.pt.trace.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "aten::mul" in names


@pytest.mark.parametrize("intervals,want", [
    ([], 0.0), ([(0, 2)], 2.0), ([(0, 2), (1, 3)], 3.0),
    ([(5, 6), (0, 2), (1, 1.5)], 3.0), ([(0, 4), (1, 2), (3, 5)], 5.0)])
def test_union_counts_overlaps_once(intervals, want):
    assert profiling._union_us(intervals) == want


def test_utils_match_jax():
    m2 = load_model(f"{ART}/M2_ibm", kind="dgm", device="cpu")
    assert utils.count_parameters(m2) == j_utils.count_parameters(
        j_load_model(f"{ART}/M2_ibm", kind="dgm"))
    d = {"a": 1, "b": 2}
    for v in (2, 3):
        assert utils.get_key(v, d) == j_utils.get_key(v, d)


def test_device_warmup_does_nothing_on_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "init", lambda: pytest.fail("init"))
    assert utils.device_warmup("cpu") is None
    assert utils.device_warmup(torch.device("cpu")) is None
