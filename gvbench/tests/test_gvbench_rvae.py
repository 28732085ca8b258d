"""The `rvae` family: found by name from its configuration, a tiny copy of
the cell `rvae_ld.seg64` (a small RVAE, short chains, a few one-second
segments) through `run.py` and `control.py --cpu`, and its work counts by
hand at a small shape."""

import json
import os
import subprocess
import sys

import tiny

from gvbench.harness import bounds
from gvbench.harness.layout import Layout

TINY_RVAE = {"niter": 2, "nsamples_E_step": 3, "burnin_E_step": 4,
             "nsamples_WF": 3, "burnin_WF": 5, "nmf_rank": 10, "eps": 1e-8,
             "ld_step": 0.005}


def _add_tiny_rvae(root):
    """The cell `tiny_rvae.seg`: rvae_ld's configuration with a small
    network and short chains, segments of one second, its limits the real
    cell's."""
    g = root / "gvbench"
    cfg = json.loads((g / "configs" / "rvae_ld.json").read_text())
    cfg["model"].update(z_dim=4, rnn=8, dense_g=[8])
    cfg.update(name="tiny_rvae", mcem=TINY_RVAE)
    (g / "configs" / "tiny_rvae.json").write_text(json.dumps(cfg))
    mix = json.loads((g / "traffic" / "seg64.json").read_text())
    mix.update(pool=3, batch_size=2, profile_s=1,
               length_s={"gamma_shape": 4, "mean": 1.0, "min": 1.0,
                         "max": 1.0})
    (g / "traffic" / "tiny_seg.json").write_text(json.dumps(mix))
    (g / "limits" / "tiny_rvae.seg.json").write_text(
        (g / "limits" / "rvae_ld.seg64.json").read_text())
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny_rvae", "source": "a test's cell",
                             "file": "gvbench/configs/tiny_rvae.json",
                             "reduced": ["rnn"], "why": "a CPU test's cell"})
    bench["workloads"].append({"name": "tiny_rvae.seg", "config": "tiny_rvae",
                               "traffic": "tiny_seg", "chips": 1,
                               "why": "a CPU test's cell"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "rvae_ld.seg64" in m.get("workloads", []):
            m["workloads"].append("tiny_rvae.seg")
    (root / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))


def test_family_is_found_by_name():
    lay = Layout()
    cfg = lay.config("rvae_ld")
    fam = lay.family(cfg)
    assert fam.__file__ == str(lay.bench_dir / "families" / "rvae.py")
    for name in ("setup", "entry_kwargs", "warm_cfg", "pick_judged",
                 "install", "Reference", "readings", "batch_work"):
        assert callable(getattr(fam, name))
    assert set(lay.limits("rvae_ld.seg64")) == {
        "init", "front", "e_gap", "w_sums", "mstep", "wf_gap", "out"}
    names = [m["name"] for m in lay.metrics("rvae_ld.seg64", 1)]
    assert names == ["mfu.sweep", "rvae_chain_roofline.sweep",
                     "lstm_sweep_roofline.sweep", "rvae_timestep_us.sweep"]


def test_tiny_cell_runs_and_reads_correct(tmp_path):
    root = tiny.make_root(tmp_path)
    _add_tiny_rvae(root)
    rc, line, err = tiny.run_cell(root, "tiny_rvae.seg", seed=2**31 + 23)
    assert rc == 0, err[-3000:]
    assert line["correct"] is True, err[-3000:]
    assert list(line["checks"]) == ["init", "front", "e_gap", "w_sums",
                                    "mstep", "wf_gap", "out"]
    assert line["metrics"]["x_realtime"]["value"] > 0


def test_tiny_cell_control_fails_a_limit(tmp_path):
    root = tiny.make_root(tmp_path)
    _add_tiny_rvae(root)
    code = "\n".join([
        "import sys", f"sys.path.insert(0, {str(root)!r})", "import torch",
        "torch.set_num_threads(2)", "from gvbench import control",
        "sys.exit(control.main(['--workload', 'tiny_rvae.seg', '--seeds', "
        f"'5', '--control', '5', '--cpu'], root={str(root)!r}))"])
    p = subprocess.run([sys.executable, "-c", code], cwd=str(root),
                       capture_output=True, text=True, timeout=600,
                       env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert p.returncode == 0, p.stderr[-3000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    limits = json.loads((root / "gvbench" / "limits" /
                         "tiny_rvae.seg.json").read_text())
    assert all(out["program_max"][k] <= v for k, v in limits.items())
    assert any(out["control_min"][k] > v for k, v in limits.items())


def test_work_by_hand():
    fam = Layout().family({"family": "rvae"})
    # V=3 valid frames of U=1 row, F=4, L=2, H=2 units, 5 steps
    V, F, L, Hn, steps = 3, 4, 2, 2, 5
    fwd = 2 * (2 * 8 * (2 + 2) + 20)          # 168 a frame
    bwd = 2 * (2 * 8 * (2 + 2) + 30)          # 188
    w = 2 * 8 * (2 + 2 + 1) * 4               # 320 weight bytes
    fwd_b = 3 * 4 * (2 + 4 + 20) + w
    bwd_b = 3 * 4 * (4 + 20 + 8) + w
    assert fam.lstm_sweep_work(V, F, L, Hn, steps) == (
        V * steps * (fwd + bwd), steps * (fwd_b + bwd_b))
    f, b = fam.chain_work(V, F, L, Hn, steps)
    assert f == V * steps * (fwd + bwd) + V * steps * (2 * 2 * 4 * 4
                                                       + 8 * 4 + 6 * 2)
    assert b == steps * (fwd_b + bwd_b) + V * steps * 4 * (
        2 * (4 + 4) + 5 * 4 + 7 * 2)
    # K2: two 'h' passes and one 'g' pass an EM iteration at a given Vb,
    # over V=3 frames of F=4 bins and R=2 dumps: 6 R operations a bin (2
    # more in 'g' mode); the dumps, Vb and g in (and X2 in 'g' mode), two
    # sums a bin ('h') or a frame ('g') out
    small = {"model": {"x_dim": 4, "z_dim": 2, "rnn": 2, "dense_g": [2]},
             "mcem": {"nsamples_E_step": 2, "burnin_E_step": 1, "niter": 3,
                      "nmf_rank": 3, "nsamples_WF": 1, "burnin_WF": 1}}
    h = (3 * 4 * 12, 4 * 2 * 12 + 4 * (12 + 3) + 8 * 12)
    g = (3 * 4 * 14, 4 * 2 * 12 + 4 * (12 + 3 + 12) + 8 * 3)
    assert fam.work_counts(3, 1, small)["k2"] == (
        3 * (2 * h[0] + g[0]), 3 * (2 * h[1] + g[1]))
    # the whole batch: at most the card's peak for a 1-second window at
    # the published widths means the counts are not wildly off
    cfg = Layout().config("rvae_ld")
    work = fam.work_counts(256 * 64, 64, cfg)
    assert work["lstm_sweep"][0] < work["chain"][0] < work["flops"]
    assert work["flops"] / bounds.PEAK_F32_FLOPS < 20.0


def test_readers_by_hand(monkeypatch):
    """The three new readers on a hand-built context: one profiled batch
    whose chain spans took 30 + 10 device ms over 1000 + 500 timesteps, and
    whose sweep kernels took 20 ms."""
    from gvbench.harness import spans

    lay = Layout()

    class Prof:
        def seconds(self, patterns):
            return 0.020 if "lstm_sweep_fwd_kernel" in patterns else 0.0

    class Ctx:
        profile = Prof()
        n_batches = 1
        kernel_s = staticmethod(lambda p: Prof().seconds(p))
        bound_s = staticmethod(lambda key: {"chain": 0.004,
                                            "lstm_sweep": 0.002}[key])

    recs = [{"name": spans.BATCH, "device_ms": 50.0, "counts": {}},
            {"name": "gvnmf.rvae.e_chain", "device_ms": 30.0,
             "counts": {"timesteps": 1000}},
            {"name": "gvnmf.rvae.wf_chain", "device_ms": 10.0,
             "counts": {"timesteps": 500}}]
    monkeypatch.setattr(spans, "records", lambda ctx: recs)
    ctx = Ctx()
    assert lay.reader("rvae_chain_roofline.sweep")(ctx) == 100.0 * 0.004 / 0.04
    assert lay.reader("lstm_sweep_roofline.sweep")(ctx) == 100.0 * 0.002 / 0.02
    assert lay.reader("rvae_timestep_us.sweep")(ctx) == 1e3 * 40.0 / 1500
    # a program without the spans or kernels reads nothing
    monkeypatch.setattr(spans, "records", lambda ctx: recs[:1])
    assert lay.reader("rvae_chain_roofline.sweep")(ctx) is None
    assert lay.reader("rvae_timestep_us.sweep")(ctx) is None
    Ctx.kernel_s = staticmethod(lambda p: 0.0)
    assert lay.reader("lstm_sweep_roofline.sweep")(ctx) is None
