"""The data-driven layout: a later change adds a configuration, a traffic
mix, a per-layer metric and a cell as new files and new entries, touching
no existing file, and the harness finds each by its name."""

import json
import shutil

from tiny import REPO  # noqa: I001  (puts the checkout on sys.path)

from gvbench.harness.layout import Layout

NAME_CHARS = set("abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ"
                 "0123456789_.-")


def test_added_files_are_found(tmp_path):
    shutil.copytree(REPO / "gvbench", tmp_path / "gvbench")
    before = {p: p.read_bytes() for p in (tmp_path / "gvbench").rglob("*")
              if p.is_file()}
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    g = tmp_path / "gvbench"
    cfg = json.loads((g / "configs" / "m2_ibm.json").read_text())
    cfg["name"] = "dummy"
    (g / "configs" / "dummy.json").write_text(json.dumps(cfg))
    mix = json.loads((g / "traffic" / "sweep16.json").read_text())
    mix["pool"] = 8
    (g / "traffic" / "dummy_mix.json").write_text(json.dumps(mix))
    (g / "limits" / "dummy.dummy_mix.json").write_text('{"out": 1}')
    (g / "metrics" / "dummy_metric.py").write_text(
        "def read(ctx):\n    return 42.0 if ctx else None\n")
    (g / "families" / "dummy_family.py").write_text(
        "def warm_cfg(cfg):\n    return cfg\n")
    cfg["family"] = "dummy_family"
    (g / "configs" / "dummy_fam.json").write_text(json.dumps(cfg))
    bench["configs"].append({"name": "dummy", "source": "x",
                             "file": "gvbench/configs/dummy.json",
                             "reduced": [], "why": "test"})
    bench["configs"].append({"name": "dummy_fam", "source": "y",
                             "file": "gvbench/configs/dummy_fam.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "dummy.dummy_mix", "config": "dummy",
                               "traffic": "dummy_mix", "chips": 1,
                               "why": "test"})
    bench["per_layer"].append({"name": "dummy_metric", "unit": "%",
                               "better": "higher", "source": "device_trace",
                               "layer": "device", "moves": "setup_s",
                               "workloads": ["dummy.dummy_mix"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    for p, data in before.items():
        assert p.read_bytes() == data

    lay = Layout(root=tmp_path, bench_dir=g)
    cell = lay.workload("dummy.dummy_mix")
    assert lay.config(cell["config"])["name"] == "dummy"
    assert lay.traffic(cell["traffic"])["pool"] == 8
    assert lay.limits("dummy.dummy_mix") == {"out": 1}
    names = [m["name"] for m in lay.metrics("dummy.dummy_mix", 1)]
    assert names == ["dummy_metric"]
    assert lay.reader("dummy_metric")(object()) == 42.0
    fam = lay.family(lay.config("dummy_fam"))
    assert fam.warm_cfg(7) == 7
    assert lay.family(lay.config("dummy")).__file__ == str(
        g / "families" / "mh_mcem.py")
    e2e = [m["name"] for m in lay.metrics("dummy.dummy_mix", 0)]
    assert e2e == ["setup_s"]
    # the real cells resolve too
    for w in bench["workloads"][:-1]:
        lay.config(w["config"])
        lay.traffic(w["traffic"])
        lay.limits(w["name"])
        assert callable(lay.family(lay.config(w["config"])).readings)
        for m in lay.metrics(w["name"], 1):
            assert callable(lay.reader(m["name"]))


def test_benchmark_file_keeps_to_its_contract():
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["paths"] == ["gvbench"]
    names = [c["name"] for c in bench["configs"]]
    cells = [w["name"] for w in bench["workloads"]]
    metrics = [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    for n in names + cells + metrics:
        assert set(n) <= NAME_CHARS and len(n) <= 64
    assert len(set(names)) == len(names) and len(set(cells)) == len(cells)
    assert len(set(metrics)) == len(metrics)
    e2e = {m["name"] for m in bench["end_to_end"]}
    assert "setup_s" in e2e
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert (REPO / c["file"]).is_file()
        assert c["name"] in {w["config"] for w in bench["workloads"]}
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
        assert (REPO / "gvbench" / "limits" / f"{w['name']}.json").is_file()
        assert (REPO / "gvbench" / "traffic" / f"{w['traffic']}.json"
                ).is_file()
        reported = [m for m in bench["end_to_end"] + bench["per_layer"]
                    if w["name"] in m.get("workloads", [w["name"]])]
        assert len([m for m in reported if m in bench["end_to_end"]]) >= 2
        assert any(m in bench["per_layer"] for m in reported)
    for m in bench["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert m["moves"] in e2e
        assert (REPO / "gvbench" / "metrics" / f"{m['name']}.py").is_file()
