"""Find a cell's pieces by name: `BENCHMARK.json` at the checkout's root,
`configs/<config>.json`, `traffic/<mix>.json`, `limits/<workload>.json`
and `metrics/<metric>.py` under the benchmark's folder. A later change
adds a cell by adding such files and entries; nothing here names one."""

import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]


class Layout:
    def __init__(self, root=None, bench_dir=None):
        self.bench_dir = Path(bench_dir) if bench_dir else HERE
        self.root = Path(root) if root else self.bench_dir.parent
        with open(self.root / "BENCHMARK.json") as f:
            self.bench = json.load(f)

    def workload(self, name):
        for w in self.bench["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name):
        for c in self.bench["configs"]:
            if c["name"] == name:
                return _json(self.root / c["file"])
        raise KeyError(f"no config {name!r} in BENCHMARK.json")

    def traffic(self, name):
        return _json(self.bench_dir / "traffic" / f"{name}.json")

    def limits(self, workload):
        return _json(self.bench_dir / "limits" / f"{workload}.json")

    def metrics(self, workload, trace):
        """The cell's metric entries: its end-to-end ones (trace 0) or its
        per-layer ones (trace 1). An entry without `workloads` belongs to
        every cell."""
        key = "per_layer" if trace else "end_to_end"
        return [m for m in self.bench[key]
                if workload in m.get("workloads", [workload])]

    def reader(self, metric):
        """`read(ctx)` of `metrics/<metric>.py`."""
        path = self.bench_dir / "metrics" / f"{metric}.py"
        spec = importlib.util.spec_from_file_location(
            "gvbench_metric_" + metric.replace(".", "_"), path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read


def _json(path):
    with open(path) as f:
        return json.load(f)
