"""Find a cell's pieces by name: `BENCHMARK.json` at the checkout's root,
`configs/<config>.json`, the configuration's model family
`families/<family>.py`, `traffic/<mix>.json`, `limits/<workload>.json`
and `metrics/<metric>.py` under the benchmark's folder. A later change
adds a cell, or a model of another family, by adding such files and
entries; nothing here names one."""

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
        return _module(self.bench_dir / "metrics" / f"{metric}.py",
                       "gvbench_metric_" + metric.replace(".", "_")).read

    def family(self, config):
        """The module `families/<name>.py` of the configuration's `family`
        (`mh_mcem` where it names none), loaded for this cell alone. It
        provides:

        - `setup(root, config, device)`: an object with `dev`, `model`,
          `cfg` (what `pipeline.enhance_waveform` takes besides the batch)
          and `build_s`; the serve loop also reads `classifier`, `mean`,
          `std` and `label_mode`;
        - `entry_kwargs(env, noise_model)`: enhance_waveform's other
          arguments;
        - `warm_cfg(cfg)`: the settings a shape is warmed up with;
        - `pick_judged(cfg, rng)`: the tap's `i_sel`, drawn from `rng`;
        - `install(tap)`: the hooks that fill the armed call's record
          (`tap.armed_record()`), returning the (object, name, original)
          triples the tap restores;
        - `Reference(root, config, device)` and `readings(rec, ref, rows_s,
          subject="program")`: (numbers keyed as `limits/<cell>.json`
          keys them, error or None), for the program or, with
          `subject="tf32"`, for the control;
        - `batch_work(frames, rows, env, noise_model)`: a batch's work,
          {"flops": the whole step's operations, and for each kernel a
          reader bounds (today "k1", "k2"): (flops, bytes)}.
        """
        name = config.get("family", "mh_mcem")
        path = self.bench_dir / "families" / f"{name}.py"
        if not path.is_file():
            raise FileNotFoundError(
                f"no family {name!r}: {path} does not exist")
        return _module(path, "gvbench_family_" + name)


def _module(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _json(path):
    with open(path) as f:
        return json.load(f)
