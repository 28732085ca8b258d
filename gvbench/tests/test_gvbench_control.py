"""The control at a size a test run holds: the reference in TF32 put in
the program's place fails the cell's limits, where the program passes
them. A tiny cell on the CPU (one-second utterances, two EM iterations)
records the program's state through the tap; each stage is then read
twice, for the program and for the control."""

import json

import pytest
import tiny  # noqa: F401  (puts the checkout on sys.path)
import torch

from gvbench.harness import check, serve, sweep
from gvbench.harness.layout import Layout


@pytest.mark.parametrize("cell", ["tiny_m2.sweep", "tiny_m1.sweep",
                                  "tiny_m2.serve"])
def test_control_fails_and_program_passes(tmp_path, cell):
    torch.set_num_threads(2)
    root = tiny.make_root(tmp_path)
    lay = Layout(root=root, bench_dir=root / "gvbench")
    w = lay.workload(cell)
    config = lay.config(w["config"])
    mix = lay.traffic(w["traffic"])
    limits = lay.limits(cell)
    family = lay.family(config)
    env = family.setup(lay.root, config, "cpu")
    ref = family.Reference(lay.root, config, env.dev)
    loop = sweep if mix["loop"] == "sweep" else serve
    kw = {"only_armed": True} if loop is sweep else {}
    res = loop.run(family, env, mix, 1.0, False, 5, **kw)
    rec = res["tap"].record
    nums, err = family.readings(rec, ref, res["rows_s"])
    ok, rows = check.verdict(nums, limits, err)
    assert ok, json.dumps(rows)
    cnums, cerr = family.readings(rec, ref, res["rows_s"], subject="tf32")
    cok, crows = check.verdict(cnums, limits, cerr)
    assert not cok, json.dumps(crows)
