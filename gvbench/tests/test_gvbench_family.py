"""The model family as a piece found by name: a configuration without a
`family` key is MH-MCEM's, an unknown family is refused with the file it
looked for, and a family added as new files alone (a toy: M1's network
with weights drawn from its configuration's seed, and a check of its own)
runs through `run.py` and `control.py` with no existing file of the
benchmark changed."""

import json
import os
import subprocess
import sys

import pytest
import tiny

from gvbench.harness.layout import Layout

TOY = '''"""A toy family: M1's network with its weights drawn from the
configuration's `weights_seed`, checked at its last stage alone: the PCM16
each real row got back against the reference's rounding of the waveform
the program rounded (the control rounds a float16 copy of it)."""

import dataclasses
from types import SimpleNamespace

import numpy as np
import torch


def setup(root, config, device):
    from guided_vae_nmf_torch.mcem import MCEMConfig
    from guided_vae_nmf_torch.models.nets import vae_init

    m = config["model"]
    gen = torch.Generator().manual_seed(config["weights_seed"])
    model = vae_init(gen, [m["x_dim"], m["z_dim"], m["h_dim"]])
    return SimpleNamespace(dev=torch.device(device),
                           model=model.requires_grad_(False).to(device),
                           cfg=MCEMConfig(**config["mcem"]), build_s=0.0)


def entry_kwargs(env, noise_model):
    return dict(label_mode="none", noise_model=noise_model,
                return_noise=False, device=env.dev)


def warm_cfg(cfg):
    return dataclasses.replace(cfg, niter=1)


def pick_judged(cfg, rng):
    return 0


def install(tap):
    from guided_vae_nmf_torch import pipeline

    real = pipeline._to_pcm16

    def to_pcm16(w):
        rec = tap.armed_record()
        if rec is not None:
            rec["w"] = w.double().cpu().numpy()
        return real(w)

    pipeline._to_pcm16 = to_pcm16
    return [(pipeline, "_to_pcm16", real)]


class Reference:
    def __init__(self, root, config, device):
        self.device = device


def _pcm16(w):
    return np.clip(np.round(w * 32768.0), -32768, 32767)


def readings(rec, ref, rows_s, subject="program"):
    want = _pcm16(rec["w"])
    outs = rows_s
    if subject != "program":
        outs = _pcm16(rec["w"].astype(np.float16).astype(np.float64))
    worst = 0.0
    for j in range(rec["rows"]):
        n = len(rows_s[j])
        got = np.asarray(outs[j][:n], np.float64)
        worst = max(worst, float(np.abs(got - want[j, :n]).max()))
    return {"out": worst}, None


def batch_work(frames, rows, env, noise_model):
    return {"flops": 0.0}
'''


ALTERED = """
from guided_vae_nmf_torch import pipeline
_real = pipeline._to_pcm16
def _off(w):
    out = _real(w).clone()
    out[0, 600:700] = out[0, 600:700] + 9
    return out
pipeline._to_pcm16 = _off
"""


def _add_toy(root):
    """The toy family as new files and entries under a tiny root."""
    g = root / "gvbench"
    (g / "families" / "toy.py").write_text(TOY)
    cfg = {"name": "toy", "family": "toy", "weights_seed": 2**31 + 9,
           "model": {"x_dim": 513, "z_dim": 32, "h_dim": [128, 128]},
           "mcem": tiny.TINY_MCEM}
    (g / "configs" / "toy.json").write_text(json.dumps(cfg))
    (g / "limits" / "toy.sweep.json").write_text('{"out": 0}')
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "toy", "source": "a test's toy",
                             "file": "gvbench/configs/toy.json",
                             "reduced": [], "why": "a CPU test's cell"})
    bench["workloads"].append({"name": "toy.sweep", "config": "toy",
                               "traffic": "tiny_sweep", "chips": 1,
                               "why": "a CPU test's cell"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))


def _control(root, workload, seeds):
    """control.main(..., "--cpu") in a fresh interpreter; its last line."""
    code = "\n".join([
        "import sys",
        f"sys.path.insert(0, {str(root)!r})",
        "import torch",
        "torch.set_num_threads(2)",
        "from gvbench import control",
        f"sys.exit(control.main(['--workload', {workload!r}, '--seeds', "
        f"{seeds!r}, '--control', {seeds!r}, '--cpu'], "
        f"root={str(root)!r}))"])
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run([sys.executable, "-c", code], cwd=str(root),
                       capture_output=True, text=True, env=env, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    return json.loads(p.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("config", ["m2_ibm", "m1"])
def test_config_without_family_is_mh_mcem(config):
    lay = Layout()
    cfg = lay.config(config)
    assert "family" not in cfg
    fam = lay.family(cfg)
    assert fam.__file__ == str(lay.bench_dir / "families" / "mh_mcem.py")
    for name in ("setup", "entry_kwargs", "warm_cfg", "pick_judged",
                 "install", "Reference", "readings", "batch_work"):
        assert callable(getattr(fam, name))


def test_unknown_family_raises_naming_its_file():
    lay = Layout()
    cfg = dict(lay.config("m1"), family="no_such_family")
    want = str(lay.bench_dir / "families" / "no_such_family.py")
    with pytest.raises(FileNotFoundError, match=want):
        lay.family(cfg)


def test_toy_family_runs_as_new_files(tmp_path):
    root = tiny.make_root(tmp_path)
    _add_toy(root)
    rc, line, err = tiny.run_cell(root, "toy.sweep", seed=2**31 + 3)
    assert rc == 0, err[-3000:]
    assert line["correct"] is True, err[-3000:]
    assert line["checks"] == {"out": {"value": 0.0, "limit": 0}}
    out = _control(root, "toy.sweep", "4,5")
    assert out["program_max"]["out"] == 0.0
    assert out["control_min"]["out"] > 0.0
    # no file the benchmark had was changed to take the toy
    for p in (tiny.REPO / "gvbench").rglob("*"):
        if p.is_file() and "__pycache__" not in p.parts:
            q = root / p.relative_to(tiny.REPO)
            assert q.read_bytes() == p.read_bytes(), q


def test_toy_family_fault_makes_correct_false(tmp_path):
    root = tiny.make_root(tmp_path)
    _add_toy(root)
    rc, line, err = tiny.run_cell(root, "toy.sweep", seed=6,
                                  patch=ALTERED)
    assert rc == 0, err[-3000:]
    assert line["correct"] is False
    assert line["checks"]["out"]["value"] >= 9


@pytest.mark.parametrize("cell", ["tiny_m1.sweep", "tiny_m2.sweep"])
def test_tiny_cells_read_correct(tmp_path, cell):
    root = tiny.make_root(tmp_path)
    rc, line, err = tiny.run_cell(root, cell, seed=2**31 + 11)
    assert rc == 0, err[-3000:]
    assert line["correct"] is True, err[-3000:]
    limits = json.loads((root / "gvbench" / "limits" / f"{cell}.json")
                        .read_text())
    assert list(line["checks"]) == list(limits)
