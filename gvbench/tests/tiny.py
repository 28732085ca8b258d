"""A tiny copy of the benchmark for CPU tests: the real folder copied
under a temporary root, beside links to the program and its checkpoints,
with one tiny cell per traffic loop (a few one-second utterances, two
EM iterations, short chains) added as new files and entries."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

TINY_MCEM = {"niter": 2, "nsamples_E_step": 3, "burnin_E_step": 4,
             "nsamples_WF": 3, "burnin_WF": 5, "var_RW": 0.01,
             "nmf_rank": 10, "eps": 1e-8}
LENGTHS = {"gamma_shape": 4, "mean": 1.2, "min": 1.0, "max": 1.6}


def make_root(tmp, limits=None):
    """A checkout-like root under `tmp` with cells `tiny_m2.sweep`,
    `tiny_m2.serve`, `tiny_m1.sweep` and `tiny_m1.serve`."""
    root = Path(tmp)
    shutil.copytree(REPO / "gvbench", root / "gvbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    for name in ("guided_vae_nmf_torch", "artifacts"):
        os.symlink(REPO / name, root / name)
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    g = root / "gvbench"
    for src, dst in (("m2_ibm", "tiny_m2"), ("m1", "tiny_m1")):
        cfg = json.loads((g / "configs" / f"{src}.json").read_text())
        cfg.update(name=dst, mcem=TINY_MCEM)
        (g / "configs" / f"{dst}.json").write_text(json.dumps(cfg))
        bench["configs"].append(
            {"name": dst, "source": "https://arxiv.org/abs/2102.06454",
             "file": f"gvbench/configs/{dst}.json", "reduced": ["mcem"],
             "why": "a CPU test's cell"})
    (g / "traffic" / "tiny_sweep.json").write_text(json.dumps(
        {"loop": "sweep", "pool": 5, "length_s": LENGTHS,
         "snr_db": [-5, 0, 5], "batch_size": 2, "bucket_frames": 128,
         "noise_model": "nmf", "profile_s": 1}))
    (g / "traffic" / "tiny_serve.json").write_text(json.dumps(
        {"loop": "serve", "rate_per_s": 3.0, "length_s": LENGTHS,
         "snr_db": [-5, 0, 5],
         "serve": {"noise_model": "spp", "max_batch": 4,
                   "max_wait_ms": 20.0, "max_pad_waste": 0.5},
         "drain_s": 120, "profile_s": 1}))
    for cfg in ("tiny_m2", "tiny_m1"):
        for mix in ("sweep", "serve"):
            name = f"{cfg}.{mix}"
            bench["workloads"].append(
                {"name": name, "config": cfg, "traffic": f"tiny_{mix}",
                 "chips": 1, "why": "a CPU test's cell"})
            real = json.loads((g / "limits" / (
                ("m2_ibm" if cfg == "tiny_m2" else "m1")
                + (".sweep16" if mix == "sweep" else ".serve")
                + ".json")).read_text())
            (g / "limits" / f"{name}.json").write_text(
                json.dumps(limits or real))
    for key in ("end_to_end", "per_layer"):
        for m in bench[key]:
            if "workloads" in m:
                kind = "sweep" if any(w.endswith("sweep16")
                                      for w in m["workloads"]) else "serve"
                m["workloads"] += [f"tiny_m2.{kind}", f"tiny_m1.{kind}"]
    (root / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return root


def run_cell(root, workload, seed=7, seconds=1.0, trace=0, patch=""):
    """Run the harness's main() on the CPU in a fresh interpreter, after
    `patch` (Python source that may break the program); returns (exit
    code, the result line as a dict or None, stderr)."""
    code = "\n".join([
        "import sys",
        f"sys.path.insert(0, {str(root)!r})",
        "import torch",
        "torch.set_num_threads(2)",
        patch,
        "from gvbench import run",
        f"sys.exit(run.main(['--workload', {workload!r}, '--seed', "
        f"'{seed}', '--seconds', '{seconds}', '--trace', '{trace}'], "
        f"require_cuda=False, root={str(root)!r}))"])
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run([sys.executable, "-c", code], cwd=str(root),
                       capture_output=True, text=True, env=env,
                       timeout=600)
    line = None
    lines = p.stdout.strip().splitlines()
    if p.returncode == 0 and lines:
        line = json.loads(lines[-1])
    return p.returncode, line, p.stderr
