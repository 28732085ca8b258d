"""What the harness and the reference load, in fresh interpreters: no
module whose top-level name (the part before the first dot, compared
whole) is JAX's or the JAX package's; the reference nothing of the
program. The port's name begins with the JAX package's, so a prefix test
would be wrong."""

import json
import subprocess
import sys

from tiny import REPO, make_root

FORBIDDEN = {"jax", "jaxlib", "flax", "guided_vae_nmf_tpu"}


def _tops(code, cwd):
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys, json\n"
         "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
        cwd=str(cwd), capture_output=True, text=True, timeout=600,
        env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_harness_run_loads_no_jax(tmp_path):
    root = make_root(tmp_path)
    tops = _tops(
        f"import sys\nsys.path.insert(0, {str(root)!r})\n"
        "import torch\ntorch.set_num_threads(2)\n"
        "from gvbench import run\n"
        "assert run.main(['--workload', 'tiny_m2.serve', '--seed', '3', "
        "'--seconds', '1', '--trace', '0'], require_cuda=False, "
        f"root={str(root)!r}) == 0", root)
    assert "guided_vae_nmf_torch" in tops        # it ran the program
    assert not tops & FORBIDDEN


def test_reference_loads_nothing_of_the_program():
    tops = _tops(
        f"import sys\nsys.path.insert(0, {str(REPO)!r})\n"
        "import numpy as np, torch\n"
        "from gvbench.reference import dsp, mcem, nets, philox, spp\n"
        "from gvbench.harness import check\n"
        "from gvbench.harness.layout import Layout\n"
        "lay = Layout()\n"
        "fam = lay.family(lay.config('m2_ibm'))\n"
        "ref = fam.Reference(lay.root, lay.config('m2_ibm'), 'cpu')\n"
        "arr = nets.load_npz('artifacts/pretrained/M2_ibm')\n"
        "p = nets.Params(arr, 'f64', 'cpu')\n"
        "x = torch.randn(2, 1024 + 256 * 7)\n"
        "re, im = dsp.stft(x, 'f64')\n"
        "X2 = re * re + im * im\n"
        "Z = nets.encoder_mu(p, torch.cat([X2, torch.ones_like(X2)], -1))\n"
        "ypre = nets.label_term(p, torch.ones_like(X2), 32)\n"
        "Vs = nets.decode(p, Z, ypre)\n"
        "zn, u = philox.streams(5, 2, 8, 32, 4, 'cpu')\n"
        "out = mcem.chain(p, X2, X2 * 0 + 1, torch.ones(2, 8), ypre, Z, Vs,"
        " zn, u, 'wf', 2, 2, 0.1, 'f64')\n"
        "spp.spp_noise_psd(X2.transpose(1, 2))\n"
        "dsp.istft_masked(re, im, torch.ones(2, 8), 'f64')\n", REPO)
    assert "gvbench" in tops and "torch" in tops
    assert "guided_vae_nmf_torch" not in tops
    assert not tops & FORBIDDEN
